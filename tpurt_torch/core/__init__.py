"""Core math: vectors, intersections, camera, sampling."""

from tpurt_torch.core.vecmath import (
    normalize,
    reflect,
    refract,
    build_onb,
    intersect_tris,
)
from tpurt_torch.core.camera import Camera, camera_rays
from tpurt_torch.core import sampling

__all__ = [
    "normalize",
    "reflect",
    "refract",
    "build_onb",
    "intersect_tris",
    "Camera",
    "camera_rays",
    "sampling",
]
