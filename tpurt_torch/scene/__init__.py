"""Scene/state API: `Scene`, `Material`, `Mesh`, `Instance`, plus
`load_scene()` and `to_device()`."""

from tpurt_torch.scene.types import (
    Mesh,
    Material,
    Instance,
    Scene,
    LAMBERT,
    BLINN_PHONG,
    MIRROR,
    DIELECTRIC,
)
from tpurt_torch.scene.device import DeviceScene, to_device
from tpurt_torch.scene.loader import load_scene

__all__ = [
    "Mesh",
    "Material",
    "Instance",
    "Scene",
    "DeviceScene",
    "to_device",
    "load_scene",
    "LAMBERT",
    "BLINN_PHONG",
    "MIRROR",
    "DIELECTRIC",
]
