"""Camera model and primary-ray generation — port of ``tpurt.core.camera``.

Conventions (fixed for golden-image stability): right-handed, y-up world;
pixel (0, 0) is the top-left of the image; rays pass through pixel centers
plus an optional sub-pixel jitter; images are (H, W, 3) linear RGB f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch.core.vecmath import cross, normalize


class Camera(NamedTuple):
    """Pinhole camera; fields are f32 tensors (host by default)."""

    position: torch.Tensor  # (3,) f32
    look_at: torch.Tensor  # (3,) f32
    up: torch.Tensor  # (3,) f32
    vfov_deg: torch.Tensor  # () f32

    @staticmethod
    def make(position, look_at, up=(0.0, 1.0, 0.0), vfov_deg=45.0) -> "Camera":
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
        return Camera(f32(position), f32(look_at), f32(up), f32(vfov_deg))

    def to(self, device) -> "Camera":
        return Camera(*(f.to(device) for f in self))


def camera_basis(cam: Camera):
    """Orthonormal camera frame: right, up, forward."""
    forward = normalize(cam.look_at - cam.position)
    right = normalize(cross(forward, cam.up))
    up = cross(right, forward)
    return right, up, forward


def camera_rays(cam: Camera, px, py, width: int, height: int, jitter=None):
    """Primary rays through pixels (px, py) — the raygen math.

    ``jitter``: optional pair shaped like px with values in [0, 1) (0.5 =
    pixel center). Returns (org, dir) with dir unit length; the camera is
    moved to px's device."""
    px = torch.as_tensor(px).to(torch.float32)
    py = torch.as_tensor(py).to(torch.float32)
    cam = cam.to(px.device)
    if jitter is None:
        jx = jy = 0.5
    else:
        jx, jy = jitter
    right, up, forward = camera_basis(cam)
    tan_half = torch.tan(cam.vfov_deg * (math.pi / 180.0) * 0.5)
    aspect = width / height
    ndc_x = ((px + jx) / width * 2.0 - 1.0) * tan_half * aspect
    ndc_y = (1.0 - (py + jy) / height * 2.0) * tan_half
    d = forward + ndc_x[..., None] * right + ndc_y[..., None] * up
    d = normalize(d)
    org = cam.position.expand(d.shape)
    return org, d


def full_frame_pixels_tiled(width: int, height: int, tile: int = 32):
    """(H*W,) int32 pixel column/row indices in ``tile``×``tile``
    screen-tile order: consecutive runs of tile² pixels form square screen
    tiles, so 1024-ray tiles are tight view frusta with no runtime sort."""
    py, px = np.meshgrid(
        np.arange(height, dtype=np.int64),
        np.arange(width, dtype=np.int64),
        indexing="ij",
    )
    px = px.reshape(-1)
    py = py.reshape(-1)
    key = (
        ((py // tile) * (width // tile + 1) + (px // tile)) * (tile * tile)
        + (py % tile) * tile
        + (px % tile)
    )
    order = np.argsort(key, kind="stable")
    return (torch.as_tensor(px[order].astype(np.int32)),
            torch.as_tensor(py[order].astype(np.int32)))



def orbit_camera(center, radius, theta, phi, vfov_deg=45.0,
                 up=(0, 1, 0)) -> Camera:
    """Orbit camera of the flythrough paths: ``theta`` azimuth and
    ``phi`` elevation in radians, in float32."""
    center = torch.as_tensor(np.asarray(center, np.float32))
    th = torch.tensor(theta, dtype=torch.float32)
    ph = torch.tensor(phi, dtype=torch.float32)
    offset = radius * torch.stack([torch.cos(ph) * torch.sin(th),
                                   torch.sin(ph),
                                   torch.cos(ph) * torch.cos(th)])
    return Camera.make(center + offset, center, up, vfov_deg)


def flythrough_path(waypoints, look_ats, n_frames: int, vfov_deg=45.0):
    """Piecewise-linear camera path through ``waypoints`` looking at the
    matching ``look_ats``, one Camera a frame (float32)."""
    waypoints = torch.as_tensor(np.asarray(waypoints, np.float32))
    look_ats = torch.as_tensor(np.asarray(look_ats, np.float32))
    n_seg = waypoints.shape[0] - 1
    cams = []
    for f in range(n_frames):
        s = f / max(n_frames - 1, 1) * n_seg
        i = min(int(s), n_seg - 1)
        a = s - i
        pos = (1 - a) * waypoints[i] + a * waypoints[i + 1]
        tgt = (1 - a) * look_ats[i] + a * look_ats[i + 1]
        cams.append(Camera.make(pos, tgt, vfov_deg=vfov_deg))
    return cams
