"""Monte-Carlo sampling warps — port of ``tpurt.core.sampling``.

The reference's ``batch_key``/``uniform2`` wrap ``jax.random``'s
threefry and have no caller (ROADMAP §1); the renderer draws all
randomness from ``core.prng``.
"""

from __future__ import annotations

import math

import torch


def cosine_hemisphere(u: torch.Tensor):
    """Cosine-weighted hemisphere sample about +z from uniforms (..., 2).
    Returns (dir_local, pdf) with pdf = cos_theta / pi."""
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u[..., 0], 0.0))
    d = torch.stack([x, y, z], dim=-1)
    pdf = z / math.pi
    return d, pdf


def uniform_sphere(u: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere from uniforms (..., 2)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def to_world(d_local, t, b, n):
    """Rotate a local (+z = normal) direction into the world frame."""
    return d_local[..., 0:1] * t + d_local[..., 1:2] * b \
        + d_local[..., 2:3] * n



def power_heuristic(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """MIS power heuristic (beta = 2), for weighting NEE against BSDF
    sampling."""
    a2 = pdf_a * pdf_a
    return a2 / torch.clamp_min(a2 + pdf_b * pdf_b, 1e-20)
