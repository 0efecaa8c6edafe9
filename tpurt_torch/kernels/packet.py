"""Shared constants and ray sort keys from ``tpurt.kernels.packet``.

The packet-BVH kernel itself (``_packet_kernel``, the ``bvh_packet``
intersector) is not ported yet (ROADMAP §1 item 15); the tile
intersector uses the constants and the Morton bit spreading below. Keys
are uint32 values held in int64 tensors.
"""

from __future__ import annotations

import torch

EPS_DENOM = 1e-12
BIG = 3.4e38
DEAD_KEY = 0xFFFFFFFF


def _expand_bits7(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 7 bits so there are 2 zero bits between each."""
    v = v.to(torch.int64)
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _quantize(x: torch.Tensor, levels: int) -> torch.Tensor:
    """min(trunc(x * levels), levels - 1) for x in [0, 1], as int64."""
    return torch.clamp((x * float(levels)).to(torch.int64), max=levels - 1)


def _ray_sort_keys(org, dirn, t_max_vec, scene_lo, scene_hi):
    """Origin-major, direction-minor coherence keys: 18-bit Morton of the
    origin (quantized to the scene box) above a 12-bit Morton of the
    direction. Dead rays (t_max < 0) get the max key."""
    ext = torch.clamp_min(scene_hi - scene_lo, 1e-12)
    q = torch.clamp((org - scene_lo) / ext, 0.0, 1.0)
    g = _quantize(q, 64)
    morton_o = ((_expand_bits7(g[:, 0]) << 2)
                | (_expand_bits7(g[:, 1]) << 1)
                | _expand_bits7(g[:, 2]))  # 18 bits
    d = torch.clamp(dirn * 0.5 + 0.5, 0.0, 1.0)
    gd = _quantize(d, 16)
    morton_d = ((_expand_bits7(gd[:, 0]) << 2)
                | (_expand_bits7(gd[:, 1]) << 1)
                | _expand_bits7(gd[:, 2]))  # 12 bits
    key = (morton_o << 12) | morton_d
    return torch.where(t_max_vec < 0.0, torch.full_like(key, DEAD_KEY), key)
