"""Counter-based per-pixel RNG — port of ``tpurt.core.prng``.

Every random draw is a pure hash of (global seed, global sample index,
absolute pixel id, draw-site tag), so a frame is bit-identical across runs
and tile layouts, and equal bit for bit to the reference's stream.

torch has no uint32 shifts or adds on every device, so the uint32 lanes
live in int64 tensors masked to 32 bits after every add and multiply.
Multiplies split the constant into 16-bit halves so no int64 product
overflows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpurt_torch.utils import profiling

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _u32(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x.to(torch.int64) & _M32


def pcg_hash(x) -> torch.Tensor:
    """lowbias32: 32-bit mixer with static shifts; int64 in, int64 out."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 → f32 in [0, 1) using the top 24 bits (exact in f32)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


class PixelSampler(NamedTuple):
    """Stateless per-pixel sample stream. ``base`` already mixes seed,
    sample index, and pixel id; each draw site perturbs with a static tag."""

    base: torch.Tensor  # (...,) int64 holding uint32 values

    @staticmethod
    def make(seed, sample_index, pixel_id) -> "PixelSampler":
        """``seed`` and ``sample_index`` are ints or tensors (on
        ``pixel_id``'s device: the staged loop passes its input buffers,
        so a captured graph reads the batch's values)."""
        with profiling.step("rng"):
            pixel_id = _u32(pixel_id)
            dev = pixel_id.device
            s = pcg_hash(torch.as_tensor(seed, device=dev))
            s = pcg_hash((s + _u32(torch.as_tensor(sample_index,
                                                   device=dev))) & _M32)
            base = pcg_hash((s + _mul32(pixel_id, _GOLDEN)) & _M32)
            return PixelSampler(base=base)

    def u01(self, tag) -> torch.Tensor:
        """One uniform in [0, 1) per pixel for a draw-site tag: a static
        Python int (its term is computed on the host, so no tensor is
        copied to the device — the staged loop's CUDA graphs capture
        this) or a per-ray tensor (the wavefront loop's bounce)."""
        with profiling.step("rng"):
            if isinstance(tag, int):
                t = _mul32(tag & _M32, _GOLDEN)
            else:
                t = _mul32(_u32(torch.as_tensor(tag,
                                                device=self.base.device)),
                           _GOLDEN)
            return _to_unit_float(pcg_hash((self.base + t) & _M32))

    def u2(self, tag) -> torch.Tensor:
        """(..., 2) uniforms — two consecutive tags."""
        return torch.stack([self.u01(tag), self.u01(tag + 1)], dim=-1)


# Draw-site tag layout: the camera jitter uses tags 0–1; bounce b uses
# tags BOUNCE_BASE + b*BOUNCE_STRIDE + site.
TAG_JITTER = 0
BOUNCE_BASE = 8
BOUNCE_STRIDE = 8
SITE_LIGHT_PICK = 0
SITE_LIGHT_BARY = 1  # uses 2 tags
SITE_DIFFUSE = 3  # uses 2 tags
SITE_SPHERE = 5  # uses 2 tags
SITE_FRESNEL = 7


def bounce_tag(bounce: int, site: int) -> int:
    return BOUNCE_BASE + bounce * BOUNCE_STRIDE + site
