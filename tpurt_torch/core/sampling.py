"""Monte-Carlo sampling helpers — port of ``tpurt.core.sampling``.

The reference's key discipline: one base threefry key per render, a key
per sample batch (``batch_key``, ``jax.random.fold_in``) and shaped
uniforms from a key (``uniform2``, ``jax.random.uniform``). Both are
carried here bit for bit, threefry-2x32 included, in plain torch on the
key's device; the renderer itself draws every random number from
``core.prng``. A key is a (2,) int64 tensor holding two uint32 words (the
``core.prng`` idiom: torch has no uint32 shifts or adds on every device).
The random bits follow jax's partitionable threefry layout
(``jax_threefry_partitionable``, on by default): one counter per flat
index, split into high and low words, and the two output words xor-ed.
"""

from __future__ import annotations

import math

import torch

from tpurt_torch.core.prng import _M32, _u32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry_2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    (2,) key, as ``jax._src.prng._threefry2x32_lowering``: the key
    schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA) injected after every 4
    rounds with the injection count. uint32 words in int64, masked."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (_u32(x0) + ks[0]) & _M32
    x1 = (_u32(x1) + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _threefry_seed(seed: int) -> torch.Tensor:
    """The key ``jax.random.PRNGKey(seed)`` makes (32-bit jax), on the
    CPU: the high word 0 and the low word ``seed mod 2^32``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64)


def batch_key(base_key: torch.Tensor, batch_index) -> torch.Tensor:
    """Key for one progressive sample batch: ``jax.random.fold_in(base,
    batch_index)``, the hash of the counter words (0, batch_index mod
    2^32)."""
    dev = base_key.device
    data = torch.tensor([int(batch_index) & _M32], dtype=torch.int64,
                        device=dev)
    y0, y1 = _threefry_2x32(base_key, torch.zeros_like(data), data)
    return torch.cat([y0, y1])


def _random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (jax's partitionable
    ``threefry_random_bits``), int64 holding uint32."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = _threefry_2x32(key, idx >> 32, idx & _M32)
    return (y0 ^ y1).reshape(tuple(shape))


def uniform2(key: torch.Tensor, shape) -> torch.Tensor:
    """(…, 2) f32 uniforms in [0, 1) — ``jax.random.uniform(key, (*shape,
    2))``: the top 23 bits as a mantissa of [1, 2), minus 1."""
    bits = _random_bits(key, tuple(shape) + (2,))
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


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
