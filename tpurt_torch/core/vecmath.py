"""Vector math and intersection primitives — port of ``tpurt.core.vecmath``.

All functions take arbitrary leading batch dimensions with a trailing
3-axis and run element-wise on whatever device their tensors live on.
"""

from __future__ import annotations

import torch

# Conservative f32 epsilons (same values as the reference).
EPS_DENOM = 1e-9
EPS_RAY = 1e-4


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis, keeps no dims."""
    return (a * b).sum(dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis (broadcasting)."""
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Normalize over the trailing axis (safe for zero vectors)."""
    return v * torch.reciprocal(
        torch.sqrt(torch.clamp_min(dot(v, v), eps)))[..., None]


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of direction ``d`` about normal ``n``."""
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(d: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Snell refraction of unit ``d`` about unit ``n``; ``eta`` =
    n_incident / n_transmitted. Returns ``(t, tir)``; ``t`` is garbage
    where ``tir`` (total internal reflection)."""
    cos_i = -dot(d, n)
    sin2_t = (eta ** 2) * torch.clamp_min(1.0 - cos_i ** 2, 0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    t = eta[..., None] * d + (eta * cos_i - cos_t)[..., None] * n
    return normalize(t), tir


def schlick_fresnel(cos_i, ior_i, ior_t):
    """Schlick's approximation to the Fresnel reflectance."""
    r0 = ((ior_i - ior_t) / (ior_i + ior_t)) ** 2
    return r0 + (1.0 - r0) * (1.0 - torch.abs(cos_i)) ** 5


def build_onb(n: torch.Tensor):
    """Branchless orthonormal basis from a unit normal (Duff et al. 2017).
    Returns ``(t, b)`` with the batch shape of ``n``."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def safe_inv_dir(d: torch.Tensor) -> torch.Tensor:
    """Reciprocal of a ray direction with a sign-preserving clamp away
    from 0 (a clamped axis gives a huge slab interval, never a false
    miss)."""
    tiny = 1e-12
    d_safe = torch.where(torch.abs(d) < tiny,
                         torch.where(d >= 0.0, tiny, -tiny), d)
    return 1.0 / d_safe


def ray_aabb(org, inv_dir, bmin, bmax, t_min, t_max) -> torch.Tensor:
    """Slab test: does the ray hit the box within [t_min, t_max]? All
    arguments broadcast; ``inv_dir`` comes from :func:`safe_inv_dir`."""
    t0 = (bmin - org) * inv_dir
    t1 = (bmax - org) * inv_dir
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    return (t_near <= t_far) & (t_far >= t_min) & (t_near <= t_max)


def intersect_tris(org, dirn, v0, v1, v2, t_min, t_max):
    """Möller–Trumbore ray/triangle intersection, double-sided; inputs
    broadcast over leading dims with a trailing 3-axis. Returns
    ``(t, u, v, hit)``; gate t/u/v on ``hit``."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(dirn, e2)
    det = dot(e1, pvec)
    valid = torch.abs(det) > EPS_DENOM
    inv_det = 1.0 / torch.where(valid, det, torch.ones_like(det))
    tvec = org - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(dirn, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    return t, u, v, hit


def closest_hit_brute_force(org, dirn, v0, v1, v2, t_min, t_max):
    """Every ray against every triangle, the closest hit kept (the "no
    BVH" oracle). org/dirn: (R, 3); v0/v1/v2: (T, 3); t_min/t_max: (R,).
    Returns ``(t, u, v, tri_id, hit)``, each (R,); a ray that hits nothing
    has t = inf and tri_id 0, and an exact-t tie keeps the lower id."""
    t, u, v, hit = intersect_tris(org[:, None, :], dirn[:, None, :],
                                  v0[None, :, :], v1[None, :, :],
                                  v2[None, :, :], t_min[:, None],
                                  t_max[:, None])
    t_masked = torch.where(hit, t, torch.inf)
    tri_id = torch.argmin(t_masked, dim=1)
    r = torch.arange(org.shape[0], device=org.device)
    return (t_masked[r, tri_id], u[r, tri_id], v[r, tri_id], tri_id,
            hit.any(dim=1))
