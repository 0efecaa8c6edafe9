"""Intersector interface — port of ``tpurt.render.intersectors``.

An intersector is a pair of functions built for a scene:

  closest(org, dirn, t_min, t_max) -> Hit      (closest-hit query)
  any_hit(org, dirn, t_min, t_max) -> bool[N]  (occlusion query)

Rays are world space; ``t`` is a world ray parameter (object-space
directions are not renormalized under instance transforms). The dense
brute-force pair here is the ``brute`` render path and the oracle the
kernel tests hold the tile intersector against.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from tpurt_torch.core.vecmath import intersect_tris
from tpurt_torch.scene.device import DeviceScene

BIG = 3.4e38


class SceneMeta(NamedTuple):
    """Static scene shape info: ``mesh_tri_ranges[m]`` is the (start,
    count) slice of mesh ``m`` in the global triangle arrays;
    ``inst_mesh`` maps instance → mesh."""

    mesh_tri_ranges: Tuple[Tuple[int, int], ...]
    inst_mesh: Tuple[int, ...]
    num_real_tris: int
    # any material alpha-tested (cutoff > 0 with a base-color texture)?
    has_alpha_cutout: bool = False


def scene_meta(scene) -> SceneMeta:
    """Build the static meta from a host Scene."""
    ranges = []
    start = 0
    for m in scene.meshes:
        ranges.append((start, m.num_triangles))
        start += m.num_triangles
    return SceneMeta(
        mesh_tri_ranges=tuple(ranges),
        inst_mesh=tuple(i.mesh_id for i in scene.instances),
        num_real_tris=start,
        has_alpha_cutout=any(
            m.alpha_cutoff > 0.0 and m.base_color_texture >= 0
            for m in scene.materials
        ),
    )


class Hit(NamedTuple):
    t: torch.Tensor  # (N,) f32 — world ray parameter (inf on miss)
    u: torch.Tensor  # (N,) f32 barycentric
    v: torch.Tensor  # (N,) f32 barycentric
    tri: torch.Tensor  # (N,) i32 global triangle id (-1 when not resolved)
    inst: torch.Tensor  # (N,) i32 instance id (-1 when not resolved)
    valid: torch.Tensor  # (N,) bool
    # flattened world-space prim slot of a cluster accel (indexes
    # PairAccel.shade_rows), -1 when the intersector has no such table
    slot: Optional[torch.Tensor] = None


Intersector = Callable[..., Hit]


def transform_ray(inv: torch.Tensor, org: torch.Tensor, dirn: torch.Tensor):
    """World ray → object space with a (3,4) affine; dir NOT renormalized."""
    org_o = org @ inv[:, :3].T + inv[:, 3]
    dir_o = dirn @ inv[:, :3].T
    return org_o, dir_o


def _per_ray(x, n, device):
    if isinstance(x, (int, float)):  # a fill: nothing copied to the device
        return torch.full((n,), float(x), dtype=torch.float32, device=device)
    return torch.as_tensor(x, dtype=torch.float32,
                           device=device).expand(n).contiguous()


def make_brute_force(ds: DeviceScene, meta: SceneMeta):
    """Dense all-pairs intersector (the no-acceleration-structure oracle).
    The winner per ray is the first triangle (in instance, then triangle
    order) at the minimal t, as in the reference."""

    def closest(org, dirn, t_min, t_max) -> Hit:
        n = org.shape[0]
        dev = org.device
        best_t = _per_ray(t_max, n, dev)
        best_t = torch.where(torch.isfinite(best_t), best_t,
                             torch.full_like(best_t, BIG))
        best_u = torch.zeros(n, dtype=torch.float32, device=dev)
        best_v = torch.zeros_like(best_u)
        best_tri = torch.zeros(n, dtype=torch.int32, device=dev)
        best_inst = torch.zeros_like(best_tri)
        found = torch.zeros(n, dtype=torch.bool, device=dev)
        t_min_b = _per_ray(t_min, n, dev)
        rows = torch.arange(n, device=dev)
        for inst_id, mesh_id in enumerate(meta.inst_mesh):
            start, count = meta.mesh_tri_ranges[mesh_id]
            if count == 0:
                continue
            org_o, dir_o = transform_ray(ds.inst_inv[inst_id], org, dirn)
            sl = slice(start, start + count)
            t, u, v, hit = intersect_tris(
                org_o[:, None, :], dir_o[:, None, :],
                ds.tri_v0[sl][None], ds.tri_v1[sl][None], ds.tri_v2[sl][None],
                t_min_b[:, None], best_t[:, None],
            )
            t_masked = torch.where(hit, t, torch.full_like(t, BIG))
            tm, jm = torch.min(t_masked, dim=1)
            # first index at the minimum (torch.min does not promise it)
            win = t_masked == tm[:, None]
            iota = torch.arange(count, device=dev)[None, :]
            jm = torch.where(win, iota, count).amin(dim=1)
            jm = torch.clamp(jm, max=count - 1)
            better = tm < best_t
            best_u = torch.where(better, u[rows, jm], best_u)
            best_v = torch.where(better, v[rows, jm], best_v)
            best_tri = torch.where(better, (jm + start).to(torch.int32),
                                   best_tri)
            best_inst = torch.where(
                better, torch.full_like(best_inst, inst_id), best_inst)
            best_t = torch.where(better, tm, best_t)
            found = found | better
        return Hit(
            t=torch.where(found, best_t, torch.full_like(best_t, torch.inf)),
            u=best_u, v=best_v, tri=best_tri, inst=best_inst, valid=found,
            slot=torch.full_like(best_tri, -1),
        )

    def any_hit(org, dirn, t_min, t_max) -> torch.Tensor:
        n = org.shape[0]
        dev = org.device
        occluded = torch.zeros(n, dtype=torch.bool, device=dev)
        t_max_b = _per_ray(t_max, n, dev)
        t_min_b = _per_ray(t_min, n, dev)
        for inst_id, mesh_id in enumerate(meta.inst_mesh):
            start, count = meta.mesh_tri_ranges[mesh_id]
            if count == 0:
                continue
            org_o, dir_o = transform_ray(ds.inst_inv[inst_id], org, dirn)
            sl = slice(start, start + count)
            _, _, _, hit = intersect_tris(
                org_o[:, None, :], dir_o[:, None, :],
                ds.tri_v0[sl][None], ds.tri_v1[sl][None], ds.tri_v2[sl][None],
                t_min_b[:, None], t_max_b[:, None],
            )
            occluded = occluded | hit.any(dim=1)
        return occluded

    return closest, any_hit
