"""Intersector selection for the render loop — the ``bvh_tile``,
``bvh_pair`` and ``bvh_packet`` branches of
``tpurt.render.integrator.make_intersectors`` — and the alpha-cutout
wrappers ``make_occluder`` and ``make_cutout_closest``.

The reference's megakernel ``render_batch`` is not ported yet (ROADMAP
§1 item 6); the port renders through the staged loop in
``render.staged``.
"""

from __future__ import annotations

import torch

from tpurt_torch import materials
from tpurt_torch.bvh.cluster import PacketAccel
from tpurt_torch.core.vecmath import EPS_RAY
from tpurt_torch.render.intersectors import Hit, SceneMeta
from tpurt_torch.utils.config import RenderConfig

# shadow rays stop this fraction short of the sampled light point
SHADOW_EPS = 1e-3
# most closest traces a cut-out query makes: each transparent candidate
# costs one more; a ray still behind transparent texels after the last
# counts as occluded (the occluder) or keeps its first candidate as an
# opaque hit (the closest)
ALPHA_OCCLUSION_ROUNDS = 4


def make_intersectors(ds, accel, *, meta: SceneMeta, config: RenderConfig,
                      wave: str = "bounce", lean: bool = False,
                      live_cap: int = 0, shadow_live_cap: int = 0):
    """Closest/any-hit pair for one wave kind. A PacketAccel takes the
    packet intersector with ``config.packet_ray_sort`` for every wave (no
    lean mode, budgets or live caps, as in the reference). ``bvh_pair``
    takes the pair-wavefront intersector with ``config.pairs_per_ray``
    for every wave (no sort, lean mode or live caps, as in the
    reference). Otherwise the tile intersector: "primary" (camera waves —
    the config's primary sort, screen-tile order by default, and
    ``pairs_avg``) or "bounce" (incoherent waves — octant sort and
    ``pairs_avg_bounce``), with the config's per-tile clamp, the shadow
    budget ``pairs_avg_shadow`` and their maximum as the pair-segment
    capacity. ``lean=True`` skips the Hit.tri/Hit.inst lookups
    (renderers shade through Hit.slot)."""
    if isinstance(accel, PacketAccel):
        from tpurt_torch.kernels.packet import make_packet_intersector

        return make_packet_intersector(ds, accel,
                                       ray_sort=config.packet_ray_sort)
    if config.intersector == "bvh_pair":
        from tpurt_torch.kernels.pairwave import make_pair_intersector

        return make_pair_intersector(ds, accel,
                                     pairs_per_ray=config.pairs_per_ray)
    from tpurt_torch.kernels.tilewave import make_tile_intersector

    if wave == "primary":
        sort, avg = config.tile_primary_sort, config.pairs_avg
    elif wave == "bounce":
        sort, avg = config.tile_ray_sort, config.pairs_avg_bounce
    else:
        raise NotImplementedError(
            f"wave kind {wave!r}: the sorted-wave pipeline is not ported "
            "yet (ROADMAP §1 item 6)")
    return make_tile_intersector(
        ds, accel, pairs_per_tile=config.pairs_per_tile, pairs_avg=avg,
        ray_sort=sort, shadow_ray_sort=config.tile_shadow_sort,
        shadow_pairs_avg=config.pairs_avg_shadow,
        pairs_avg_cap=max(config.pairs_avg, config.pairs_avg_bounce,
                          config.pairs_avg_shadow),
        lean=lean, live_cap=live_cap, shadow_live_cap=shadow_live_cap,
    )


def _make_alpha_skip(ds, accel):
    """The cut-out probe of a candidate hit: True where its texel's alpha
    is below its material's cutoff (the surface is see-through there).
    Cluster accels read the hit's shade record (``Hit.slot``: corner UVs
    22:28, texture 28, cutoff 29); the packet BVH reads the hit's
    triangle, instance and material from the DeviceScene (``Hit.tri``,
    ``Hit.inst``)."""
    shade_rows = getattr(accel, "shade_rows", None)

    def alpha_skip(hit):
        w = 1.0 - hit.u - hit.v
        if shade_rows is not None:
            rec = shade_rows[torch.clamp_min(hit.slot, 0).long()]
            uv = materials._interp_uv(rec, w, hit.u, hit.v)
            tex_id = rec[:, 28].to(torch.int32)
            cut = rec[:, 29]
        else:
            tri = torch.clamp(hit.tri, 0, ds.tri_v0.shape[0] - 1).long()
            inst = torch.clamp(hit.inst, 0, ds.inst_mesh.shape[0] - 1).long()
            uv = (w[:, None] * ds.tri_uv0[tri]
                  + hit.u[:, None] * ds.tri_uv1[tri]
                  + hit.v[:, None] * ds.tri_uv2[tri])
            override = ds.inst_mat_override[inst]
            mid = torch.where(override >= 0, override, ds.tri_mat[tri])
            mid = torch.clamp(mid, 0, ds.mat_kind.shape[0] - 1).long()
            tex_id = ds.mat_texture[mid]
            cut = ds.mat_alpha_cutoff[mid]
        a = materials.sample_alpha(ds.tex_alpha, ds.tex_meta, tex_id,
                                   uv[:, 0], uv[:, 1])
        return (cut > 0.0) & (a < cut)

    return alpha_skip


def _round_trace(closest, o, dirn, tq, want_stats, stats):
    """One closest trace of a cut-out loop; its stats fold into the
    loop's: pair counts summed, the overflow flag kept at its largest, a
    live-cap overflow summed over the rounds."""
    if not (want_stats and hasattr(closest, "with_stats")):
        return closest(o, dirn, 0.0, tq), stats
    hit, st = closest.with_stats(o, dirn, 0.0, tq)
    if stats is None:
        return hit, st
    folded = [stats[0] + st[0], torch.maximum(stats[1], st[1])]
    if st.shape[0] > 2:
        folded.append(stats[2] + st[2])
    return hit, torch.stack(folded)


def _advance(o, dirn, t, live):
    """The next round's origin past a transparent candidate at ``t``, and
    the scale-aware epsilon it moved beyond the hit point (a fixed 1e-4
    vanishes in f32 at Cornell's 555-unit scale)."""
    pos = o + t[:, None] * dirn
    eps = EPS_RAY * torch.clamp_min(pos.abs().amax(dim=-1), 1.0)
    o = torch.where(live[:, None], pos + eps[:, None] * dirn, o)
    return o, eps


def _per_ray_tmax(t_max, org):
    n = org.shape[0]
    return torch.as_tensor(t_max, dtype=torch.float32,
                           device=org.device).expand(n)


def make_occluder(ds, accel, closest, any_hit, *, meta: SceneMeta):
    """Occlusion query with alpha cutout.

    Opaque scenes (``meta.has_alpha_cutout`` False — every ladder preset)
    get back the very ``any_hit`` they passed, the lean kernel path.
    Alpha-tested scenes run a bounded loop of up to
    ``ALPHA_OCCLUSION_ROUNDS`` closest traces: each candidate occluder's
    alpha is sampled at the hit UV, and a texel below the material cutoff
    is skipped by advancing the ray origin past the hit and tracing
    again. The alpha test is plain tensor code between the kernel
    calls."""
    if not meta.has_alpha_cutout:
        return any_hit
    alpha_skip = _make_alpha_skip(ds, accel)

    def _occluded(org, dirn, t_min, t_max, want_stats):
        del t_min
        tmax = _per_ray_tmax(t_max, org)
        occ = torch.zeros(org.shape[0], dtype=torch.bool,
                          device=org.device)
        live = tmax > 0.0
        o = org
        stats = None
        for _ in range(ALPHA_OCCLUSION_ROUNDS):
            tq = torch.where(live, tmax, -1.0)
            hit, stats = _round_trace(closest, o, dirn, tq, want_stats,
                                      stats)
            skip = hit.valid & alpha_skip(hit)
            occ = occ | (live & hit.valid & ~skip)
            live = live & skip
            o, eps = _advance(o, dirn, hit.t, live)
            tmax = torch.where(live, tmax - (hit.t + eps), tmax)
            live = live & (tmax > 0.0)
        occ = occ | live  # rounds exhausted: conservatively occluded
        if want_stats:
            if stats is None:
                stats = torch.zeros(2, dtype=torch.float32,
                                    device=org.device)
            return occ, stats
        return occ

    def occluded(org, dirn, t_min, t_max):
        return _occluded(org, dirn, t_min, t_max, False)

    def occluded_with_stats(org, dirn, t_min, t_max):
        return _occluded(org, dirn, t_min, t_max, True)

    if hasattr(closest, "with_stats"):
        occluded.with_stats = occluded_with_stats
    return occluded


def make_cutout_closest(ds, accel, closest, *, meta: SceneMeta):
    """Closest-hit query that discards alpha-failed intersections (glTF
    ``alphaMode: MASK`` applies to every ray kind): a bounded re-trace
    loop advancing past transparent candidates, adding each advance to
    the returned world-space ``t``. Opaque scenes get back the very
    ``closest`` they passed."""
    if not meta.has_alpha_cutout:
        return closest
    alpha_skip = _make_alpha_skip(ds, accel)

    def _trace(org, dirn, t_min, t_max, want_stats):
        del t_min
        tmax = _per_ray_tmax(t_max, org)
        live = tmax > 0.0
        o = org
        t_off = torch.zeros(org.shape[0], dtype=torch.float32,
                            device=org.device)
        best = None
        stats = None
        for _ in range(ALPHA_OCCLUSION_ROUNDS):
            tq = torch.where(live, tmax, -1.0)
            hit, stats = _round_trace(closest, o, dirn, tq, want_stats,
                                      stats)
            skip = hit.valid & alpha_skip(hit)
            accept = live & ~skip  # a miss or an alpha-passing hit: final
            shifted = hit._replace(t=t_off + hit.t)
            if best is None:
                best = shifted
            else:
                best = Hit(*(
                    fa if fa is None else torch.where(accept, fa, fb)
                    for fa, fb in zip(shifted, best)))
            live = live & skip
            o, eps = _advance(o, dirn, hit.t, live)
            t_off = torch.where(live, t_off + hit.t + eps, t_off)
            tmax = torch.where(live, tmax - (hit.t + eps), tmax)
        # rounds exhausted behind transparent texels: the first candidate
        # stands as an opaque hit (the occluder's bias)
        if want_stats:
            if stats is None:
                stats = torch.zeros(2, dtype=torch.float32,
                                    device=org.device)
            return best, stats
        return best

    def cutout_closest(org, dirn, t_min, t_max):
        return _trace(org, dirn, t_min, t_max, False)

    def cutout_with_stats(org, dirn, t_min, t_max):
        return _trace(org, dirn, t_min, t_max, True)

    if hasattr(closest, "with_stats"):
        cutout_closest.with_stats = cutout_with_stats
    return cutout_closest
