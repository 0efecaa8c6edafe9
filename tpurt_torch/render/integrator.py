"""The megakernel integrator — port of ``tpurt.render.integrator`` —
and intersector selection for every render loop.

``render_batch`` traces one progressive batch over the full frame in
32×32 screen-tile pixel order: every sample of the batch flattened into
one wave (sample-major), the bounce loop unrolled with masked dead rays
(``path_trace_rays``), each wave through the config's intersector with
the "bounce" settings, primaries included, as in the reference. Also
here: ``make_intersectors`` (brute force, the two-level LBVH walk and
the ``bvh_tile``, ``bvh_pair`` and ``bvh_packet`` intersectors) and the
alpha-cutout wrappers ``make_occluder`` and ``make_cutout_closest``.
"""

from __future__ import annotations

import math

import torch

from tpurt_torch import materials
from tpurt_torch.bvh.cluster import PacketAccel
from tpurt_torch.core.camera import Camera, camera_rays, \
    full_frame_pixels_tiled
from tpurt_torch.core.prng import TAG_JITTER, PixelSampler
from tpurt_torch.core.vecmath import EPS_RAY, dot
from tpurt_torch.render.intersectors import Hit, SceneMeta, make_brute_force
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
    """Closest/any-hit pair for one wave kind. No accel (None) takes the
    dense brute force, a SceneAccel the two-level LBVH walk with
    ``config.bvh_leaf_size``, a PacketAccel the packet intersector with
    ``config.packet_ray_sort`` for every wave (no lean mode, budgets or
    live caps, as in the reference). ``bvh_pair`` takes the
    pair-wavefront intersector with ``config.pairs_per_ray`` for every
    wave (no sort, lean mode or live caps, as in the reference).
    Otherwise the tile intersector: "primary" (camera waves — the
    config's primary sort, screen-tile order by default, and
    ``pairs_avg``), "bounce" (incoherent waves — octant sort and
    ``pairs_avg_bounce``) or "presorted" (the sorted-wave loop's waves,
    already in coherence order and consumed in it: no forward or restore
    sort for either trace, exact entries kept, ``pairs_avg_bounce``),
    with the config's per-tile clamp, the shadow budget
    ``pairs_avg_shadow`` and their maximum as the pair-segment capacity.
    ``lean=True`` skips the Hit.tri/Hit.inst lookups (renderers shade
    through Hit.slot)."""
    from tpurt_torch.bvh.two_level import SceneAccel

    if accel is None:
        return make_brute_force(ds, meta)
    if isinstance(accel, SceneAccel):
        from tpurt_torch.bvh.two_level import make_two_level_intersector

        return make_two_level_intersector(ds, accel,
                                          leaf_size=config.bvh_leaf_size)
    if isinstance(accel, PacketAccel):
        from tpurt_torch.kernels.packet import make_packet_intersector

        return make_packet_intersector(ds, accel,
                                       ray_sort=config.packet_ray_sort)
    if config.intersector == "bvh_pair":
        from tpurt_torch.kernels.pairwave import make_pair_intersector

        return make_pair_intersector(ds, accel,
                                     pairs_per_ray=config.pairs_per_ray)
    from tpurt_torch.kernels.tilewave import make_tile_intersector

    shadow_sort = config.tile_shadow_sort
    if wave == "primary":
        sort, avg = config.tile_primary_sort, config.pairs_avg
    elif wave == "bounce":
        sort, avg = config.tile_ray_sort, config.pairs_avg_bounce
    elif wave == "presorted":
        sort = shadow_sort = "pre"
        avg = config.pairs_avg_bounce
    else:
        raise ValueError(f"wave kind {wave!r}")
    return make_tile_intersector(
        ds, accel, pairs_per_tile=config.pairs_per_tile, pairs_avg=avg,
        ray_sort=sort, shadow_ray_sort=shadow_sort,
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


def traced(fn, rays, org, dirn, tmax):
    """One intersector call; where it reports stats, its pair-budget
    overflow goes into ``rays[2]``, and a live-cap overflow (a third
    entry) into ``rays[3]`` where the counters have that slot. The pair
    intersector's any-hit reports none."""
    if not hasattr(fn, "with_stats"):
        return fn(org, dirn, 0.0, tmax)
    out, tstats = fn.with_stats(org, dirn, 0.0, tmax)
    rays[2] += tstats[1]
    if tstats.shape[0] > 2 and rays.shape[0] > 3:
        rays[3] += tstats[2]
    return out


def path_trace_rays(ds, closest, any_hit, org, dirn, sampler, *,
                    max_bounces: int, use_nee: bool,
                    shading_mode: str = "full", resolver=None):
    """Trace a wave of camera rays to completion: ((N, 3) radiance,
    (3,) f64 counters [closest rays, shadow rays, pair-budget overflow
    events]). The bounce loop is unrolled with masked dead rays; flat
    shading traces the camera rays only and returns the hit's albedo
    (the background on a miss)."""
    n = org.shape[0]
    dev = org.device
    rays = torch.zeros(3, dtype=torch.float64, device=dev)
    if resolver is None:
        def resolver(o, d, t, u, v, tri, inst, slot):
            return materials.resolve_hit(ds, o, d, t, u, v, tri, inst)

    if shading_mode == "flat":
        rays[0] += n
        hit = traced(closest, rays, org, dirn, math.inf)
        attrs = resolver(org, dirn, hit.t, hit.u, hit.v, hit.tri, hit.inst,
                         hit.slot)
        return (torch.where(hit.valid[:, None], attrs.albedo,
                            ds.background), rays)

    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    allow_emission = torch.ones(n, dtype=torch.bool, device=dev)
    for bounce in range(max_bounces + 1):
        rays[0] += alive.sum()
        # dead rays get t_max -1: no intersector walks them
        hit = traced(closest, rays, org, dirn,
                      torch.where(alive, math.inf, -1.0))
        hit_valid = hit.valid & alive
        # miss: the background, and the ray dies
        radiance = radiance + torch.where((alive & ~hit.valid)[:, None],
                                          throughput * ds.background, 0.0)
        attrs = resolver(org, dirn, hit.t, hit.u, hit.v, hit.tri, hit.inst,
                         hit.slot)
        # emission on camera hits and after specular bounces; NEE covers
        # it after diffuse ones
        radiance = radiance + torch.where(
            (hit_valid & allow_emission)[:, None],
            throughput * attrs.emission, 0.0)
        if use_nee:
            shadow_org = materials.bounce_origin(
                attrs, torch.ones(n, device=dev))
            wi_l, dist_l, l_over_pdf, l_valid = materials.sample_light(
                ds, shadow_org, sampler, bounce)
            brdf_l = materials.eval_brdf(attrs, -dirn, wi_l)
            cos_s = torch.clamp_min(dot(attrs.n_shade, wi_l), 0.0)
            contrib = throughput * brdf_l * cos_s[:, None] * l_over_pdf
            want = hit_valid & l_valid & (contrib.amax(dim=-1) > 0.0)
            rays[1] += want.sum()
            # the rays not wanted are dead (t_max -1) and carry finite
            # values into the intersector, as the staged loop's do
            occluded = traced(
                any_hit, rays, torch.where(want[:, None], shadow_org, 0.0),
                torch.where(want[:, None], wi_l, 1.0),
                torch.where(want, dist_l * (1.0 - SHADOW_EPS), -1.0))
            radiance = radiance + torch.where((want & ~occluded)[:, None],
                                              contrib, 0.0)
        bs = materials.sample_bounce(attrs, -dirn, sampler, bounce)
        throughput = torch.where(hit_valid[:, None], throughput * bs.weight,
                                 throughput)
        # dead and missed rays carry inf hit points: keep them finite
        org = torch.where(hit_valid[:, None],
                          materials.bounce_origin(attrs, bs.offset_sign), 0.0)
        dirn = torch.where(hit_valid[:, None], bs.wi, 1.0)
        allow_emission = bs.is_specular | (not use_nee)
        alive = (hit_valid & (bounce < max_bounces)
                 & (throughput.amax(dim=-1) > 1e-6))
    return radiance, rays


def render_pixels(ds, cam: Camera, seed, sample0, accel, px, py, *,
                  meta: SceneMeta, config: RenderConfig):
    """Sum of ``config.spp_per_batch`` radiance samples for each pixel in
    (px, py) with the global sample indices [sample0, sample0 + spp):
    ((P, 3) f32, (3,) counters). The samples are flattened sample-major
    into one wave, so the batch is one trace a path segment. The random
    stream is a pure function of (seed, sample index, pixel id), so any
    split of pixels or samples gives the same values: the unit a sharded
    render would split."""
    w, h = config.width, config.height
    closest, any_hit = make_intersectors(ds, accel, meta=meta,
                                         config=config, lean=True)
    any_hit = make_occluder(ds, accel, closest, any_hit, meta=meta)
    closest = make_cutout_closest(ds, accel, closest, meta=meta)
    spp = config.spp_per_batch
    n_px = px.shape[0]
    px_r = px.repeat(spp)
    py_r = py.repeat(spp)
    pixel_id = py_r.to(torch.int64) * w + px_r.to(torch.int64)
    sample_idx = sample0 + torch.arange(
        spp, dtype=torch.int64, device=px.device).repeat_interleave(n_px)
    sampler = PixelSampler.make(seed, sample_idx, pixel_id)
    uj = sampler.u2(TAG_JITTER)
    org, dirn = camera_rays(cam, px_r, py_r, w, h,
                            jitter=(uj[..., 0], uj[..., 1]))
    radiance, rays = path_trace_rays(
        ds, closest, any_hit, org.contiguous(), dirn, sampler,
        max_bounces=config.max_bounces, use_nee=config.use_nee,
        shading_mode=config.shading_mode,
        resolver=materials.make_resolver(
            ds, accel, texture_filter=config.texture_filter))
    return radiance.reshape(spp, n_px, 3).sum(dim=0), rays


def render_batch(ds, cam: Camera, seed, sample0, accel=None, *,
                 meta: SceneMeta, config: RenderConfig):
    """One progressive batch over the full frame on the DeviceScene's
    device: ((H, W, 3) f32 radiance sum, (3,) f64
    counters [closest, shadow, pair-budget overflow events]). Pixels are
    traced in 32×32 screen-tile order and their sums scattered back to
    raster order by pixel id (the order never changes a value: the random
    stream keys off the pixel id)."""
    w, h = config.width, config.height
    dev = ds.tri_v0.device
    px, py = full_frame_pixels_tiled(w, h)
    px, py = px.to(dev), py.to(dev)
    total, counts = render_pixels(ds, cam, seed, sample0, accel, px, py,
                                  meta=meta, config=config)
    linear = py.to(torch.int64) * w + px.to(torch.int64)
    img = torch.zeros((h * w, 3), dtype=torch.float32, device=dev)
    img[linear] = total
    return img.reshape(h, w, 3), counts
