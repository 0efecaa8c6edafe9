"""Wavefront pipeline: ray compaction and material sort — port of
``tpurt.render.wavefront``.

A ring of ``capacity`` path states is kept full by refilling dead lanes
with fresh camera rays from the (sample × pixel) work stream: the refill
ranks are a prefix sum over the dead mask (stream compaction fused with
regeneration). Before shading, lanes are stably sorted by material kind,
dead lanes last. Radiance goes into the frame at every event (miss,
emission, NEE), so a lane is free the moment its path ends.

The estimator is the megakernel's: for a (seed, sample, pixel) both draw
the same random stream and make the same path decisions; the images
differ only in the order of the sums.

The reference's while loop is a Python loop here, with one host read a
wave (the refill's count and whether any lane is live). The frame
accumulates with ``index_put_(accumulate=True)`` under torch's
deterministic algorithms, switched on for that call only: on the card
it sums a pixel's lanes in a fixed order (a sort by pixel, then a
segmented sum) where a plain index add would race on atomics, so two
renders with one seed are bit-equal.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tpurt_torch import materials
from tpurt_torch.core.camera import Camera, camera_rays
from tpurt_torch.core.prng import TAG_JITTER, PixelSampler
from tpurt_torch.core.vecmath import dot
from tpurt_torch.render.integrator import (
    SHADOW_EPS,
    make_cutout_closest,
    make_intersectors,
    make_occluder,
    traced,
)
from tpurt_torch.render.intersectors import SceneMeta
from tpurt_torch.utils.config import RenderConfig


class WaveState(NamedTuple):
    """The ring of in-flight path states (C lanes)."""

    pixel: torch.Tensor  # (C,) int64 linear pixel id
    sample: torch.Tensor  # (C,) int64 global sample index
    bounce: torch.Tensor  # (C,) int64 path depth
    org: torch.Tensor  # (C, 3) f32
    dirn: torch.Tensor  # (C, 3) f32
    throughput: torch.Tensor  # (C, 3) f32
    allow_emission: torch.Tensor  # (C,) bool
    active: torch.Tensor  # (C,) bool


def _empty_state(capacity: int, device) -> WaveState:
    z3 = torch.zeros((capacity, 3), dtype=torch.float32, device=device)
    zi = torch.zeros(capacity, dtype=torch.int64, device=device)
    zb = torch.zeros(capacity, dtype=torch.bool, device=device)
    return WaveState(pixel=zi, sample=zi, bounce=zi, org=z3, dirn=z3,
                     throughput=z3, allow_emission=zb, active=zb)


def _refill(state: WaveState, next_path: int, seed, sample0, cam: Camera,
            w: int, h: int, total_paths: int):
    """Dead lanes claim consecutive work items: item k is (sample
    sample0 + k // (W·H), pixel k % (W·H)), sample-major so early waves
    cover whole frames first. Returns (state, items taken as a device
    scalar)."""
    dead = ~state.active
    rank = torch.cumsum(dead.to(torch.int64), 0) - 1  # the prefix sum
    k = next_path + rank
    take = dead & (k < total_paths)
    n_px = w * h
    pixel_new = k % n_px
    sample_new = sample0 + k // n_px
    sampler = PixelSampler.make(seed, sample_new, pixel_new)
    uj = sampler.u2(TAG_JITTER)
    org, dirn = camera_rays(cam, pixel_new % w, pixel_new // w, w, h,
                            jitter=(uj[..., 0], uj[..., 1]))
    sel = lambda a, b: torch.where(take, a, b)
    sel3 = lambda a, b: torch.where(take[:, None], a, b)
    new = WaveState(
        pixel=sel(pixel_new, state.pixel),
        sample=sel(sample_new, state.sample),
        bounce=sel(torch.zeros_like(state.bounce), state.bounce),
        org=sel3(org, state.org),
        dirn=sel3(dirn, state.dirn),
        throughput=sel3(torch.ones_like(state.throughput), state.throughput),
        allow_emission=state.allow_emission | take,
        active=state.active | take,
    )
    return new, take.sum()


def _material_sort(state: WaveState, hit_kind: torch.Tensor) -> torch.Tensor:
    """The permutation putting live lanes in material-kind batches, dead
    lanes last (a stable sort)."""
    key = torch.where(state.active, hit_kind.to(torch.int64), 0xFFFF)
    return torch.sort(key, stable=True).indices


def _permute(x, perm: torch.Tensor):
    return type(x)(*(f[perm] for f in x))


def _add_to_frame(fb: torch.Tensor, pixel: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """fb[pixel] += vals, summed in a fixed order (see the module
    docstring)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        fb.index_put_((pixel,), vals, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(was)


def render_batch_wavefront(ds, cam: Camera, seed, sample0, accel=None, *,
                           meta: SceneMeta, config: RenderConfig):
    """The wavefront counterpart of ``integrator.render_batch`` on the
    DeviceScene's device: ((H, W, 3) f32 radiance sum over
    ``spp_per_batch`` samples, (3,) f64 counters)."""
    w, h = config.width, config.height
    dev = ds.tri_v0.device
    total_paths = w * h * config.spp_per_batch
    capacity = min(config.wavefront_capacity, total_paths)
    closest, any_hit = make_intersectors(ds, accel, meta=meta,
                                         config=config, lean=True)
    any_hit = make_occluder(ds, accel, closest, any_hit, meta=meta)
    closest = make_cutout_closest(ds, accel, closest, meta=meta)
    resolver = materials.make_resolver(
        ds, accel, texture_filter=config.texture_filter)
    use_nee = config.use_nee

    def wave(state: WaveState, fb, rays):
        rays[0] += state.active.sum()
        # trace: dead lanes carry t_max -1
        hit = traced(closest, rays, state.org, state.dirn,
                      torch.where(state.active, math.inf, -1.0))
        hit_valid = hit.valid & state.active
        # miss: the background, and the lane dies
        missed = state.active & ~hit.valid
        _add_to_frame(fb, state.pixel, torch.where(
            missed[:, None], state.throughput * ds.background, 0.0))
        attrs = resolver(state.org, state.dirn, hit.t, hit.u, hit.v, hit.tri,
                         hit.inst, hit.slot)
        # the material sort (misses are already in the frame)
        if config.material_sort:
            perm = _material_sort(state, attrs.kind)
            state = _permute(state, perm)
            attrs = _permute(attrs, perm)
            hit_valid = hit_valid[perm]
        # each lane's stream, at each lane's own depth
        sampler = PixelSampler.make(seed, state.sample, state.pixel)
        # emission on camera hits and after specular bounces
        _add_to_frame(fb, state.pixel, torch.where(
            (hit_valid & state.allow_emission)[:, None],
            state.throughput * attrs.emission, 0.0))
        if use_nee:
            n_lanes = state.pixel.shape[0]
            shadow_org = materials.bounce_origin(
                attrs, torch.ones(n_lanes, device=dev))
            wi_l, dist_l, l_over_pdf, l_valid = materials.sample_light(
                ds, shadow_org, sampler, state.bounce)
            brdf_l = materials.eval_brdf(attrs, -state.dirn, wi_l)
            cos_s = torch.clamp_min(dot(attrs.n_shade, wi_l), 0.0)
            contrib = state.throughput * brdf_l * cos_s[:, None] * l_over_pdf
            want = hit_valid & l_valid & (contrib.amax(dim=-1) > 0.0)
            rays[1] += want.sum()
            occluded = traced(
                any_hit, rays, torch.where(want[:, None], shadow_org, 0.0),
                torch.where(want[:, None], wi_l, 1.0),
                torch.where(want, dist_l * (1.0 - SHADOW_EPS), -1.0))
            _add_to_frame(fb, state.pixel, torch.where(
                (want & ~occluded)[:, None], contrib, 0.0))
        # the next segment: the lane survives or dies
        bs = materials.sample_bounce(attrs, -state.dirn, sampler,
                                     state.bounce)
        throughput = torch.where(hit_valid[:, None],
                                 state.throughput * bs.weight,
                                 state.throughput)
        alive = (hit_valid & (state.bounce < config.max_bounces)
                 & (throughput.amax(dim=-1) > 1e-6))
        return WaveState(
            pixel=state.pixel, sample=state.sample, bounce=state.bounce + 1,
            org=torch.where(hit_valid[:, None],
                            materials.bounce_origin(attrs, bs.offset_sign),
                            0.0),
            dirn=torch.where(hit_valid[:, None], bs.wi, 1.0),
            throughput=throughput,
            allow_emission=bs.is_specular | (not use_nee),
            active=alive,
        )

    state = _empty_state(capacity, dev)
    fb = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros(3, dtype=torch.float64, device=dev)
    next_path = 0  # the next work item of the stream
    while True:
        state, taken = _refill(state, next_path, seed, sample0, cam, w, h,
                               total_paths)
        # the one host read of a wave: no live lane after the refill
        # means no work is pending either
        taken, live = torch.stack(
            [taken, state.active.any().to(torch.int64)]).tolist()
        if not live:
            break
        next_path += taken
        state = wave(state, fb, rays)
    return fb.reshape(h, w, 3), rays
