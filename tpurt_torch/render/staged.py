"""Staged wave loop — port of the single-device path of
``tpurt.render.staged``, as one eager Python loop.

Per sample batch: raygen → for each bounce: closest trace, shade with NEE
setup, occlusion trace → resolve (tile order → raster). Flat shading
(hello_triangle) traces the primary wave only and resolves the albedo
of each hit. The estimator is
the reference's: same RNG tags, same masks, same event order, the same
counter layout. The reference's per-stage executables, AOT cache, stage
fusion variants and the sorted-wave pipeline exist to work around a TPU
backend and are not carried.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tpurt_torch import materials
from tpurt_torch.core.camera import Camera, camera_rays, \
    full_frame_pixels_tiled
from tpurt_torch.core.prng import TAG_JITTER, PixelSampler
from tpurt_torch.core.vecmath import dot
from tpurt_torch.render.integrator import (
    SHADOW_EPS,
    make_cutout_closest,
    make_intersectors,
    make_occluder,
)
from tpurt_torch.render.intersectors import SceneMeta
from tpurt_torch.utils.config import RenderConfig


class WaveState(NamedTuple):
    """Inter-stage SoA path state (flattened samples × pixels)."""

    org: torch.Tensor  # (N, 3)
    dirn: torch.Tensor  # (N, 3)
    radiance: torch.Tensor  # (N, 3)
    throughput: torch.Tensor  # (N, 3)
    alive: torch.Tensor  # (N,) bool
    allow_emission: torch.Tensor  # (N,) bool
    # (NCOUNT,) f64 counters: [closest, shadow, pair_overflow,
    # live_overflow, live-after-bounce-0..MB, want-at-bounce-0..MB]
    rays: torch.Tensor


def counter_layout(max_bounces: int):
    """(NCOUNT, WANT0): counter-vector length and first want-count slot."""
    return 4 + 2 * (max_bounces + 1), 4 + max_bounces + 1


def _caps(caps, count: int, n: int):
    """Per-entry cap list, 0 where absent or not below the wave size."""
    out = []
    for b in range(count):
        cap = int(caps[b]) if b < len(caps) else 0
        out.append(cap if 0 < cap < n else 0)
    return out


class StagedRenderer:
    """One sample batch of ``config.spp_per_batch`` samples per pixel on
    ``device``: ``renderer(cam, seed, sample0) -> ((H, W, 3) radiance sum,
    (NCOUNT,) counters)``. The stages are methods so a caller can stop at
    any wave (``chip_smoke.py`` takes the first bounce wave's kernel
    inputs from them)."""

    def __init__(self, ds, accel, *, meta: SceneMeta, config: RenderConfig,
                 device):
        self.ds = ds
        self.config = config
        self.device = device = torch.device(device)
        w, h = config.width, config.height
        spp = config.spp_per_batch
        mb = config.max_bounces
        self.ncount, self.want0 = counter_layout(mb)
        px, py = full_frame_pixels_tiled(w, h)
        self.n_px = n_px = px.shape[0]
        self.n = n = n_px * spp
        self.px = px.repeat(spp).to(device)
        self.py = py.repeat(spp).to(device)
        lin = py.to(torch.int64) * w + px.to(torch.int64)
        self.pid = lin.repeat(spp).to(device)  # RNG pixel key per ray
        self.linear = lin.to(device)  # tile order → raster index
        # within-batch sample index of every ray
        self.ds_r = torch.arange(spp, dtype=torch.int64).repeat_interleave(
            n_px).to(device)

        # one intersector per wave kind and cap (caps come from measured
        # tables; alive rays past a cap are counted as live overflow).
        # Alpha-tested scenes wrap each in its cut-out loop; opaque scenes
        # keep the intersector itself.
        def closest(wave, live_cap=0):
            fn = make_intersectors(ds, accel, meta=meta, config=config,
                                   wave=wave, lean=True,
                                   live_cap=live_cap)[0]
            return make_cutout_closest(ds, accel, fn, meta=meta)

        def occluder(shadow_cap):
            fn, any_hit = make_intersectors(
                ds, accel, meta=meta, config=config, wave="bounce",
                lean=True, shadow_live_cap=shadow_cap)
            return make_occluder(ds, accel, fn, any_hit, meta=meta)

        live_caps = _caps(config.live_caps, mb, n)
        self.closest = [closest("primary")] + [
            closest("bounce", live_caps[b - 1]) for b in range(1, mb + 1)]
        self.occluders = [occluder(cap) for cap in
                          _caps(config.shadow_caps, mb + 1, n)]
        self.resolver = materials.make_resolver(
            ds, accel, texture_filter=config.texture_filter)

    def sampler(self, seed, sample0) -> PixelSampler:
        return PixelSampler.make(seed, sample0 + self.ds_r, self.pid)

    def raygen(self, cam: Camera, seed, sample0) -> WaveState:
        c = self.config
        n, dev = self.n, self.device
        uj = self.sampler(seed, sample0).u2(TAG_JITTER)
        org, dirn = camera_rays(cam, self.px, self.py, c.width, c.height,
                                jitter=(uj[..., 0], uj[..., 1]))
        return WaveState(
            org=org.contiguous(),
            dirn=dirn,
            radiance=torch.zeros((n, 3), dtype=torch.float32, device=dev),
            throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
            alive=torch.ones(n, dtype=torch.bool, device=dev),
            allow_emission=torch.ones(n, dtype=torch.bool, device=dev),
            rays=torch.zeros(self.ncount, dtype=torch.float64, device=dev),
        )

    def trace(self, state: WaveState, bounce: int):
        """Closest-hit trace of the wave (one intersector call)."""
        rays = state.rays.clone()
        rays[0] += state.alive.sum()
        tmax = torch.where(state.alive, math.inf, -1.0)
        hit = self._call(self.closest[bounce], rays, state.org, state.dirn,
                         tmax)
        return hit, state._replace(rays=rays)

    @staticmethod
    def _call(fn, rays, org, dirn, tmax):
        """One intersector call; its stats go into the counters where it
        reports them (pair overflow, and live overflow where there is a
        third entry). The pair intersector's any-hit reports none."""
        if not hasattr(fn, "with_stats"):
            return fn(org, dirn, 0.0, tmax)
        out, tstats = fn.with_stats(org, dirn, 0.0, tmax)
        rays[2] += tstats[1]
        if tstats.shape[0] > 2:
            rays[3] += tstats[2]
        return out

    def shade(self, state: WaveState, hit, sampler, bounce: int):
        """Miss/emission events, NEE shadow-ray setup, bounce sampling.
        Returns (next wave, shadow tuple or None)."""
        c, ds, n = self.config, self.ds, self.n
        alive = state.alive
        hit_valid = hit.valid & alive
        radiance = state.radiance + torch.where(
            (alive & ~hit.valid)[:, None],
            state.throughput * ds.background, 0.0)
        attrs = self.resolver(state.org, state.dirn, hit.t, hit.u, hit.v,
                              hit.tri, hit.inst, hit.slot)
        radiance = radiance + torch.where(
            (hit_valid & state.allow_emission)[:, None],
            state.throughput * attrs.emission, 0.0)

        shadow = None
        if c.use_nee:
            shadow_org = materials.bounce_origin(
                attrs, torch.ones(n, device=self.device))
            wi_l, dist_l, l_over_pdf, l_valid = materials.sample_light(
                ds, shadow_org, sampler, bounce)
            brdf_l = materials.eval_brdf(attrs, -state.dirn, wi_l)
            cos_s = torch.clamp_min(dot(attrs.n_shade, wi_l), 0.0)
            contrib = (state.throughput * brdf_l * cos_s[:, None]
                       * l_over_pdf)
            want = hit_valid & l_valid & (contrib.amax(dim=-1) > 0.0)
            shadow = (
                torch.where(want[:, None], shadow_org, 0.0),
                torch.where(want[:, None], wi_l, 1.0),
                torch.where(want, dist_l * (1.0 - SHADOW_EPS), -1.0),
                contrib,
                want,
            )

        bs = materials.sample_bounce(attrs, -state.dirn, sampler, bounce)
        throughput = torch.where(hit_valid[:, None],
                                 state.throughput * bs.weight,
                                 state.throughput)
        alive = (hit_valid & (bounce < c.max_bounces)
                 & (throughput.amax(dim=-1) > 1e-6))
        rays = state.rays.clone()
        rays[4 + bounce] += alive.sum()
        new = WaveState(
            org=torch.where(hit_valid[:, None],
                            materials.bounce_origin(attrs, bs.offset_sign),
                            0.0),
            dirn=torch.where(hit_valid[:, None], bs.wi, 1.0),
            radiance=radiance,
            throughput=throughput,
            alive=alive,
            allow_emission=bs.is_specular | (not c.use_nee),
            rays=rays,
        )
        return new, shadow

    def occlude(self, state: WaveState, shadow, bounce: int) -> WaveState:
        """Any-hit trace of the shadow rays; unoccluded ones add their
        light contribution."""
        s_org, s_dir, s_tmax, contrib, want = shadow
        n_want = want.sum()
        rays = state.rays.clone()
        rays[1] += n_want
        rays[self.want0 + bounce] += n_want
        occluded = self._call(self.occluders[bounce], rays, s_org, s_dir,
                              s_tmax)
        radiance = state.radiance + torch.where(
            (want & ~occluded)[:, None], contrib, 0.0)
        return state._replace(radiance=radiance, rays=rays)

    def flat_shade(self, state: WaveState, hit) -> WaveState:
        """Flat shading: the hit's albedo, the background on a miss."""
        attrs = self.resolver(state.org, state.dirn, hit.t, hit.u, hit.v,
                              hit.tri, hit.inst, hit.slot)
        radiance = torch.where(hit.valid[:, None], attrs.albedo,
                               self.ds.background)
        return state._replace(radiance=radiance)

    def resolve(self, state: WaveState):
        """Per-pixel sample sums (s0 + s1 + …), tile order → raster."""
        c = self.config
        total = state.radiance.reshape(c.spp_per_batch, self.n_px,
                                       3).sum(dim=0)
        img = torch.zeros((c.width * c.height, 3), dtype=torch.float32,
                          device=self.device)
        img[self.linear] = total
        return img.reshape(c.height, c.width, 3), state.rays

    def __call__(self, cam: Camera, seed: int, sample0: int):
        sampler = self.sampler(seed, sample0)
        state = self.raygen(cam, seed, sample0)
        if self.config.shading_mode == "flat":
            hit, state = self.trace(state, 0)
            return self.resolve(self.flat_shade(state, hit))
        for bounce in range(self.config.max_bounces + 1):
            hit, state = self.trace(state, bounce)
            state, shadow = self.shade(state, hit, sampler, bounce)
            if shadow is not None:
                state = self.occlude(state, shadow, bounce)
        return self.resolve(state)
