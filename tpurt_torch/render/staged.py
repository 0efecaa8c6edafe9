"""Staged wave loop — port of the single-device path of
``tpurt.render.staged``, as one eager Python loop.

Per sample batch: raygen → for each bounce: closest trace, shade with NEE
setup, occlusion trace → resolve (tile order → raster). Flat shading
(hello_triangle) traces the primary wave only and resolves the albedo
of each hit. The estimator is
the reference's: same RNG tags, same masks, same event order, the same
counter layout.

The sorted-wave variant (``config.sorted_wave`` or ``TPURT_SORTED_WAVE``,
on tile and pair accels, shading not flat) permutes the wave once a
bounce, after its shading, into the octant + origin-Morton order of the
next trace with dead rays last, and traces it as it lies
(``wave="presorted"``: no forward or restore sort in the intersector).
Each ray carries its pixel and sample ids, so its random stream and its
pixel follow it; with a live cap the wave is cut after the sort (an
alive ray past the cap counts as live overflow and ``render_scene``
re-renders uncapped), and the resolve puts every ray back in its
position before the per-pixel sums, which it then takes in the order of
the default loop: the two loops' images are equal.

On a ("sample", "tile") mesh (``tpurt_torch.parallel``) the renderer is
one shard of the batch, as the reference's shard-mapped stages are: the
pixel stream is padded to a multiple of the tile shards (pad pixels
trace at (0, 0) and count as rays), tile shard t traces chunk t of it,
each of its samples in turn, and sample shard s draws the samples s·spp
+ [0, spp) of the batch's window. The resolve gathers every shard's
per-pixel sums, adds the sample shards in fixed order, puts the tile
chunks back in shard order, drops the pads and scatters to raster: every
rank ends with the whole frame and the world's counters. The sorted-wave
variant stays single-device, as in the reference.

Two of the reference's probes are carried. ``TPURT_CAPTURE_WAVES=<dir>``
writes the default loop's real waves as ``.npz`` before they are traced:
``bounce{b}_wave.npz`` (``org``, ``dirn``, ``alive``) for b ≥ 1 and
``shadow{b}_wave.npz`` (``org``, ``dirn``, ``tmax``, ``want``), the
reference's names and keys; it forces the default (unsorted) loop, as
there, and takes a single-process render (a rank holds only its shard).
``TPURT_DEBUG_STAGES=1`` waits for the device after each stage and
prints its wall time as ``    [stage] <name>: X.XXs``. Neither changes
the image.

The reference's per-stage executables, AOT cache and stage fusion
variants exist to work around a TPU backend and are not carried.
"""

from __future__ import annotations

import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch import materials
from tpurt_torch.core.camera import Camera, camera_rays, \
    full_frame_pixels_tiled
from tpurt_torch.core.prng import TAG_JITTER, PixelSampler
from tpurt_torch.core.vecmath import dot
from tpurt_torch.kernels.tilewave import BIG, TILE, _octant_sort_keys
from tpurt_torch.render.integrator import (
    SHADOW_EPS,
    make_cutout_closest,
    make_intersectors,
    make_occluder,
    traced,
)
from tpurt_torch.render.intersectors import SceneMeta
from tpurt_torch.scene.device import torch_device
from tpurt_torch.utils.config import RenderConfig


class WaveState(NamedTuple):
    """Inter-stage SoA path state (flattened samples × pixels)."""

    org: torch.Tensor  # (N, 3)
    dirn: torch.Tensor  # (N, 3)
    radiance: torch.Tensor  # (N, 3)
    throughput: torch.Tensor  # (N, 3)
    alive: torch.Tensor  # (N,) bool
    allow_emission: torch.Tensor  # (N,) bool
    pix: torch.Tensor  # (N,) int64 linear pixel id (the RNG pixel key)
    sample: torch.Tensor  # (N,) int64 within-batch sample index
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
    inputs from them). With a ``mesh`` the renderer traces its rank's
    shard and the call returns the world's frame and counters;
    ``shard`` gives the shard's own sums, which ``frame`` merges."""

    def __init__(self, ds, accel, *, meta: SceneMeta, config: RenderConfig,
                 device, mesh=None):
        self.ds = ds
        self.config = config
        self.mesh = mesh
        self.device = device = torch_device(device)
        w, h = config.width, config.height
        spp = config.spp_per_batch
        mb = config.max_bounces
        self.ncount, self.want0 = counter_layout(mb)
        px, py = full_frame_pixels_tiled(w, h)
        self.n_px = n_px = px.shape[0]
        lin = py.to(torch.int64) * w + px.to(torch.int64)
        self.linear = lin.to(device)  # tile order → raster index
        # the shard's pixel chunk of the stream padded to a multiple of
        # the tile shards (pads at (0, 0)), and its sample offset
        n_tile = mesh.n_tile if mesh is not None else 1
        pad = (-n_px) % n_tile
        self.n_local = n_local = (n_px + pad) // n_tile
        self.sample_offset = mesh.sample_id * spp if mesh is not None else 0
        t0 = (mesh.tile_id if mesh is not None else 0) * n_local
        px, py, lin = (torch.cat([x, x.new_zeros(pad)])[t0:t0 + n_local]
                       for x in (px, py, lin))
        self.n = n = n_local * spp
        self.px = px.repeat(spp).to(device)
        self.py = py.repeat(spp).to(device)
        self.pid = lin.repeat(spp).to(device)  # RNG pixel key per ray
        # within-batch sample index of every ray
        self.ds_r = torch.arange(spp, dtype=torch.int64).repeat_interleave(
            n_local).to(device)

        # one intersector per wave kind and cap (caps come from measured
        # tables; alive rays past a cap are counted as live overflow).
        # Alpha-tested scenes wrap each in its cut-out loop; opaque scenes
        # keep the intersector itself.
        def closest(wave, live_cap=0):
            fn = make_intersectors(ds, accel, meta=meta, config=config,
                                   wave=wave, lean=True,
                                   live_cap=live_cap)[0]
            return make_cutout_closest(ds, accel, fn, meta=meta)

        def occluder(shadow_cap, wave="bounce"):
            fn, any_hit = make_intersectors(
                ds, accel, meta=meta, config=config, wave=wave,
                lean=True, shadow_live_cap=shadow_cap)
            return make_occluder(ds, accel, fn, any_hit, meta=meta)

        # the reference's probes (module docstring), read when built
        self.capture = os.environ.get("TPURT_CAPTURE_WAVES") or None
        self.debug = os.environ.get("TPURT_DEBUG_STAGES") == "1"
        self._mark = 0.0
        if self.capture and mesh is not None:
            raise ValueError("TPURT_CAPTURE_WAVES captures a single-process "
                             "render: a rank holds only its shard's waves")
        self.sorted = (
            mesh is None and not self.capture and hasattr(accel, "cluster_lo")
            and config.shading_mode != "flat"
            and os.environ.get("TPURT_SORTED_WAVE",
                               "1" if config.sorted_wave else "0") == "1")
        if self.sorted:
            # the sorted waves: the intersectors neither sort nor cut
            # them; the loop cuts a sorted wave at its cap, rounded up to
            # whole tiles, where that is below the wave's size
            self.closest = [closest("primary")] + [closest("presorted")] * mb
            self.occluders = [occluder(0, "presorted")] * (mb + 1)
            self.sorted_caps = []
            n_cur = n
            for b in range(mb):
                cap = int(config.live_caps[b]) if b < len(
                    config.live_caps) else 0
                cap = -(-cap // TILE) * TILE if cap > 0 else 0
                cap = cap if cap < n_cur else 0
                n_cur = cap or n_cur
                self.sorted_caps.append(cap)
            self.lo_all = accel.cluster_lo.amin(dim=0)
            self.hi_all = accel.cluster_hi.amax(dim=0)
            # raster pixel id → its position in the tile order
            self.pos_of_pix = torch.empty(w * h, dtype=torch.int64,
                                          device=device)
            self.pos_of_pix[self.linear] = torch.arange(n_px, device=device)
        else:
            live_caps = _caps(config.live_caps, mb, n)
            self.closest = [closest("primary")] + [
                closest("bounce", live_caps[b - 1])
                for b in range(1, mb + 1)]
            self.occluders = [occluder(cap) for cap in
                              _caps(config.shadow_caps, mb + 1, n)]
        self.resolver = materials.make_resolver(
            ds, accel, texture_filter=config.texture_filter)

    def _stage(self, name: str) -> None:
        """``TPURT_DEBUG_STAGES``: wait for the device, then print the
        stage's wall time since the previous mark."""
        if not self.debug:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        print(f"    [stage] {name}: {now - self._mark:.2f}s", flush=True)
        self._mark = now

    def _capture(self, name: str, **arrays) -> None:
        """``TPURT_CAPTURE_WAVES``: the wave's arrays as ``<dir>/<name>.npz``
        (host copies)."""
        os.makedirs(self.capture, exist_ok=True)
        np.savez(os.path.join(self.capture, name + ".npz"),
                 **{k: v.cpu().numpy() for k, v in arrays.items()})

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
            pix=self.pid,
            sample=self.ds_r,
            rays=torch.zeros(self.ncount, dtype=torch.float64, device=dev),
        )

    def trace(self, state: WaveState, bounce: int):
        """Closest-hit trace of the wave (one intersector call)."""
        rays = state.rays.clone()
        rays[0] += state.alive.sum()
        tmax = torch.where(state.alive, math.inf, -1.0)
        hit = traced(self.closest[bounce], rays, state.org, state.dirn, tmax)
        return hit, state._replace(rays=rays)

    def shade(self, state: WaveState, hit, sampler, bounce: int):
        """Miss/emission events, NEE shadow-ray setup, bounce sampling.
        Returns (next wave, shadow tuple or None)."""
        c, ds = self.config, self.ds
        n = state.org.shape[0]
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
            pix=state.pix,
            sample=state.sample,
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
        occluded = traced(self.occluders[bounce], rays, s_org, s_dir, s_tmax)
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

    def pixel_sums(self, state: WaveState):
        """The shard's per-pixel sample sums (s0 + s1 + …) in tile order,
        and its counters."""
        total = state.radiance.reshape(self.config.spp_per_batch,
                                       self.n_local, 3).sum(dim=0)
        return total, state.rays

    def frame(self, total, rays):
        """Per-pixel sums in tile order → ((H, W, 3) raster image,
        counters). On a mesh, the shard's sums and counters are first
        merged with every rank's (``RenderMesh.merge``); the pads, last
        in the stream, are dropped before the scatter."""
        c = self.config
        if self.mesh is not None:
            total, rays = self.mesh.merge(total, rays)
        img = torch.zeros((c.width * c.height, 3), dtype=torch.float32,
                          device=self.device)
        img[self.linear] = total[:self.n_px]
        return img.reshape(c.height, c.width, 3), rays

    def resolve(self, state: WaveState):
        """The wave's per-pixel sums → (raster image, counters)."""
        return self.frame(*self.pixel_sums(state))

    def sort_wave(self, state: WaveState) -> WaveState:
        """The wave in the next trace's coherence order (octant, then
        origin Morton; dead rays last), every per-ray field along."""
        tmv = torch.where(state.alive, BIG, -1.0)
        keys = _octant_sort_keys(state.org, state.dirn, tmv, self.lo_all,
                                 self.hi_all)
        perm = torch.sort(keys, stable=True).indices
        return WaveState(*(f[perm] for f in state[:-1]), rays=state.rays)

    def resolve_sorted(self, state: WaveState, tails):
        """Every ray (the wave's and the cut tails' (radiance, pix,
        sample)) back to its position by its carried ids, then the
        positional resolve."""
        rad = torch.cat([state.radiance] + [t[0] for t in tails])
        pix = torch.cat([state.pix] + [t[1] for t in tails])
        smp = torch.cat([state.sample] + [t[2] for t in tails])
        radiance = torch.empty_like(rad)
        radiance[smp * self.n_px + self.pos_of_pix[pix]] = rad
        return self.pixel_sums(state._replace(radiance=radiance))

    def _sorted_batch(self, cam: Camera, seed: int, sample0: int):
        mb = self.config.max_bounces
        state = self.raygen(cam, seed, sample0)
        self._stage("raygen")
        tails = []
        for bounce in range(mb + 1):
            hit, state = self.trace(state, bounce)
            self._stage(f"trace[{bounce}]")
            # the stream of each ray's own (sample, pixel)
            sampler = PixelSampler.make(seed, sample0 + state.sample,
                                        state.pix)
            state, shadow = self.shade(state, hit, sampler, bounce)
            self._stage(f"shade[{bounce}]")
            if shadow is not None:
                state = self.occlude(state, shadow, bounce)
                self._stage(f"occlude[{bounce}]")
            if bounce == mb:
                break
            state = self.sort_wave(state)
            cap = self.sorted_caps[bounce]
            if cap:
                tails.append((state.radiance[cap:], state.pix[cap:],
                              state.sample[cap:]))
                rays = state.rays.clone()
                rays[3] += state.alive[cap:].sum()
                state = WaveState(*(f[:cap] for f in state[:-1]), rays=rays)
        return self.resolve_sorted(state, tails)

    def shard(self, cam: Camera, seed: int, sample0: int):
        """The batch's samples [sample0, sample0 + spp) on this shard:
        (its per-pixel sums in tile order, pads included; its counters).
        A sample shard draws its own window of them."""
        sample0 = sample0 + self.sample_offset
        self._mark = time.perf_counter()
        if self.config.shading_mode == "flat":
            state = self.raygen(cam, seed, sample0)
            self._stage("raygen")
            hit, state = self.trace(state, 0)
            self._stage("trace[0]")
            return self.pixel_sums(self.flat_shade(state, hit))
        if self.sorted:
            return self._sorted_batch(cam, seed, sample0)
        sampler = self.sampler(seed, sample0)
        state = self.raygen(cam, seed, sample0)
        self._stage("raygen")
        for bounce in range(self.config.max_bounces + 1):
            if self.capture and bounce > 0:
                self._capture(f"bounce{bounce}_wave", org=state.org,
                              dirn=state.dirn, alive=state.alive)
            hit, state = self.trace(state, bounce)
            self._stage(f"trace[{bounce}]")
            state, shadow = self.shade(state, hit, sampler, bounce)
            self._stage(f"shade[{bounce}]")
            if shadow is not None:
                if self.capture:
                    self._capture(f"shadow{bounce}_wave", org=shadow[0],
                                  dirn=shadow[1], tmax=shadow[2],
                                  want=shadow[4])
                state = self.occlude(state, shadow, bounce)
                self._stage(f"occlude[{bounce}]")
        return self.pixel_sums(state)

    def __call__(self, cam: Camera, seed: int, sample0: int):
        return self.frame(*self.shard(cam, seed, sample0))


def make_staged_renderer(ds, accel, *, meta: SceneMeta, config: RenderConfig,
                         mesh=None, device="cuda") -> StagedRenderer:
    """The reference's factory, with its keywords: the staged loop's batch
    ``render_batch(cam, seed, sample0) -> ((H, W, 3) sum, counters)`` on
    ``device`` (the card unless the caller asks for the CPU)."""
    return StagedRenderer(ds, accel, meta=meta, config=config,
                          device=device, mesh=mesh)
