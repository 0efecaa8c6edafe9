"""Staged wave loop — port of ``tpurt.render.staged``.

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

The reference's stage programs, with its switches and defaults:

  * ``TPURT_FUSE_STAGES`` (default "1"): ``raygen_trace0``, then a bounce
    trace (``trace``, cut at the bounce's live cap) and ``shade_occlude``
    (shade, then the occlusion trace cut at its shadow cap) a bounce, and
    the per-pixel sums (``resolve``). "0" runs the unfused loop: raygen,
    trace, shade, occlude a bounce.
  * ``TPURT_FUSE_BOUNCES`` (default "0"; a single process, not the sorted
    loop): the whole batch as one program (``whole_batch``), its waves
    uncapped.
  * The sorted loop's ``raygen_trace0``, ``trace_presorted``,
    ``shade_occlude_sorted[_last]`` and ``resolve_sorted``.

On the card each stage program is a CUDA graph (``torch.cuda.CUDAGraph``):
captured once, after one eager warm-up run on a side stream, and
replayed with one launch. ``TPURT_FUSE_STAGES`` only chooses how the
batch is split: the unfused loop's stages (raygen, trace[b], shade[b],
occlude[b], resolve) are graphs too. The renderer's graphs share one
memory pool and are replayed in the order they were captured. What
changes between batches — the camera, the seed and the first sample —
lives in static device buffers that a batch fills before the replays;
the graphs' outputs are static too, so a batch returns copies. The
first batch (or ``prewarm``) runs the warm-up chain, whose results it
returns, and captures each stage beside it; later batches replay. The
stage programs run eagerly where the reference's prewarm makes none
ready (a mesh: each rank's stages; flat shading), under the
``TPURT_CAPTURE_WAVES`` probe (it copies waves to the host), and where
a wave's lists are sized on the host (the pair segments, the grid over
pairs, ``bvh_pair``'s expand, the LBVH walk's compaction: the
intersector's ``host_read``): the renderer records ``graphs = False``
and its ``graph_reason`` when it is built. Everything runs eagerly on
the CPU. The kernel launchers and the tile intersector count launches
and waves in Python (``tpurt_torch.kernels``), which a replay does not
run: each graph records what its capture counted and adds it again on
every replay (``kernels.take_since``, ``kernels.add``);
``chip_smoke.py`` holds each graph's count to the kernel nodes that
libcuda holds for it.

The shade of a wave (``shade``) is one hand-written CUDA kernel
(``kernels/shade.py``, ``csrc/shade.cu``) where the renderer's accel,
textures, shading mode and device allow it (``shade_path``), and
``_shade``'s PyTorch code elsewhere: the CPU, the two-level accel, the
packet BVH, bilinear textures. The kernel hashes each ray's stream from
the input buffers and the ray's own sample and pixel, so the loops
share it and a replay reads the batch's seed.

Two of the reference's probes are carried. ``TPURT_CAPTURE_WAVES=<dir>``
writes the default loop's real waves as ``.npz`` before they are traced:
``bounce{b}_wave.npz`` (``org``, ``dirn``, ``alive``) for b ≥ 1 and
``shadow{b}_wave.npz`` (``org``, ``dirn``, ``tmax``, ``want``), the
reference's names and keys; it forces the default (unsorted, unfused)
loop, as there, and takes a single-process render (a rank holds only its
shard). ``TPURT_DEBUG_STAGES=1`` waits for the device at the end of each
stage's span and prints its wall time as ``    [stage] <name>: X.XXs``
(under fusion the reference's fused names, ``trace[b]`` and
``shade_occlude[b]``). Neither changes the image.

Spans (``tpurt_torch.utils.profiling``, recorded only while the recorder
is on): a batch's ``set_inputs``, each stage program's ``replay:<stage>``
(or ``eager:<stage>``), ``clone`` and ``frame``; ``graphs.capture``
around a capture. Inside the stage programs the steps (``raygen``,
``rng``, ``sort``, ``entries``, ``walk``, ``trace``, ``shade``,
``occlude``, ``sums``) are ``profiling.step``s: spans where the program
runs eagerly, and, while a stage graph is captured, the op-node range
that each step made, which the graph keeps beside its launches and each
replay's span carries, so a device trace's records of one replay can be
told apart by step.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch import kernels, materials
from tpurt_torch.core.camera import Camera, camera_rays, \
    full_frame_pixels_tiled
from tpurt_torch.core.prng import TAG_JITTER, PixelSampler
from tpurt_torch.core.vecmath import dot
from tpurt_torch.kernels import raysort
from tpurt_torch.kernels import shade as shade_kernel
from tpurt_torch.kernels.tilewave import BIG, TILE
from tpurt_torch.render.integrator import (
    SHADOW_EPS,
    make_cutout_closest,
    make_intersectors,
    make_occluder,
    traced,
)
from tpurt_torch.render.intersectors import SceneMeta
from tpurt_torch.scene.device import torch_device
from tpurt_torch.utils import profiling
from tpurt_torch.utils.config import RenderConfig

# stages TPURT_DEBUG_STAGES does not print (the reference prints none)
_SILENT = ("resolve", "whole_batch")


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


def _host_read(fn, n: int) -> str:
    """Why the intersector ``fn`` reads the host on a wave of ``n`` rays
    ("" where it does not, or has no ``host_read``)."""
    probe = getattr(fn, "host_read", None)
    return probe(n) if probe is not None else ""


class StagedRenderer:
    """One sample batch of ``config.spp_per_batch`` samples per pixel on
    ``device``: ``renderer(cam, seed, sample0) -> ((H, W, 3) radiance sum,
    (NCOUNT,) counters)``. The stages are methods so a caller can stop at
    any wave (``chip_smoke.py`` takes the first bounce wave's kernel
    inputs from them). With a ``mesh`` the renderer traces its rank's
    shard and the call returns the world's frame and counters;
    ``shard`` gives the shard's own sums, which ``frame`` merges.

    ``mode`` is the loop the switches chose ("fused", "whole", "sorted",
    "unfused" or "flat"); ``graphs`` whether its stage programs run as
    CUDA graphs (the card, no ``graph_reason`` and the ``graphs``
    keyword not False); ``graph_reason`` why the path's stage programs
    run eagerly on the card ("" where nothing keeps them eager);
    ``shade_path`` whether one CUDA kernel shades each wave ("cuda") or
    the PyTorch code of ``_shade`` does ("plain"), and ``shade_reason``
    why the latter ("" on the kernel path; ``kernels.shade.shade_path``)."""

    def __init__(self, ds, accel, *, meta: SceneMeta, config: RenderConfig,
                 device, mesh=None, graphs: bool = True):
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
        # the batch's inputs, filled before each batch: the camera
        # (position, look_at, up, vfov), the seed and the first sample
        self.cam_buf = torch.zeros(10, dtype=torch.float32, device=device)
        self.seed_buf = torch.zeros((), dtype=torch.int64, device=device)
        self.sample0_buf = torch.zeros((), dtype=torch.int64, device=device)

        # the reference's switches and probes (module docstring), read
        # when built
        self.capture = os.environ.get("TPURT_CAPTURE_WAVES") or None
        self.debug = os.environ.get("TPURT_DEBUG_STAGES") == "1"
        if self.capture and mesh is not None:
            raise ValueError("TPURT_CAPTURE_WAVES captures a single-process "
                             "render: a rank holds only its shard's waves")
        fuse = os.environ.get("TPURT_FUSE_STAGES", "1") == "1"
        whole = os.environ.get("TPURT_FUSE_BOUNCES", "0") == "1"
        if self.capture:
            fuse = whole = False
        self.sorted = (
            mesh is None and not self.capture and hasattr(accel, "cluster_lo")
            and config.shading_mode != "flat"
            and os.environ.get("TPURT_SORTED_WAVE",
                               "1" if config.sorted_wave else "0") == "1")
        if config.shading_mode == "flat":
            self.mode = "flat"
        elif self.sorted:
            self.mode = "sorted"
        elif whole and mesh is None:
            self.mode = "whole"
        else:
            self.mode = "fused" if fuse else "unfused"

        # one intersector per wave kind and cap (caps come from measured
        # tables; alive rays past a cap are counted as live overflow).
        # Alpha-tested scenes wrap each in its cut-out loop; opaque scenes
        # keep the intersector itself. ``reads`` collects the host reads
        # of the waves they will trace.
        reads = []

        def closest(wave, n_wave, live_cap=0):
            fn = make_intersectors(ds, accel, meta=meta, config=config,
                                   wave=wave, lean=True,
                                   live_cap=live_cap)[0]
            reads.append(_host_read(fn, n_wave))
            return make_cutout_closest(ds, accel, fn, meta=meta)

        def occluder(n_wave, shadow_cap, wave="bounce"):
            fn, any_hit = make_intersectors(
                ds, accel, meta=meta, config=config, wave=wave,
                lean=True, shadow_live_cap=shadow_cap)
            reads.append(_host_read(any_hit, n_wave))
            return make_occluder(ds, accel, fn, any_hit, meta=meta)

        if self.sorted:
            # the sorted waves: the intersectors neither sort nor cut
            # them; the loop cuts a sorted wave at its cap, rounded up to
            # whole tiles, where that is below the wave's size
            self.sorted_caps, sizes = [], [n]
            for b in range(mb):
                cap = int(config.live_caps[b]) if b < len(
                    config.live_caps) else 0
                cap = -(-cap // TILE) * TILE if cap > 0 else 0
                cap = cap if cap < sizes[-1] else 0
                sizes.append(cap or sizes[-1])
                self.sorted_caps.append(cap)
            self.closest = [closest("primary", n)] + [
                closest("presorted", sizes[b]) for b in range(1, mb + 1)]
            self.occluders = [occluder(sizes[b], 0, "presorted")
                              for b in range(mb + 1)]
            self.lo_all = accel.cluster_lo.amin(dim=0)
            self.hi_all = accel.cluster_hi.amax(dim=0)
            # raster pixel id → its position in the tile order
            self.pos_of_pix = torch.empty(w * h, dtype=torch.int64,
                                          device=device)
            self.pos_of_pix[self.linear] = torch.arange(n_px, device=device)
        else:
            # the whole batch traces full waves, as the reference's does
            uncapped = self.mode == "whole"
            live_caps = _caps(() if uncapped else config.live_caps, mb, n)
            shadow_caps = _caps(() if uncapped else config.shadow_caps,
                                mb + 1, n)
            self.closest = [closest("primary", n)] + [
                closest("bounce", n, live_caps[b - 1])
                for b in range(1, mb + 1)]
            self.occluders = [occluder(n, cap) for cap in shadow_caps]
        self.resolver = materials.make_resolver(
            ds, accel, texture_filter=config.texture_filter)
        # the shade of a wave: the CUDA kernel (kernels/shade.py) or the
        # PyTorch path (``_shade``), and why the latter
        self.shade_path, self.shade_reason = shade_kernel.shade_path(
            ds, accel, config, device)
        self.shade_tables = (shade_kernel.shade_tables(ds, accel)
                             if self.shade_path == "cuda" else None)

        # why the stage programs run eagerly on the card, decided here:
        # the wave probe, where the reference's prewarm makes none ready,
        # or a wave's host read
        if self.capture:
            self.graph_reason = ("TPURT_CAPTURE_WAVES copies the waves to "
                                 "the host")
        elif mesh is not None:
            self.graph_reason = ("a mesh: the reference's prewarm makes no "
                                 "stage ready there")
        elif self.mode == "flat":
            self.graph_reason = ("flat shading: the reference's prewarm "
                                 "makes no stage ready")
        else:
            self.graph_reason = next((r for r in reads if r), "")
        self.graphs = (bool(graphs) and device.type == "cuda"
                       and not self.graph_reason)
        # [(CUDAGraph, the launches and waves a replay adds
        # (kernels.take_since), its op nodes and its steps' node ranges:
        # profiling.NodeMarks.nodes)]
        self._graphs = None
        self._static_out = None  # the last graph's outputs

    # --- the batch's inputs ------------------------------------------------

    def set_inputs(self, cam: Camera, seed, sample0) -> None:
        """Fill the input buffers with the batch's camera, seed and first
        sample (the shard's: ``sample_offset`` added)."""
        with profiling.span("set_inputs"):
            packed = torch.cat([torch.as_tensor(f).to("cpu", torch.float32)
                                .reshape(-1) for f in cam])
            self.cam_buf.copy_(packed)
            self.seed_buf.fill_(int(seed))
            self.sample0_buf.fill_(int(sample0) + self.sample_offset)

    def camera(self) -> Camera:
        """The camera of the input buffer (views of it)."""
        b = self.cam_buf
        return Camera(b[0:3], b[3:6], b[6:9], b[9])

    # --- the stages ---------------------------------------------------------

    def _stage(self, kind: str, name: str, nodes=None, quiet=False):
        """The span of stage program ``name`` (``kind``: "replay" of its
        graph, whose ``nodes`` the span carries, or "eager"); under
        ``TPURT_DEBUG_STAGES`` (not ``quiet``) it waits for the device at
        its end and prints its wall time."""
        if not self.debug or quiet or name in _SILENT:
            return profiling.span(f"{kind}:{name}", nodes=nodes)
        return self._debug_stage(f"{kind}:{name}", name, nodes)

    @contextlib.contextmanager
    def _debug_stage(self, span: str, name: str, nodes):
        t0 = time.perf_counter()
        with profiling.span(span, nodes=nodes):
            yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        print(f"    [stage] {name}: {time.perf_counter() - t0:.2f}s",
              flush=True)

    def _capture(self, name: str, **arrays) -> None:
        """``TPURT_CAPTURE_WAVES``: the wave's arrays as ``<dir>/<name>.npz``
        (host copies)."""
        os.makedirs(self.capture, exist_ok=True)
        np.savez(os.path.join(self.capture, name + ".npz"),
                 **{k: v.cpu().numpy() for k, v in arrays.items()})

    def sampler(self, seed, sample0) -> PixelSampler:
        return PixelSampler.make(seed, sample0 + self.ds_r, self.pid)

    def raygen(self, cam: Camera, seed, sample0) -> WaveState:
        with profiling.step("raygen"):
            return self._raygen(cam, seed, sample0)

    def _raygen(self, cam: Camera, seed, sample0) -> WaveState:
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
        with profiling.step("trace"):
            rays = state.rays.clone()
            rays[0] += state.alive.sum()
            tmax = torch.where(state.alive, math.inf, -1.0)
            hit = traced(self.closest[bounce], rays, state.org, state.dirn,
                         tmax)
            return hit, state._replace(rays=rays)

    def shade(self, state: WaveState, hit, sampler, bounce: int):
        """Miss/emission events, NEE shadow-ray setup, bounce sampling.
        Returns (next wave, shadow tuple or None). ``sampler``: a
        PixelSampler, or None for the batch's own streams (the input
        buffers' seed and first sample, each ray's sample and pixel).
        On the ``shade_path`` "cuda" one kernel shades the wave and
        hashes the streams itself (launch key ``shade``); else the
        PyTorch code does, counted as ``shade.plain`` beside the
        launches."""
        with profiling.step("shade"):
            if self.shade_path == "cuda":
                c = self.config
                return shade_kernel.shade_cuda(
                    self.shade_tables, state, hit, bounce=bounce,
                    max_bounces=c.max_bounces, use_nee=c.use_nee,
                    shadow_eps=SHADOW_EPS, seed=self.seed_buf,
                    sample0=self.sample0_buf,
                    base=None if sampler is None else sampler.base)
            kernels.count("shade.plain")
            if sampler is None:
                sampler = PixelSampler.make(
                    self.seed_buf, self.sample0_buf + state.sample,
                    state.pix)
            return self._shade(state, hit, sampler, bounce)

    def _shade(self, state: WaveState, hit, sampler, bounce: int):
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
        with profiling.step("occlude"):
            s_org, s_dir, s_tmax, contrib, want = shadow
            n_want = want.sum()
            rays = state.rays.clone()
            rays[1] += n_want
            rays[self.want0 + bounce] += n_want
            occluded = traced(self.occluders[bounce], rays, s_org, s_dir,
                              s_tmax)
            radiance = state.radiance + torch.where(
                (want & ~occluded)[:, None], contrib, 0.0)
            return state._replace(radiance=radiance, rays=rays)

    def flat_shade(self, state: WaveState, hit) -> WaveState:
        """Flat shading: the hit's albedo, the background on a miss."""
        with profiling.step("shade"):
            attrs = self.resolver(state.org, state.dirn, hit.t, hit.u,
                                  hit.v, hit.tri, hit.inst, hit.slot)
            radiance = torch.where(hit.valid[:, None], attrs.albedo,
                                   self.ds.background)
            return state._replace(radiance=radiance)

    def pixel_sums(self, state: WaveState):
        """The shard's per-pixel sample sums (s0 + s1 + …) in tile order,
        and its counters."""
        with profiling.step("sums"):
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
        with profiling.step("sort"):
            tmv = torch.where(state.alive, BIG, -1.0)
            perm = raysort.sort_perm(state.org, state.dirn, tmv,
                                     self.lo_all, self.hi_all)
            return WaveState(*(f[perm] for f in state[:-1]), rays=state.rays)

    def resolve_sorted(self, state: WaveState, tails):
        """Every ray (the wave's and the cut tails' (radiance, pix,
        sample)) back to its position by its carried ids, then the
        positional resolve."""
        with profiling.step("sums"):
            rad = torch.cat([state.radiance] + [t[0] for t in tails])
            pix = torch.cat([state.pix] + [t[1] for t in tails])
            smp = torch.cat([state.sample] + [t[2] for t in tails])
            radiance = torch.empty_like(rad)
            radiance[smp * self.n_px + self.pos_of_pix[pix]] = rad
            return self.pixel_sums(state._replace(radiance=radiance))

    # --- the stage programs (each reads the input buffers) ----------------

    def raygen_trace0(self):
        """raygen and the primary trace: (hit, wave)."""
        state = self.raygen(self.camera(), self.seed_buf, self.sample0_buf)
        return self.trace(state, 0)

    def shade_occlude(self, state: WaveState, hit, sampler,
                      bounce: int) -> WaveState:
        """Shade, then the occlusion trace of its shadow rays."""
        state, shadow = self.shade(state, hit, sampler, bounce)
        if shadow is not None:
            state = self.occlude(state, shadow, bounce)
        return state

    def shade_occlude_sorted(self, state: WaveState, hit, bounce: int):
        """The sorted loop's shade and occlusion, each ray drawing from
        its own (sample, pixel) stream; then, but after the last bounce,
        the next wave sorted and cut at its cap: (wave, the cut tail's
        (radiance, pix, sample) or None)."""
        state = self.shade_occlude(state, hit, None, bounce)
        if bounce == self.config.max_bounces:
            return state, None
        state = self.sort_wave(state)
        cap = self.sorted_caps[bounce]
        if not cap:
            return state, None
        tail = (state.radiance[cap:], state.pix[cap:], state.sample[cap:])
        rays = state.rays.clone()
        rays[3] += state.alive[cap:].sum()
        return WaveState(*(f[:cap] for f in state[:-1]), rays=rays), tail

    def programs(self):
        """The active loop's stage programs in order, as (name, fn): each
        fn takes the carry of the one before (a dict; None for the
        first) and returns its own; the last returns (per-pixel sums,
        counters). The unfused loop splits a bounce into trace, shade
        and occlude (and writes the ``TPURT_CAPTURE_WAVES`` probe's
        files); flat shading traces the primary wave and resolves its
        albedo; the whole batch is the fused chain as one program (over
        uncapped intersectors)."""
        mb = self.config.max_bounces

        def batch_sampler():
            # the PyTorch shade's streams, made once a batch; the sorted
            # loop's rays carry theirs, and the kernel hashes its own
            if self.sorted or self.shade_path == "cuda":
                return None
            return self.sampler(self.seed_buf, self.sample0_buf)

        def raygen(c):
            state = self.raygen(self.camera(), self.seed_buf,
                                self.sample0_buf)
            return dict(state=state, sampler=batch_sampler())

        def first(c):
            hit, state = self.raygen_trace0()
            return dict(hit=hit, state=state, sampler=batch_sampler(),
                        tails=())

        def trace(c, b):
            if self.capture and b > 0:
                s = c["state"]
                self._capture(f"bounce{b}_wave", org=s.org, dirn=s.dirn,
                              alive=s.alive)
            hit, state = self.trace(c["state"], b)
            return dict(c, hit=hit, state=state)

        def shade(c, b):
            state, shadow = self.shade(c["state"], c["hit"], c["sampler"], b)
            return dict(c, hit=None, state=state, shadow=shadow)

        def occlude(c, b):
            shadow = c["shadow"]
            if self.capture:
                self._capture(f"shadow{b}_wave", org=shadow[0],
                              dirn=shadow[1], tmax=shadow[2], want=shadow[4])
            return dict(c, shadow=None,
                        state=self.occlude(c["state"], shadow, b))

        def shade_occlude(c, b):
            return dict(c, hit=None, state=self.shade_occlude(
                c["state"], c["hit"], c["sampler"], b))

        def shade_occlude_sorted(c, b):
            state, tail = self.shade_occlude_sorted(c["state"], c["hit"], b)
            tails = c["tails"] + ((tail,) if tail is not None else ())
            return dict(c, hit=None, state=state, tails=tails)

        def sums(c):
            return self.pixel_sums(c["state"])

        if self.mode == "flat":
            return [("raygen", lambda c: dict(state=self.raygen(
                        self.camera(), self.seed_buf, self.sample0_buf))),
                    ("trace[0]", lambda c: trace(c, 0)),
                    ("resolve", lambda c: self.pixel_sums(
                        self.flat_shade(c["state"], c["hit"])))]
        if self.mode == "unfused":
            out = [("raygen", raygen)]
            for b in range(mb + 1):
                out += [(f"trace[{b}]", lambda c, b=b: trace(c, b)),
                        (f"shade[{b}]", lambda c, b=b: shade(c, b))]
                if self.config.use_nee:  # else shade makes no shadow rays
                    out.append((f"occlude[{b}]",
                                lambda c, b=b: occlude(c, b)))
            return out + [("resolve", sums)]

        so = shade_occlude_sorted if self.sorted else shade_occlude
        out = [("trace[0]", first)]
        for b in range(mb + 1):
            if b:
                out.append((f"trace[{b}]", lambda c, b=b: trace(c, b)))
            out.append((f"shade_occlude[{b}]", lambda c, b=b: so(c, b)))
        if self.sorted:
            out.append(("resolve", lambda c: self.resolve_sorted(
                c["state"], c["tails"])))
        else:
            out.append(("resolve", sums))
        if self.mode != "whole":
            return out

        def whole_batch(c):
            for _, fn in out:
                c = fn(c)
            return c

        return [("whole_batch", whole_batch)]

    # --- the CUDA graphs ----------------------------------------------------

    def _capture_graphs(self, quiet=False):
        """Each stage program run eagerly on a side stream (the warm-up:
        lazy module loads and the kernels' one-time attributes happen
        outside any capture), then captured into a graph of the shared
        pool on the warm-up chain's twin of static tensors, its steps'
        node ranges marked (``profiling.node_marks``). Returns the warm-up
        chain's outputs: this batch's result. ``quiet``: no
        ``TPURT_DEBUG_STAGES`` lines (prewarm)."""
        dev = self.device
        pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graphs, warm, static, pool_bytes = [], None, None, 0
        with profiling.span("graphs.capture"), torch.cuda.stream(side):
            for name, fn in self.programs():
                with self._stage("eager", name, quiet=quiet):
                    warm = fn(warm)
                graph = torch.cuda.CUDAGraph()
                before = kernels.counts()
                with torch.cuda.graph(graph, pool=pool):
                    stream = torch.cuda.current_stream(dev).cuda_stream
                    reserved = torch.cuda.memory_reserved(dev)
                    with profiling.node_marks(
                            profiling.CaptureOpNodes(stream)) as marks:
                        static = fn(static)
                    pool_bytes += torch.cuda.memory_reserved(dev) - reserved
                # a capture launches nothing: its counts go to the replays
                graphs.append((graph, kernels.take_since(before),
                               marks.nodes()))
        profiling.count("graphs.pool_bytes", pool_bytes)
        current = torch.cuda.current_stream(dev)
        current.wait_stream(side)
        for t in warm:  # made on the side stream, read on this one
            t.record_stream(current)
        self._graphs, self._static_out = graphs, static
        return warm

    def prewarm(self, cam: Camera, seed=0, sample0=0) -> int:
        """Make every stage program of the active loop ready before the
        first batch: load the kernel library, warm up and capture each
        graph (``cam``, ``seed`` and ``sample0`` are the warm-up batch's
        inputs; its result is dropped). Returns how many graphs it
        captured: 0 where the reference's prewarm makes none ready (the
        CPU, a mesh, flat shading) and on the paths that run eagerly."""
        if (self.device.type != "cuda" or self.mesh is not None
                or self.mode == "flat"):
            return 0
        from tpurt_torch.kernels import cuda_build

        cuda_build.load()
        if not self.graphs:
            return 0
        if self._graphs is None:
            self.set_inputs(cam, seed, sample0)
            self._capture_graphs(quiet=True)
        return len(self._graphs)

    # --- a batch ------------------------------------------------------------

    def shard(self, cam: Camera, seed: int, sample0: int):
        """The batch's samples [sample0, sample0 + spp) on this shard:
        (its per-pixel sums in tile order, pads included; its counters).
        A sample shard draws its own window of them."""
        self.set_inputs(cam, seed, sample0)
        programs = self.programs()
        if not self.graphs:
            carry = None
            for name, fn in programs:
                with self._stage("eager", name):
                    carry = fn(carry)
            return carry
        if self._graphs is None:
            return self._capture_graphs()
        for (name, _), (graph, counted, nodes) in zip(programs,
                                                       self._graphs):
            with self._stage("replay", name, nodes):
                graph.replay()
            kernels.add(counted)
        # the next replay overwrites the static outputs
        with profiling.span("clone"):
            return tuple(t.clone() for t in self._static_out)

    def __call__(self, cam: Camera, seed: int, sample0: int):
        total, rays = self.shard(cam, seed, sample0)
        with profiling.span("frame"):
            return self.frame(total, rays)


def make_staged_renderer(ds, accel, *, meta: SceneMeta, config: RenderConfig,
                         mesh=None, device="cuda") -> StagedRenderer:
    """The reference's factory, with its keywords: the staged loop's batch
    ``render_batch(cam, seed, sample0) -> ((H, W, 3) sum, counters)`` on
    ``device`` (the card unless the caller asks for the CPU), with its
    ``prewarm(cam, seed, sample0)``."""
    return StagedRenderer(ds, accel, meta=meta, config=config,
                          device=device, mesh=mesh)
