#!/usr/bin/env python3
"""Smoke run of tpurt_torch's main paths on one CUDA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and prints no result:

  1. device   — require CUDA; print the card's name and the nvidia-smi
                name/power-limit line;
  2. build    — compile the CUDA kernels from tpurt_torch/csrc with nvcc
                (one process per source, started together) and print the
                register and spill lines;
  3. kernels  — run each kernel wrapper on the waves its main path gives
                it and hold the result against its plain PyTorch version
                on the same inputs: the entry build (K2) and the exact
                mask (K3, both outputs) bit-equal; the tile loop (K1, each
                mode) and the grid over pairs (K4) against the plain
                version's exact walk (exact_boxes=True: unpadded boxes
                far-limited by the running best t, as the kernels prune)
                with the slot equal on ≥ 99.99% of live rays, bt within
                1e-6 relative and the instance equal on those (K4 any-hit:
                no occlusion flag different), logging how many slots the
                padded plain walk would differ in; the pair test (K6)
                bit-equal on all four outputs; the packet walk (K5)
                bit-equal on all four outputs and its group counters over
                a 65,536-ray slice; K4's and K5's registers and share of
                their bound logged. Waves: the first
                bounce and shadow waves of a bunny 800×600 × 8 spp batch
                (K2, K3, K1 flat; K1's pair segments over the bunny config's
                256-tile chunks, TPURT_ENTRY_ROWS=0; K4 over its chunks at
                the config's pair budgets, TPURT_PAIR_LOOP=0; one launch a
                wave, as the main path launches them); the pair
                lists of its primary and first shadow waves (K6); its
                primary, bounce and shadow waves through the bunny's
                packet BVH (K5); of a sponza 1920×1080 × 2 spp batch
                through supercluster entries (K2 over the 414 superboxes,
                K1 two-level + sc) and through per-cluster entries (K2
                over the 2430 instance-cluster boxes, K1 two-level); the
                primary and first shadow waves of a cornell 512×512 ×
                16 spp batch (K1 all-pairs, K4 all-pairs). K1 is also held
                to the exact walk on edge-case lists cut from those waves
                (a tile of 0 entries, 1 entry, an odd count, a full row,
                and a far break right after a fetch ahead), flat and as
                pair segments (bunny), two-level with per-cluster and
                supercluster entries (sponza), closest and lean; K4 on
                edge-case pair lists cut from the bunny's (0 pairs, 1, an
                odd count, the longest list, and slices that vote
                themselves done right after a fetch ahead), closest and
                any-hit. Both sides
                are timed with CUDA events, and each kernel's bound (the
                least time the card could take for the same work) is
                computed from the wave's shapes and data: for K1 and K4
                the box and row tests the walk cannot avoid
                (tilewave.tileloop_work_plain, on at most 512 tiles of a
                wave, scaled); K2 and K3 on live rays alone: a slab
                test per (live ray, box), each wave's ray counter
                (tilewave.slab_ray_counts) held to its slots and live
                rays. Then K2 at the live shares of every bounce and
                shadow wave of one bunny batch (cluster boxes) and one
                buddha.accum batch (superboxes, perfbench's frozen
                scene), uncapped: ms beside slots, live rays and the
                bound on the live rays ([k2 live] lines). The ray sort
                (csrc/raysort.cu: keys, CUB's sort, gather, restore)
                against its plain version on every bounce and shadow
                wave of the same two batches (the bunny's also cut at
                caps 5% above each wave's live rays): keys, permutation,
                gathered rays, the live count past the cut and restored
                outputs bit-equal, timed beside its bytes bound
                ([raysort] lines);
  4. render   — each preset at its own size, one batch, through
                render_scene(device="cuda"): bunny (8 spp), sponza (2
                spp), cornell (16 spp) and hello_triangle (1 spp), the
                sponza config over the small instanced stand-in
                sponza_standin(8, 3), whose 126 instance-clusters take
                per-cluster entries (K1 two-level without sc), the two
                pair-budget paths on the bunny: bunny_budget
                (pairs_per_tile=256: K3 + clamp + K1 under the budget
                retries; it must end without overflow, with an image
                bit-equal to the bunny path's, and prints its retries and
                per-wave maximum entries per tile) and bunny_pair
                (intersector bvh_pair: K6; prints the live pairs per ray
                per wave), and the paths of the last three kernels:
                bunny_packet (intersector bvh_packet: K5), bunny_seg
                (TPURT_ENTRY_ROWS=0: K3 + K1 pair segments, image
                bit-equal to the bunny path's), bunny_grid and
                cornell_grid (TPURT_PAIR_LOOP=0: K4, flat and all-pairs),
                and the alternate pipelines and builders: bunny_mega
                (the megakernel), bunny_wavefront (the wavefront loop,
                65,536 lanes), bunny_sorted (the sorted-wave loop),
                bunny_morton (the tile intersector's Morton ray sort),
                each K2 + K1 and held to the bunny path's image (RMSE ≤
                1e-3, under 2% of pixels off by more than 1e-3),
                sponza_mega (K2 + K1 two-level with superclusters),
                cornell_brute (the megakernel through the brute force,
                512×512 × 16 spp) and bunny_bvh (the megakernel through
                the two-level LBVH walk), both plain torch: no kernel may
                launch; then bunny_sorted with live caps too small, which
                must re-render uncapped, bit-equal to its uncapped image.
                Each runs once as warmup, then once timed with the launch
                counters zeroed just before it and read just after, its
                switches set around both and restored; its kernels must
                have launched, it must end without overflow, and the image
                must be finite and bit-equal to the warmup's (same seed).
                Each path's Mrays/s is logged beside the card's
                nvidia-smi name and power limit. The staged paths run
                the default loop, the stage programs as CUDA graphs
                where the path allows (phase 8): the warmup's renderer
                captures them (``prewarm``) and the timed run replays
                them, its launches counted a replay; a render that
                builds its renderer (bunny_budget's retries) also counts
                its prewarm's warm-up batch. A replay runs no Python:
                a graph adds what its capture counted. So each graph of
                a staged path's renderer is held to the kernel nodes
                libcuda holds for it (``check_graph_nodes``: the
                run's graphs keep their cudaGraph_t, read through
                cuGraphGetNodes and cuFuncGetName): per device kernel,
                the nodes must equal the capture's count. The fence and
                the flythrough (phase 6) are held the same way.
                Then the golden fixtures on the card against
                tests/golden/data/*.npz: bunny (also through bvh_pair,
                bvh_packet, TPURT_ENTRY_ROWS=0, TPURT_PAIR_LOOP=0 and the
                megakernel with the LBVH, the path that generated it),
                hello_triangle and cornell (also through TPURT_PAIR_LOOP=0
                and the megakernel with the brute force)
                at RMSE ≤ 1e-3; sponza (also through the megakernel with
                the LBVH) and cornell_pt at an energy bias ≤
                1e-3 with their RMSE printed (sponza also under 2% of
                pixels off by more than 1e-3; ROADMAP §3 says why their
                RMSE is not the bar); and the bvh_pair bunny golden with
                pairs_per_ray=1, which must retry at least once and end
                without overflow;
  5. variants — the reference's switches on the card. Phase 3 also holds
                K1's flat supercluster mode (tileloop_sc, the walk of
                TPURT_SUPERCLUSTER=1 over a flat accel) to the exact walk
                on the bunny's bounce and shadow waves, entries from K2
                over the 107 superboxes, with its edge-case lists, its
                ptxas registers and its bound. Then, each as a phase-4
                path (warmup, timed render with the counters zeroed, its
                kernels launched): bunny_sc (TPURT_SUPERCLUSTER=1),
                sponza_cluster (TPURT_SUPERCLUSTER=0: per-cluster
                two-level entries at 1080p, held to the sponza path's
                energy bias ≤ 1e-3), bunny_interval and bunny_exact_all
                (TPURT_EXACT_MASK=0 / all: K2 launches none / one more a
                batch than the bunny path), bunny_unfused
                (TPURT_FUSED_ENTRIES=0: K3 launches where K2 did, the
                accumulation bit-equal to the bunny path's) and the
                clusterings bunny_kdsah, bunny_kd and bunny_morton_order
                (TPURT_CLUSTERING, each with its host build seconds); the
                bunny variants held to the bunny path's image (RMSE ≤
                1e-3, under 2% of pixels off by more than 1e-3), each
                variant's golden (bunny RMSE ≤ 1e-3, sponza energy bias ≤
                1e-3), every Mrays/s beside the bunny's and sponza's;
                batch_key and uniform2 (600, 800) on the card bit-equal
                to the CPU's; one bunny batch under TPURT_CAPTURE_WAVES
                and TPURT_DEBUG_STAGES=1 (the reference's files, keys and
                shapes, ten stage lines, the image bit-equal to the
                bunny path's);
  6. files    — the scene-file, texture, cut-out and CLI path, through
                ``tpurt_torch.cli.main`` where a user would call it: the
                bunny config over the bunny plus a 16×16-texel RGBA fence
                cut out at alpha 0.5, against its geometric twin (the
                opaque texels as sub-quads), through bvh_tile and
                bvh_packet, RMSE ≤ 1e-3, with both batches' Mrays/s; the
                bunny exported to OBJ and sponza to GLB, each rendered
                from the file within rtol and atol 1e-5 of its preset's
                render; a hand-written .gltf (an embedded RGBA PNG,
                alphaMode MASK) whose device arrays equal the same scene
                built in memory and whose render is bit-equal to it; the
                8-frame sponza flythrough (one scene-context build, frame
                0 bit-equal to ``render``'s image, no two frames equal,
                ms a frame and Mrays/s); resume 4 → 8 spp bit-equal to a
                straight 8-spp render, with the reference's checkpoint
                keys; and the native host library (loaded, or why not;
                its OBJ parse equal to the Python parser's). The cut-out
                renders and the flythrough run with the launch counters
                zeroed just before and read just after, and their kernels
                must have launched;
  7. mesh     — worlds of the port's render sharding (tpurt_torch.parallel)
                on cuda:0, each rank a child process of this script
                (``chip_smoke.py --mesh-rank WORLD OUT``) joined over gloo
                (ranks that share a card cannot use NCCL), with
                OMP_NUM_THREADS=1, loading the kernel library phase 2
                built (a child that compiles fails), under a wall-clock
                limit that kills the whole world: bunny 800×600 × 8 spp
                (spp_per_batch 4) on 2 sample × 2 tile shards through the
                staged loop and bvh_tile (K2 + K1 flat); sponza 1920×1080
                × 2 spp (spp_per_batch 1) on 2 × 2 (K2 + K1 two-level +
                sc); cornell 512×512 × 16 spp (spp_per_batch 8) on 2 × 1
                through the megakernel (render_batch_distributed, K1
                all-pairs). Each rank renders once as warmup, then once
                with its launch counters zeroed just before and read just
                after; rank 0's accumulation must equal, bit for bit,
                this process's render of the same sample window (two
                batches), its closest and shadow counters equal, and its
                warmup equal; every rank must exit 0 and launch the
                world's kernels. The world's Mrays/s is logged beside the
                single process's and the nvidia-smi line: ranks sharing
                one card measure no scaling;
  8. graphs   — the reference's stage programs as CUDA graphs
                (``render/staged.py``; every phase above already runs
                them, the default): bunny, sponza (1920×1080 × 2 spp),
                cornell, hello_triangle, bunny_sorted, bunny_packet and
                the cut-out fence, each at its preset's size with its
                measured caps, through one StagedRenderer a loop: the
                unfused loop eagerly and as graphs (TPURT_FUSE_STAGES=0),
                the stage programs eagerly and as graphs (the default),
                and the whole batch eagerly and as a graph
                (TPURT_FUSE_BOUNCES=1; not for flat shading or the sorted
                loop). Flat shading runs every loop eagerly (its
                ``graph_reason``). Three batches each — the first sample
                0, then spp, then a moved camera — so the graphs replay
                with their input buffers refilled; the unfused and stage
                graphs captured by ``prewarm``, the whole batch's by its
                first batch. Each graph mode must be bit-equal, image and
                counters, to its split run eagerly and count the same
                launches a batch, its graphs held to their kernel nodes
                as in phase 4; the stage
                split bit-equal to the unfused loop; the whole batch
                (uncapped waves) within RMSE 1e-3 of the default loop
                (under 2% of pixels off by more than 1e-3), the counters
                that differ logged. Logged: each loop's mode, graphs and
                ``graph_reason``, graphs and capture seconds a path,
                Mrays/s of the eager loop and the unfused, stage and
                whole-batch graphs in turns, and the bunny batch's device idle share
                (``torch.profiler``) eager and as graphs. Phase 4 logs
                each staged path's loop and, where it runs eagerly, why;
  9. report   — the kernel JSON line, the nvidia-smi line, and last the
                {"ok": true, "device": ...} line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

GOLDEN_RMSE = 1e-3  # tests/golden/test_golden.py
GOLDEN_BIAS = 1e-3  # energy bias bar of the chaos-dominated fixtures
K1_SLOT_AGREE = 0.9999  # share of live rays whose slot must match
K1_T_RTOL = 1e-6
# the card's peaks for the bounds (NVIDIA H100 SXM data sheet, at 700 W):
# HBM bytes/s, and float32 operations/s outside the tensor cores counted
# without multiply-add: 132 SMs x 128 lanes x 1.98 GHz. The data sheet's
# 67e12 counts an FMA as two operations; every port kernel builds with
# -fmad=false (kernels/cuda_build.py), so each multiply and each add is an
# instruction of its own
HBM_BYTES_S = 3.35e12
F32_OPS_S = 33.5e12
SLAB_OPS = 28  # one ray against one box: 3 axes x (2 sub, 2 mul, min,
# max, running max, running min) plus the hit test and the accumulation
MT_OPS = 60  # one Moller-Trumbore test with its fold (pairwave.py:75-112)
ROW_OPS = SLAB_OPS + 12 * MT_OPS  # a row: its sub-box and 12 triangles
WORK_TILES = 512  # tiles of a wave the walk-work count visits, at most


def f32_ops_s() -> float:
    """F32_OPS_S, once the kernels' nvcc flags are the ones it assumes:
    with multiply-add contraction a bound at this rate would be up to 2x
    too loose."""
    from tpurt_torch.kernels import cuda_build

    if "-fmad=false" not in cuda_build.NVCC_FLAGS:
        raise AssertionError("F32_OPS_S counts a multiply and an add as two "
                             "instructions: revisit it for kernels built "
                             "without -fmad=false")
    return F32_OPS_S
ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def timed_once(fn):
    """``fn()`` and its milliseconds (CUDA events, one call): a plain
    version's result is compared and its time reported from one run."""
    out = []
    ms = cuda_ms(lambda: out.append(fn()), 1)
    return out[0], ms


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _renderer(config, scene, device):
    """The accel and staged renderer of ``config`` on the host ``scene``."""
    from tpurt_torch.render import build_accel
    from tpurt_torch.render.intersectors import scene_meta
    from tpurt_torch.render.staged import StagedRenderer
    from tpurt_torch.scene.device import to_device

    meta = scene_meta(scene)
    ds = to_device(scene, device=device)
    accel = build_accel(config, ds, meta, scene=scene, device=device)
    return accel, StagedRenderer(ds, accel, meta=meta, config=config,
                                 device=device)


def _preparer(accel, sort: bool):
    """A wave (org, dirn, tmax) as the tile intersector prepares it:
    scene-exit cap, octant sort (dead rays last) for the entry-row modes;
    returned as (org, dirn, inv_d, tmax)."""
    import torch

    from tpurt_torch.kernels import tilewave as tw

    lo, hi = accel.cluster_lo, accel.cluster_hi
    lo_all, hi_all = lo.amin(dim=0), hi.amax(dim=0)
    ext = hi_all - lo_all
    diag = torch.sqrt(ext[0] * ext[0] + ext[1] * ext[1] + ext[2] * ext[2])

    def prepare(org, dirn, tmax):
        tmv = torch.where(torch.isfinite(tmax), tmax, tw.BIG)
        tmv = tw._scene_exit_cap(org, dirn, tmv, lo_all, hi_all, diag)
        if sort:
            keys = tw._octant_sort_keys(org, dirn, tmv, lo_all, hi_all)
            perm = torch.sort(keys, stable=True).indices
            org, dirn, tmv = org[perm], dirn[perm], tmv[perm]
        org, dirn, tmv = (x.contiguous() for x in (org, dirn, tmv))
        return org, dirn, tw._safe_inv(dirn), tmv

    return prepare


def alive_tmax(state):
    """A wave state's tmax as the renderer traces it: inf alive, -1 dead."""
    import torch

    return torch.where(state.alive, math.inf, -1.0)


def batch_waves(name: str, device, spp: int, sort: bool):
    """The primary, first bounce and first shadow waves of one batch of
    the preset, prepared as the tile intersector prepares them (scene-exit
    cap; octant sort for the entry-row modes, none for all-pairs). Each
    wave is (org, dirn, inv_d, tmax). Also the waves as the renderer hands
    them to an intersector, (org, dirn, tmax)."""
    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.utils.config import get_config

    config = get_config(name, spp=spp, spp_per_batch=spp)
    scene = load_scene(config.scene)
    accel, r = _renderer(config, scene, device)
    sampler = r.sampler(config.seed, 0)
    state = r.raygen(scene.camera, config.seed, 0)
    hit, state0 = r.trace(state, 0)
    state1, shadow = r.shade(state0, hit, sampler, 0)

    prepare = _preparer(accel, sort)
    raw = dict(primary=(state.org, state.dirn, alive_tmax(state)),
               bounce=(state1.org, state1.dirn, alive_tmax(state1)),
               shadow=(shadow[0], shadow[1], shadow[2]))
    waves = {k: prepare(*v) for k, v in raw.items()}
    return accel, waves, raw


def slab_waves(config, scene, device, primary: bool = False,
               sort: bool = True, built=None):
    """Every wave of one batch that K2 builds entries for, uncapped and
    prepared as the tile intersector prepares it: the bounce waves
    ``bounce-1`` up to ``bounce-<max_bounces>`` and a shadow wave a hit
    depth, ``shadow-0`` on; with ``primary``, the camera wave (every ray
    live; its entries come from the interval mask) first. Returns the
    boxes K2 tests there, as the intersector picks them (the superboxes
    from SC_AUTO_MIN_CLUSTERS clusters on, else the clusters'), and
    [(label, wave)]. Without ``sort`` the waves come as the ray sort takes
    them (capped, unsorted), with the scene box it quantizes origins to
    (the clusters' union) in place of the boxes. ``built``: the (accel,
    renderer) of ``_renderer`` to use, for a caller that needs the
    accel too."""
    from tpurt_torch.kernels import tilewave as tw

    accel, r = built or _renderer(config, scene, device)
    prepare = _preparer(accel, sort=sort)
    sampler = r.sampler(config.seed, 0)
    state = r.raygen(scene.camera, config.seed, 0)
    waves = []
    if primary:
        waves.append(("primary", prepare(state.org, state.dirn,
                                         alive_tmax(state))))
    for b in range(config.max_bounces + 1):
        if b:
            waves.append((f"bounce-{b}", prepare(
                state.org, state.dirn, alive_tmax(state))))
        hit, state = r.trace(state, b)
        state, shadow = r.shade(state, hit, sampler, b)
        if shadow is not None:
            waves.append((f"shadow-{b}", prepare(*shadow[:3])))
    if not sort:
        return (accel.cluster_lo.amin(dim=0),
                accel.cluster_hi.amax(dim=0)), waves
    if accel.cluster_lo.shape[0] >= tw.SC_AUTO_MIN_CLUSTERS:
        return (accel.sc_lo, accel.sc_hi), waves
    return (accel.cluster_lo, accel.cluster_hi), waves


def bench_scene(name: str):
    """The benchmark configuration ``name``'s render configuration (at
    the accumulation traffic's batch) and host scene, from the
    benchmark's frozen files: ``buddha`` (buddha.accum's), ``atrium``
    (atrium.accum's)."""
    from perfbench import program, scenes, traffic

    with open(os.path.join(ROOT, "perfbench", "configs",
                           f"{name}.json")) as f:
        cfg = json.load(f)
    mix = traffic.load(ROOT, "accum")
    scene = program.port_scene(scenes.build(cfg["scene"]["builder"],
                                            cfg["scene"]["args"]))
    return program.render_config({**cfg["render"], **mix["render"]}), scene


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / f32_ops_s()
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def slab_bound(wave, lo, out_bytes_per_tile: float) -> dict:
    """K2/K3: every ray's tmax read once and each live ray's origin and
    inverse direction once, the boxes once, the output once; a slab test
    per (live ray, box), as the kernels skip the dead rays. Also the
    wave's ray slots and live rays."""
    n, n_c = wave[0].shape[0], lo.shape[0]
    n_tiles = n // 1024
    live = int((wave[3] >= 0).sum())
    return dict(bound(n * 4 + live * 24 + n_c * 24
                      + n_tiles * out_bytes_per_tile,
                      live * n_c * SLAB_OPS), slots=n, live=live)


def check_k2(label, wave, lo, hi):
    """K2 against entries_plain on one wave: bit-equal, and its ray
    counter moved by the wave's slots and live rays. Returns the sorted
    entry rows, the live counts and the timing record."""
    import torch

    from tpurt_torch.kernels import tilewave as tw

    org, _, inv_d, tmv = wave
    scale = tw.tn_scale_of(lo.cpu().numpy(), hi.cpu().numpy())
    before = tw.slab_ray_counts()["entries"]
    k2 = tw.entries_cuda(org, inv_d, tmv, lo, hi, scale)
    counted = [a - b for a, b in zip(tw.slab_ray_counts()["entries"],
                                     before)]
    p2, plain_ms = timed_once(lambda: tw.entries_plain(org, inv_d, tmv, lo,
                                                       hi, scale))
    torch.cuda.synchronize()
    bad = int((k2 != p2).sum())
    ms = cuda_ms(lambda: tw.entries_cuda(org, inv_d, tmv, lo, hi, scale), 10)
    counts = (k2 != tw.INT32_MAX).sum(dim=1, dtype=torch.int32)
    rec = dict(ms=ms, plain_ms=plain_ms, mismatches=bad,
               **slab_bound(wave, lo, k2.shape[1] * 4))
    log(f"[kernels] K2 {label}: slab {tuple(k2.shape)} over {lo.shape[0]} "
        f"boxes, {int(counts.sum())} entries, {bad} words differ from the "
        f"plain version; {rec['live']} live rays of {rec['slots']} slots "
        f"({rec['live'] / rec['slots']:.1%}), counted {counted}; "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound on the live rays "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}, "
        f"{rec['bound_ms'] / ms:.0%})")
    if bad:
        raise AssertionError(f"K2 {label} is not bit-equal to entries_plain")
    if counted != [rec["slots"], rec["live"]]:
        raise AssertionError(f"K2 {label}: the ray counter moved by "
                             f"{counted}, not the wave's slots and live rays")
    entry = torch.sort(k2, dim=1).values
    return entry, counts, scale, rec


def k2_live_phase(device) -> dict:
    """K2 at the live shares the main path gives it: every bounce and
    shadow wave of one bunny batch (800×600 × 8 spp, 854 cluster boxes)
    and of one buddha.accum batch (1,417 superboxes), uncapped, through
    ``check_k2``; each wave's ms beside its slots, live rays and the bound
    counted on the live rays, and the batch's sums."""
    import torch

    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.utils.config import get_config

    bunny = get_config("bunny", spp=8, spp_per_batch=8)
    cases = (("bunny", lambda: (bunny, load_scene(bunny.scene))),
             ("buddha", lambda: bench_scene("buddha")))
    out = {}
    for name, make in cases:
        (lo, hi), waves = slab_waves(*make(), device)
        recs = {label: check_k2(f"{name} {label}", wave, lo, hi)[3]
                for label, wave in waves}
        total = {k: sum(r[k] for r in recs.values())
                 for k in ("ms", "slots", "live", "bound_ms")}
        log(f"[k2 live] {name} batch over {lo.shape[0]} boxes: "
            f"{total['ms']:.3f} ms, {total['live']} live rays of "
            f"{total['slots']} slots "
            f"({total['live'] / total['slots']:.1%}); bound on the live "
            f"rays {total['bound_ms']:.3f} ms "
            f"({total['bound_ms'] / total['ms']:.0%})")
        out[name] = dict(total, boxes=lo.shape[0], waves=recs)
        del waves, lo, hi
        torch.cuda.empty_cache()
    return out


# the bytes the ray sort moves a ray: its key and index written; CUB's
# sort of 22-bit keys with int32 indices, a histogram pass over the keys
# then three 8-bit digit passes, each reading and writing key and index
RAYSORT_KEY_OUT_BYTES = 8
RAYSORT_SORT_BYTES = 4 + 3 * 16


def raysort_bytes(n: int, live: int, keep: int, fields: int) -> int:
    """The least bytes the ray sort's step moves on a wave of ``n`` rays
    (``live`` with tmax >= 0) that keeps its first ``keep``, restoring
    ``fields`` outputs: the keys (every tmax, a live ray's origin and
    direction in, key and index out), the sort, the gather (the
    permutation, the kept rays' 28 B in and out, the tmax past the cut)
    and the restore (the permutation, each output in and out)."""
    return (n * 4 + live * 24 + n * RAYSORT_KEY_OUT_BYTES
            + n * RAYSORT_SORT_BYTES
            + n * 4 + keep * 56 + (n - keep) * 4
            + n * 4 + fields * (keep + n) * 4)


def raysort_step(wave, box, out, any_hit: bool, plain: bool):
    """The tile intersector's sort step on one wave (``_run``): sort and
    gather the first ``len(out[0])`` rays, then restore the outputs
    ``out`` of those rays (closest: four; any-hit: bs alone), by the
    kernels or their plain versions."""
    from tpurt_torch.kernels import raysort as rs

    org, dirn, _, tmv = wave
    sort = rs.sort_rays_plain if plain else rs.sort_rays_cuda
    restore = rs.restore_plain if plain else rs.restore_cuda
    perm, o, d, t, over = sort(org, dirn, tmv, *box, out[0].shape[0])
    return (perm, o, d, t, over,
            *restore(out, perm, org.shape[0], (3,) if any_hit else range(4)))


def raysort_phase(device) -> dict:
    """The ray sort (``csrc/raysort.cu``) against its plain version (the
    torch ops the step ran before) on every bounce and shadow wave of one
    bunny batch (800×600 × 8 spp, uncapped, and cut at a cap 5% above
    each wave's live rays in whole tiles, as a measured cap table cuts
    it) and of one buddha.accum batch (uncapped): the key kernel's keys
    equal the plain 32-bit keys, and the permutation, the gathered org,
    dirn and tmax, the live rays past the cut and the restored outputs
    are torch.equal. Each side timed (CUDA events, mean of 10), beside
    the bytes bound (``raysort_bytes``): ``[raysort]`` lines, and the
    kernel table's record."""
    import torch

    from tpurt_torch.kernels import raysort as rs
    from tpurt_torch.kernels import tilewave as tw
    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.utils.config import get_config

    bunny = get_config("bunny", spp=8, spp_per_batch=8)
    cases = (("bunny", lambda: (bunny, load_scene(bunny.scene))),
             ("buddha", lambda: bench_scene("buddha")))
    batches = {}
    for name, make in cases:
        box, waves = slab_waves(*make(), device, sort=False)
        for capped in ((False, True) if name == "bunny" else (False,)):
            tag = f"{name} {'capped' if capped else 'uncapped'}"
            recs = []
            for label, wave in waves:
                org, dirn, _, tmv = wave
                n, live = org.shape[0], int((tmv >= 0).sum())
                keep = n
                if capped:
                    keep = min(n, -(-int(live * 1.05) // tw.TILE) * tw.TILE)
                any_hit = label.startswith("shadow")
                keys = rs.sort_keys_cuda(org, dirn, tmv, *box)[0]
                key_bad = int((keys != rs.octant_keys32_plain(
                    org, dirn, tmv, *box)).sum())
                out = tuple(torch.arange(keep, dtype=torch.float32,
                                         device=device) + 0.25 * k
                            for k in range(4))  # made-up kernel outputs
                run = lambda p: raysort_step(wave, box, out, any_hit, p)
                bad = key_bad + sum(int((a.to(b.dtype) != b).sum())
                                    for a, b in zip(run(False), run(True)))
                ms, plain_ms = cuda_ms(lambda: run(False), 10), \
                    cuda_ms(lambda: run(True), 10)
                n_bytes = raysort_bytes(n, live, keep, 1 if any_hit else 4)
                rec = dict(bound(n_bytes, 0), wave=label, rays=n, live=live,
                           keep=keep, bytes=n_bytes, ms=ms,
                           plain_ms=plain_ms, mismatches=bad)
                recs.append(rec)
                log(f"[raysort] {tag} {label}: {n} rays, {live} live, keeps "
                    f"{keep}; {bad} values differ from the plain version "
                    f"({key_bad} keys); kernels {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms; {n_bytes / n:.1f} B a ray, bound "
                    f"{rec['bound_ms']:.4f} ms ({rec['bound_ms'] / ms:.1%})")
                if bad:
                    raise AssertionError(f"ray sort {tag} {label} is not "
                                         "bit-equal to its plain version")
            total = {k: sum(r[k] for r in recs)
                     for k in ("ms", "plain_ms", "bound_ms", "bytes", "rays",
                               "mismatches")}
            log(f"[raysort] {tag} batch ({len(recs)} waves): kernels "
                f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, "
                f"bound {total['bound_ms']:.4f} ms "
                f"({total['bound_ms'] / total['ms']:.1%}), "
                f"{total['bytes'] / total['rays']:.1f} B a ray")
            batches[tag] = dict(total, waves=recs)
        del waves
        torch.cuda.empty_cache()
    capped = batches["bunny capped"]  # the main path's waves
    return dict(name="raysort", route="cuda",
                source="tpurt_torch/csrc/raysort.cu", replaces=None,
                ms=capped["ms"], plain_ms=capped["plain_ms"],
                bound_ms=capped["bound_ms"], bound_by="bytes",
                mismatches=sum(b["mismatches"] for b in batches.values()),
                batches=batches)


def check_k3(label, wave, lo, hi):
    """K3 against exact_mask_plain on one wave: mask and tn_min
    bit-equal."""
    import torch

    from tpurt_torch.kernels import tilewave as tw

    org, _, inv_d, tmv = wave
    mask, tn = tw.exact_mask_cuda(org, inv_d, tmv, lo, hi)
    (p_mask, p_tn), plain_ms = timed_once(
        lambda: tw.exact_mask_plain(org, inv_d, tmv, lo, hi))
    torch.cuda.synchronize()
    bad = int((mask != p_mask).sum()) + int((tn != p_tn).sum())
    ms = cuda_ms(lambda: tw.exact_mask_cuda(org, inv_d, tmv, lo, hi), 10)
    log(f"[kernels] K3 {label}: mask {tuple(mask.shape)}, {int(mask.sum())} "
        f"hits, {bad} values differ from the plain version (mask and "
        f"tn_min); {ms:.3f} ms, plain {plain_ms:.3f} ms")
    if bad:
        raise AssertionError(f"K3 {label} is not bit-equal to "
                             "exact_mask_plain")
    return dict(ms=ms, plain_ms=plain_ms, mismatches=bad,
                **slab_bound(wave, lo, lo.shape[0] * 5))


def check_k6(label, raw, accel, pairs_per_ray=8):
    """K6 against pair_test_plain on the pair list of one wave, as the
    bvh_pair intersector builds it: all four outputs bit-equal."""
    import torch

    from tpurt_torch.kernels import pairwave as pw
    from tpurt_torch.kernels import tilewave as tw

    org, dirn, tmax = raw
    org, dirn = org.contiguous(), dirn.contiguous()
    tmv = torch.where(torch.isfinite(tmax), tmax, tw.BIG).contiguous()
    n = org.shape[0]
    cap = -(-(n * pairs_per_ray) // pw.BLOCK) * pw.BLOCK
    pr, pc, cmin, _, n_pairs, over = pw._cull_expand(
        org, dirn, tmv, accel.cluster_lo, accel.cluster_hi,
        n_clusters=accel.cluster_lo.shape[0], pair_cap=cap)
    args = (pr, pc, cmin, org, dirn, tmv, accel.tri_rows)
    k = pw.pair_test_cuda(*args)
    p, plain_ms = timed_once(lambda: pw.pair_test_plain(*args))
    torch.cuda.synchronize()
    bad = sum(int((a != b).sum()) for a, b in zip(k, p))
    err = max(float((a - b).abs().max()) for a, b in zip(k, p))
    ms = cuda_ms(lambda: pw.pair_test_cuda(*args), 10)
    slots, live = pr.shape[0], int((pr >= 0).sum())
    n_alive = int((tmv >= 0).sum())
    log(f"[kernels] K6 {label}: {n} rays ({n_alive} alive), {slots} slots "
        f"in {slots // pw.BLOCK} blocks, {live} live pairs "
        f"({live / max(n_alive, 1):.3f} per alive ray), overflow "
        f"{bool(over)}, {int((p[3] >= 0).sum())} slot hits; {bad} values "
        f"differ from the plain version, max abs err {err:.3e}; {ms:.3f} "
        f"ms, plain {plain_ms:.3f} ms")
    if bad or int(n_pairs) != live or not live:
        raise AssertionError(f"K6 {label} disagrees with pair_test_plain")
    rows_bytes = accel.tri_rows.numel() * 4
    return dict(ms=ms, plain_ms=plain_ms, mismatches=bad, max_abs_err=err,
                **bound(slots * 8 + slots // pw.BLOCK * 4 + n * 28
                        + rows_bytes + slots * 16, live * 96 * MT_OPS))


def padded_note(p, padded, tmv, any_hit=False) -> str:
    """How far the padded plain walk (boxes 1e-5 wider, the order-free
    fold) is from the exact one the kernels are held to: the live rays
    whose slot (any-hit: occlusion flag) differs."""
    live = tmv >= 0.0
    if any_hit:
        n = int((live & ((p[3] >= 0) != (padded[3] >= 0))).sum())
        return f"{n} occlusion flags differ between the exact and padded walks"
    n = int((live & (p[3] != padded[3])).sum())
    return f"{n} slots differ between the exact and padded plain walks"


def hold_to_k1_bars(kernel, label, k, p, tmv, n_entries, padded=None):
    """A tile kernel's outputs against its plain version's (the exact
    walk, ``exact_boxes=True``), held to K1's bars: slot equal on ≥ 99.99%
    of live rays, bt within 1e-6 relative and the instance equal where the
    slot is. ``padded``: the padded plain walk's outputs, whose distance
    from the exact walk's is logged. Returns (max abs err of bt/bu/bv
    where the slot is equal, slot mismatches)."""
    import torch

    live = tmv >= 0.0
    n_live = int(live.sum())
    same = live & (k[3] == p[3])
    agree = int(same.sum()) / max(n_live, 1)
    err = (k[0] - p[0]).abs()
    rel = err / torch.clamp_min(p[0].abs(), 1e-30)
    diff = torch.maximum(err, torch.maximum((k[1] - p[1]).abs(),
                                            (k[2] - p[2]).abs()))
    any_same = bool(same.any())
    max_rel = float(rel[same].max()) if any_same else 0.0
    max_abs = float(diff[same].max()) if any_same else 0.0
    bi_bad = int((same & (k[4] != p[4])).sum()) if len(k) == 5 else 0
    n_hit = int((live & (p[3] >= 0)).sum())
    log(f"[kernels] {kernel} {label}: {n_live} live rays ({n_hit} hit), "
        f"{n_live - int(same.sum())} slot mismatches (agree {agree:.6f}), "
        f"bt max rel err {max_rel:.3e}, max abs err (bt/bu/bv) "
        f"{max_abs:.3e}, {bi_bad} instance mismatches, {n_entries} entries"
        + ("" if padded is None else "; " + padded_note(p, padded, tmv)))
    if agree < K1_SLOT_AGREE or max_rel > K1_T_RTOL or bi_bad or not n_hit:
        raise AssertionError(f"{kernel} {label} disagrees with its plain "
                             "version")
    return max_abs, n_live - int(same.sum())


def walk_work(label, wave, rows, entry, counts, scale, any_hit, p, tl):
    """The box and row tests a front-to-back walk over these entries
    cannot avoid (tilewave.tileloop_work_plain, final bt from the plain
    result ``p``), counted on every n-th tile so that at most WORK_TILES
    are visited and scaled to the whole wave. Returns (box tests, row
    tests)."""
    import torch

    from tpurt_torch.kernels import tilewave as tw

    n_tiles = entry.shape[0]
    step = max(1, -(-n_tiles // WORK_TILES))
    idx = torch.arange(0, n_tiles, step, device=entry.device)
    ray = (idx[:, None] * tw.TILE
           + torch.arange(tw.TILE, device=entry.device)[None, :]).reshape(-1)
    sub = [x[ray].contiguous() for x in wave]
    two_level = tl.get("pair_meta") is not None
    boxes, row_tests = tw.tileloop_work_plain(
        *sub, rows, entry[idx].contiguous(), counts[idx].contiguous(), scale,
        any_hit, bt=p[0][ray], bs=p[3][ray],
        bi=p[4][ray] if two_level else None, **tl)
    f = n_tiles / idx.numel()
    boxes, row_tests = float(boxes.sum()) * f, float(row_tests.sum()) * f
    log(f"[kernels] {label}: walk work on 1 tile in {step} ({idx.numel()} "
        f"of {n_tiles}), scaled to the wave: {boxes:.6g} box tests, "
        f"{row_tests:.6g} row tests ({row_tests / max(boxes, 1):.4f} a box)")
    return boxes, row_tests


def tile_bound(n, n_out, rows, tl, list_bytes, work) -> dict:
    """K1/K4: each ray read once (org, dirn, inv_d, tmax), the rows,
    tables and entry lists once, the outputs once; the walk's unavoidable
    work ``work`` = (box tests, row tests), 28 operations a box and 28 + 12
    x 60 a row."""
    table_bytes = sum(t.numel() * 4 for t in tl.values() if t is not None)
    boxes, row_tests = work
    return dict(bound(n * 40 + rows.numel() * 4 + table_bytes + list_bytes
                      + n * 4 * n_out, boxes * SLAB_OPS + row_tests * ROW_OPS),
                box_tests=boxes, row_tests=row_tests)


def check_k1(label, wave, rows, entry, counts, scale, any_hit, **tl):
    """K1 against tileloop_plain's exact walk on one wave, same entries
    and tables."""
    import torch

    from tpurt_torch.kernels import tilewave as tw

    org, dirn, inv_d, tmv = wave
    args = (org, dirn, inv_d, tmv, rows, entry, counts, scale, any_hit)
    k = tw.tileloop_cuda(*args, **tl)
    p, plain_ms = timed_once(lambda: tw.tileloop_plain(
        *args, exact_boxes=True, **tl))
    padded = tw.tileloop_plain(*args, **tl)
    torch.cuda.synchronize()
    n_entries = int(counts.sum())
    max_abs, bad = hold_to_k1_bars("K1", label, k, p, tmv, n_entries, padded)
    ms = cuda_ms(lambda: tw.tileloop_cuda(*args, **tl), 10)
    work = walk_work(f"K1 {label}", wave, rows, entry, counts, scale,
                     any_hit, p, tl)
    rec = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs,
               mismatches=bad,
               **tile_bound(org.shape[0], len(k), rows, tl,
                            entry.numel() * 4 + counts.numel() * 4, work))
    log(f"[kernels] K1 {label}: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']})")
    return rec


def break_point(deq, n: int, group: int):
    """A group start b of a sorted list of n entry distances that the
    far break can fire at with the group's rows already fetched and more
    groups after it: b a positive multiple of ``group`` (K1 votes on a
    group's first entry), b + group < n, and deq[b - 1] < deq[b], so a
    cut between them lets the rays test the entries before b and none
    from b on. The first such b in the list's second half, else the
    first; None if there is none."""
    starts = [b for b in range(group, n - group, group)
              if float(deq[b]) > float(deq[b - 1])]
    late = [b for b in starts if b >= n // 2]
    return (late or starts or [None])[0]


def edge_case(wave, entry, counts, scale, sc=False):
    """Five tiles of a sorted wave whose entry lists sit at the edges of
    K1's ring: 0 entries, 1 entry, an odd count, a full row (counts ==
    cp, the longest list of the wave) and a list whose rays all stop
    before a group start b (``break_point``, for the ring's group size:
    tileloop.cu's kGroup entries a stage, one supercluster with ``sc``).
    Their tmax is cut between the distances of entries b - 1 and b, so
    every slice's far break fires at b, after b's rows were fetched ahead
    and before later groups, and the block exits through the wait for
    copies still in flight. Returns ((org, dirn, inv_d, tmax), entries
    (5, cp), counts (5,), b)."""
    import torch

    from tpurt_torch.kernels import cuda_build
    from tpurt_torch.kernels import tilewave as tw

    group = 1 if sc else cuda_build.constant("kGroup")
    dev = entry.device
    c = counts.cpu()
    full = int(torch.argmax(c))
    cp = int(c[full])
    deq_all = (entry[:, :cp] >> 16).float().cpu() * scale
    last, b = None, None
    for t in torch.argsort(c, descending=True, stable=True).tolist():
        if t != full:
            b = break_point(deq_all[t], min(int(c[t]), cp), group)
            if b is not None:
                last = t
                break
    many = torch.nonzero(c >= 3)[:, 0]
    many = many[(many != full) & (many != (-1 if last is None else last))]
    if last is None or cp < 4 or many.numel() < 3:
        raise AssertionError("the wave has too few long entry lists")
    pick = many[torch.linspace(0, many.numel() - 1, 3).long()].tolist()
    src = [pick[0], pick[1], pick[2], full, last]
    ent = entry[src, :cp].contiguous()
    n_odd = min(int(c[src[2]]), cp)
    n_odd -= 1 - n_odd % 2
    n_last = min(int(c[last]), cp)
    ray = (torch.tensor(src, device=dev)[:, None] * tw.TILE
           + torch.arange(tw.TILE, device=dev)[None, :]).reshape(-1)
    org, dirn, inv_d, tmv = (x[ray].contiguous() for x in wave)
    deq = deq_all[last]
    # below deq[b] even where deq[b - 1] and deq[b] are adjacent floats
    cut = float(torch.minimum((deq[b - 1] + deq[b]) / 2,
                              torch.nextafter(deq[b], deq[b - 1])))
    rays = slice(4 * tw.TILE, 5 * tw.TILE)
    tmv[rays] = torch.where(tmv[rays] >= 0, torch.clamp_max(tmv[rays], cut),
                            tmv[rays])
    counts5 = torch.tensor([0, 1, n_odd, cp, n_last], dtype=torch.int32,
                           device=dev)
    return (org, dirn, inv_d, tmv), ent, counts5, b


def check_k1_edges(label, wave, rows, entry, counts, scale, any_hit,
                   seg=False, **tl):
    """K1 against tileloop_plain's exact walk on the edge-case lists of
    ``edge_case`` (as pair segments with ``seg``), held to K1's bars; the
    tile with no
    entries must return every ray's starting values, and every ray of the
    last tile must end below the distance of the entry its break is cut
    at."""
    import torch

    from tpurt_torch.kernels import tilewave as tw

    rays, ent, cnt, b = edge_case(wave, entry, counts, scale,
                                  sc="sc_meta" in tl)
    if seg:
        args = (*rays, rows, *tw._rows_to_segments(ent, cnt), scale, any_hit)
        k = tw.tileloop_seg_cuda(*args)
        p = tw.tileloop_seg_plain(*args, exact_boxes=True)
        padded = tw.tileloop_seg_plain(*args)
    else:
        args = (*rays, rows, ent, cnt, scale, any_hit)
        k = tw.tileloop_cuda(*args, **tl)
        p = tw.tileloop_plain(*args, exact_boxes=True, **tl)
        padded = tw.tileloop_plain(*args, **tl)
    torch.cuda.synchronize()
    kind = "any-hit" if any_hit else "closest"
    hold_to_k1_bars("K1 edges", f"{label} {kind}{' segments' if seg else ''}"
                    f" (counts {cnt.tolist()}, cp {ent.shape[1]}, the last "
                    f"tile breaks at entry {b})", k, p, rays[3],
                    int(cnt.sum()), padded)
    if not bool((p[0][4 * tw.TILE:] < (ent[4, b] >> 16).float() * scale)
                .all()):
        raise AssertionError(f"K1 edges {label}: a ray of the last tile "
                             f"reaches entry {b}, so its far break may not "
                             "fire there")
    first = slice(0, tw.TILE)
    tm0 = rays[3][first]
    start = torch.where(tm0 >= 0, tm0, -1.0)
    if not (torch.equal(k[0][first], start) and bool((k[3][first] == -1).all())
            and bool((k[1][first] == 0).all())):
        raise AssertionError(f"K1 edges {label}: the empty tile's rays "
                             "changed")


def check_seg(label, wave, accel, any_hit, pcap):
    """K1's pair-segment mode against tileloop_seg_plain's exact walk on
    one sorted wave, with the lists of the main path: K3 per 256-tile
    launch chunk at capacity ``pcap`` (no clamp), the chunks' lists end
    to end, one launch."""
    import torch

    from tpurt_torch.kernels import tilewave as tw

    lo, hi, rows = accel.cluster_lo, accel.cluster_hi, accel.tri_rows
    scale = tw.tn_scale_of(lo.cpu().numpy(), hi.cpu().numpy())
    off, pair_cl, n_pairs, over = tw._wave_segments(
        *wave, lo, hi, scale, tw.TILES_PER_LAUNCH, exact=True,
        pairs_per_tile=0, pcap=pcap)
    args = (*wave, rows, off, pair_cl, scale, any_hit)
    k = tw.tileloop_seg_cuda(*args)
    p, plain_ms = timed_once(lambda: tw.tileloop_seg_plain(
        *args, exact_boxes=True))
    padded = tw.tileloop_seg_plain(*args)
    torch.cuda.synchronize()
    n_chunks = -(-(off.shape[0] - 1) // tw.TILES_PER_LAUNCH)
    kind = "any-hit" if any_hit else "closest"
    max_abs, bad = hold_to_k1_bars(
        "K1-seg", f"{kind} ({label}, {n_chunks} chunks of "
        f"{tw.TILES_PER_LAUNCH} tiles at pcap {pcap}, overflow {bool(over)})",
        k, p, wave[3], int(n_pairs), padded)
    if bool(over):
        raise AssertionError(f"K1-seg {label}: the pair list overflowed")
    ms = cuda_ms(lambda: tw.tileloop_seg_cuda(*args), 10)
    entry, counts = tw._segments_to_rows(off, pair_cl)
    work = walk_work(f"K1-seg {label}", wave, rows, entry, counts, scale,
                     any_hit, p, {})
    rec = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs,
               mismatches=bad,
               **tile_bound(wave[0].shape[0], len(k), rows, {},
                            off.numel() * 4 + pair_cl.numel() * 4, work))
    log(f"[kernels] K1-seg {label}: {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']})")
    return rec


def grid_list(label, wave, accel, avg, all_pairs=False):
    """K4's list of one wave as the main path builds it: the interval
    mask per launch chunk, no clamp, ``avg`` pairs a tile doubled until no
    chunk overflows (as the budget retries do), the chunks' lists end to
    end; every (tile, cluster) pair for all-pairs. Returns (packed, chunk
    tiles, avg, overflow)."""
    from tpurt_torch.kernels import tilewave as tw

    lo, hi = accel.cluster_lo, accel.cluster_hi
    n_c = lo.shape[0]
    org, dirn, _, tmv = wave
    n_tiles = org.shape[0] // tw.TILE
    while True:
        chunk = (n_tiles if all_pairs else
                 min(n_tiles, max(1, tw.MAX_PAIRS_PER_LAUNCH // avg), 32767))
        launches, _, over = tw._wave_grid_lists(
            org, dirn, tmv, lo, hi, chunk, n_clusters=n_c,
            pair_cap=chunk * (n_c if all_pairs else avg),
            per_tile_clamp=n_c + 1, all_pairs=all_pairs)
        if not bool(over) or avg >= n_c + 1:
            break
        avg = min(2 * avg, n_c + 1)
    if len(launches) != 1:
        raise AssertionError(f"K4 {label}: {len(launches)} launches")
    return launches[0][2], chunk, avg, over


def check_grid(label, wave, accel, any_hit, avg, all_pairs=False,
               edges=False, **tl):
    """K4 against tilegrid_plain's exact walk on one wave, with the lists
    of the main path (``grid_list``); with ``edges`` also on the edge-case
    lists cut from that list (``check_k4_edges``)."""
    import torch

    from tpurt_torch.kernels import tilewave as tw

    rows = accel.tri_rows
    org, dirn, inv_d, tmv = wave
    n_tiles = org.shape[0] // tw.TILE
    packed, chunk, avg, over = grid_list(label, wave, accel, avg, all_pairs)
    n_pairs = int(((packed & 0xFFFF) > 0).sum())
    args = (org, dirn, inv_d, tmv, rows, packed, any_hit)
    kw = dict(all_pairs=all_pairs, **tl)
    k = tw.tilegrid_cuda(*args, **kw)
    p, plain_ms = timed_once(lambda: tw.tilegrid_plain(
        *args, exact_boxes=True, **kw))
    padded = tw.tilegrid_plain(*args, **kw)
    torch.cuda.synchronize()
    kind = "any-hit" if any_hit else "closest"
    detail = (f"{kind} ({label}, {-(-n_tiles // chunk)} chunks of {chunk} "
              f"tiles at {avg} pairs a tile, {packed.numel()} slots)")
    if any_hit:
        bad, max_abs = hold_flags("K4", detail, k, p, tmv, n_pairs, padded)
    else:
        max_abs, bad = hold_to_k1_bars("K4", detail, k, p, tmv, n_pairs,
                                       padded)
    if bool(over):
        raise AssertionError(f"K4 {label}: the pair list overflowed")
    if edges:
        check_k4_edges(label, wave, rows, packed, any_hit, **tl)
    ms = cuda_ms(lambda: tw.tilegrid_cuda(*args, **kw), 10)
    # beside the bound: the time if every pair tested all 96 triangles of
    # its cluster against all 1024 rays (no box culling)
    all_tests_ms = n_pairs * 1024 * (96 * MT_OPS + 9 * SLAB_OPS) \
        / f32_ops_s() * 1e3
    # the walk's work over the tile's pairs in list order: no distance
    # bits, so every real pair is a box test of every live ray
    entry, counts = tw.grid_rows(packed, n_tiles)
    work = walk_work(f"K4 {label}", wave, rows, entry, counts, 0.0, any_hit,
                     p, tl)
    rec = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs,
               mismatches=bad,
               **tile_bound(org.shape[0], len(k), rows, tl,
                            packed.numel() * 4, work))
    # tileloop_kernel<hit, two-level, sc, src>: hit 2 K4's any-hit, 0
    # closest; src 2 the pair list (csrc/tileloop.cu's Hit and Src)
    regs = kernel_registers("tileloop_kernel", f"{2 if any_hit else 0},"
                            f"{int(tl.get('pair_meta') is not None)},0,2")
    rec["registers"] = regs
    log(f"[kernels] K4 {label}: {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), "
        f"{rec['bound_ms'] / ms:.1%} of the bound; every triangle of "
        f"every pair at the f32 rate {all_tests_ms:.3f} ms; registers "
        f"{regs}")
    return rec


def grid_edge_case(wave, rows, packed, any_hit, **tl):
    """Five tiles of a wave's K4 pair list at the edges of K1's ring, as
    one pair list (a sentinel a tile, fill slots after the last): 0 pairs,
    1, an odd count, the longest list of the wave, and a list of more
    than two ring groups (tileloop.cu's kGroup pairs a stage) whose rays
    stop walking after the first group: any-hit keeps only the rays that
    the first group occludes (the others dead), so every slice votes
    itself done at the second group, whose rows were fetched while the
    first was tested; closest kills the rays of every other slice, which
    vote themselves done before the first group. Returns ((org, dirn,
    inv_d, tmax), packed, counts (5,))."""
    import torch

    from tpurt_torch.kernels import cuda_build
    from tpurt_torch.kernels import tilewave as tw

    group = cuda_build.constant("kGroup")
    slice_rays = 32 * cuda_build.constant("kSliceWarps")
    n_tiles = wave[0].shape[0] // tw.TILE
    entry, counts = tw.grid_rows(packed, n_tiles)
    c = counts.cpu()
    full = int(torch.argmax(c))
    long_ = torch.nonzero(c > 2 * group)[:, 0]
    long_ = long_[long_ != full]
    many = torch.nonzero(c >= 3)[:, 0]
    many = many[many != full]
    if long_.numel() < 1 or many.numel() < 3:
        raise AssertionError("the wave has too few long pair lists")
    last = int(long_[long_.numel() // 2])
    many = many[many != last]
    pick = many[torch.linspace(0, many.numel() - 1, 2).long()].tolist()
    n_odd = int(c[pick[1]]) - 1 + int(c[pick[1]]) % 2
    src = [pick[0], pick[0], pick[1], full, last]
    cnt = [0, 1, n_odd, int(c[full]), int(c[last])]
    dev = packed.device
    ray = (torch.tensor(src, device=dev)[:, None] * tw.TILE
           + torch.arange(tw.TILE, device=dev)[None, :]).reshape(-1)
    org, dirn, inv_d, tmv = (x[ray].contiguous() for x in wave)
    words = []
    for t, (s, n) in enumerate(zip(src, cnt)):
        words.append(torch.tensor([t << 16], dtype=torch.int32, device=dev))
        words.append((t << 16) + entry[s, :n] + 1)
    words.append(torch.full((5,), 4 << 16, dtype=torch.int32, device=dev))
    edge = torch.cat(words).contiguous()
    tail = slice(4 * tw.TILE, 5 * tw.TILE)
    if any_hit:
        first = torch.cat([torch.tensor([0], dtype=torch.int32, device=dev),
                           entry[last, :group] + 1])
        one = [x[tail].contiguous() for x in (org, dirn, inv_d, tmv)]
        occ = tw.tilegrid_plain(*one, rows, first, True, exact_boxes=True,
                                **tl)[3] >= 0
        if not bool(occ.any()):
            raise AssertionError("no ray of the early-out tile is occluded "
                                 "by its first group")
        tmv[tail] = torch.where(occ, tmv[tail], -1.0)
    else:
        lane = torch.arange(tw.TILE, device=dev)
        tmv[tail] = torch.where((lane // slice_rays) % 2 == 1, -1.0,
                                tmv[tail])
    return ((org, dirn, inv_d, tmv), edge,
            torch.tensor(cnt, dtype=torch.int32, device=dev))


def check_k4_edges(label, wave, rows, packed, any_hit, **tl):
    """K4 against tilegrid_plain's exact walk on ``grid_edge_case``'s
    lists: closest held to K1's bars, any-hit with no occlusion flag
    different; the tile without pairs keeps its rays' start values, and
    every live ray of the early-out tile ends occluded (any-hit)."""
    import torch

    from tpurt_torch.kernels import tilewave as tw

    rays, edge, cnt = grid_edge_case(wave, rows, packed, any_hit, **tl)
    args = (*rays, rows, edge, any_hit)
    k = tw.tilegrid_cuda(*args, **tl)
    p = tw.tilegrid_plain(*args, exact_boxes=True, **tl)
    padded = tw.tilegrid_plain(*args, **tl)
    torch.cuda.synchronize()
    detail = (f"{label} {'any-hit' if any_hit else 'closest'} (pairs "
              f"{cnt.tolist()}, {edge.numel()} slots)")
    if any_hit:
        hold_flags("K4 edges", detail, k, p, rays[3], int(cnt.sum()), padded)
        tail = slice(4 * tw.TILE, 5 * tw.TILE)
        live = rays[3][tail] >= 0
        if not bool((k[3][tail][live] >= 0).all()):
            raise AssertionError(f"K4 edges {label}: a live ray of the "
                                 "early-out tile ends unoccluded")
    else:
        hold_to_k1_bars("K4 edges", detail, k, p, rays[3], int(cnt.sum()),
                        padded)
    first = slice(0, tw.TILE)
    tm0 = rays[3][first]
    start = torch.where(tm0 >= 0, tm0, -1.0)
    if not (torch.equal(k[0][first], start) and bool((k[3][first] == -1).all())
            and bool((k[1][first] == 0).all())):
        raise AssertionError(f"K4 edges {label}: the empty tile's rays "
                             "changed")


def hold_flags(kernel, detail, k, p, tmv, n_pairs, padded=None):
    """An any-hit result of K4 against its plain version's: an any-hit
    caller reads the occlusion flag only (a ray stops at its first hit, so
    the other fields hold that hit); zero flags may differ. Returns
    (differing flags, 0.0)."""
    bad = int(((k[3] >= 0) != (p[3] >= 0)).sum())
    log(f"[kernels] {kernel} {detail}: {bad} occlusion flags differ from "
        f"the plain version, {int((p[3] >= 0).sum())} occluded, {n_pairs} "
        "real pairs" + ("" if padded is None else
                        "; " + padded_note(p, padded, tmv, True)))
    if bad:
        raise AssertionError(f"{kernel} {detail} disagrees with "
                             "tilegrid_plain")
    return bad, 0.0


def registers(text: str) -> dict:
    """Registers and spill bytes of each kernel variant in a ptxas -v log,
    by name (the template arguments in order, bools as 0/1)."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)I((?:L[bi]\d+E)+)E",
                          m.group(1))
            name = (k.group(1) + "<" + ",".join(
                re.findall(r"L[bi](\d+)E", k.group(2))) + ">" if k else None)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def kernel_registers(kernel: str, args: str):
    """Registers and spills of one variant from the process's kernel build
    (None where the library was loaded without building)."""
    from tpurt_torch.kernels import cuda_build

    return registers(cuda_build.load().log).get(f"{kernel}<{args}>")


def packet_wave(raw):
    """A wave as the packet intersector hands it to K5 (no sort): tmax
    finite, padded with dead rays to whole 2048-ray groups. Returns (org,
    dirn, tmax)."""
    import torch

    from tpurt_torch.kernels import packet as pk

    org, dirn, tmax = raw
    tmv = torch.where(torch.isfinite(tmax), tmax, pk.BIG)
    pad = (-org.shape[0]) % pk.PACKET
    if pad:
        dev = org.device
        org = torch.cat([org, torch.zeros((pad, 3), device=dev)])
        dirn = torch.cat([dirn, torch.ones((pad, 3), device=dev)])
        tmv = torch.cat([tmv, torch.full((pad,), -1.0, device=dev)])
    return tuple(x.contiguous() for x in (org, dirn, tmv))


def check_k5(label, raw, tables, any_hit, n_plain=65536):
    """K5 against packet_plain on one wave as the packet intersector hands
    it over (no sort, padded to whole 2048-ray groups): all four outputs
    and the group counters bit-equal on a contiguous ``n_plain``-ray slice
    from the middle of the wave (the walk is per ray)."""
    import torch

    from tpurt_torch.kernels import packet as pk

    org, dirn, tmv = packet_wave(raw)
    n = org.shape[0]
    s0 = (n // 2) // pk.PACKET * pk.PACKET
    s1 = min(n, s0 + n_plain)
    sl = slice(s0, s1)
    k = pk.packet_cuda(tables, org, dirn, tmv, any_hit)
    p, plain_ms = timed_once(lambda: pk.packet_plain(
        tables, org[sl], dirn[sl], tmv[sl], any_hit))
    torch.cuda.synchronize()
    gs = slice(s0 // pk.PACKET, s1 // pk.PACKET)
    bad = sum(int((a[sl] != b).sum()) for a, b in zip(k[:4], p[:4]))
    bad += int((k[4][gs] != p[4]).sum())
    err = max(float((a[sl] - b).abs().max()) for a, b in zip(k[:4], p[:4]))
    ms = cuda_ms(lambda: pk.packet_cuda(tables, org, dirn, tmv, any_hit), 10)
    steps, leaf_rows = (float(x) for x in k[4].sum(dim=0))
    n_alive = int((tmv >= 0).sum())
    n_hit = int((k[3] >= 0).sum())
    log(f"[kernels] K5 {label}: {n} rays ({n_alive} alive, {n_hit} hit), "
        f"{steps:.0f} node steps and {leaf_rows:.0f} leaf rows "
        f"({steps / max(n_alive, 1):.1f} and {leaf_rows / max(n_alive, 1):.1f}"
        f" per alive ray); {bad} values differ from the plain version on "
        f"rays {s0}..{s1} (outputs and {s1 // pk.PACKET - s0 // pk.PACKET} "
        f"group counters), max abs err {err:.3e}; {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms on {s1 - s0} rays")
    if bad or not n_hit:
        raise AssertionError(f"K5 {label} is not bit-equal to packet_plain")
    n_nodes = tables[0].shape[0]
    rec = dict(ms=ms, plain_ms=plain_ms, plain_rays=s1 - s0,
               max_abs_err=err, mismatches=bad, node_steps=steps,
               leaf_rows=leaf_rows,
               registers=kernel_registers("packet_kernel",
                                          str(int(any_hit))),
               **bound(n * 28 + n_nodes * 32 + tables[9].numel() * 4
                       + n * 16 + k[4].shape[0] * 8,
                       steps * SLAB_OPS + leaf_rows * 12 * MT_OPS))
    log(f"[kernels] K5 {label}: bound {rec['bound_ms']:.3f} ms "
        f"({rec['bound_by']}), {rec['bound_ms'] / ms:.1%} of the bound; "
        f"registers {rec['registers']}")
    return rec


def k1_record(name, closest, anyhit, source="tpurt_torch/csrc/tileloop.cu",
              replaces="tpurt/kernels/tilewave.py:1191", **extra):
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        max_abs_err=max(closest["max_abs_err"], anyhit["max_abs_err"]),
        ms=closest["ms"], plain_ms=closest["plain_ms"],
        bound_ms=closest["bound_ms"], bound_by=closest["bound_by"],
        library_ms=None, mismatches=closest["mismatches"],
        anyhit_ms=anyhit["ms"], anyhit_plain_ms=anyhit["plain_ms"],
        anyhit_bound_ms=anyhit["bound_ms"],
        anyhit_mismatches=anyhit["mismatches"], **extra)


def check_kernels(device) -> list:
    """Phase 3: every kernel variant against its plain version at the
    shapes its main path gives it."""
    import torch

    from tpurt_torch.bvh.cluster import build_packet_accel
    from tpurt_torch.kernels import packet as pk
    from tpurt_torch.kernels import tilewave as tw
    from tpurt_torch.render.intersectors import scene_meta
    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.utils.config import get_config

    # bunny 800×600 × 8 spp: K2, K3 and K1 flat on the sorted waves, K6
    # on the pair lists of the primary and shadow waves
    accel, waves, raw = batch_waves("bunny", device, 8, sort=True)
    lo, hi, rows = accel.cluster_lo, accel.cluster_hi, accel.tri_rows
    log(f"[kernels] bunny wave: {waves['bounce'][0].shape[0]} rays, "
        f"C = {lo.shape[0]} clusters")
    entry, counts, scale, k2_bunny = check_k2("bunny bounce", waves["bounce"],
                                              lo, hi)
    flat_c = check_k1("flat closest (bunny bounce)", waves["bounce"], rows,
                      entry, counts, scale, False)
    for seg in (False, True):
        check_k1_edges("flat (bunny bounce)", waves["bounce"], rows, entry,
                       counts, scale, False, seg=seg)
    entry, counts, scale, _ = check_k2("bunny shadow", waves["shadow"], lo, hi)
    flat_a = check_k1("flat any-hit (bunny shadow)", waves["shadow"], rows,
                      entry, counts, scale, True)
    for seg in (False, True):
        check_k1_edges("flat (bunny shadow)", waves["shadow"], rows, entry,
                       counts, scale, True, seg=seg)
    del entry
    # TPURT_SUPERCLUSTER=1 on the flat accel: K2 over the superboxes, K1's
    # flat supercluster mode (tileloop_sc) expanding each entry's children
    sc_tl = dict(sc_meta=accel.sc_meta)
    flat_sc, k2_sc = {}, {}
    for kind, any_hit in (("bounce", False), ("shadow", True)):
        entry, counts, scale, k2_sc[kind] = check_k2(
            f"bunny {kind}, sc entries", waves[kind], accel.sc_lo,
            accel.sc_hi)
        flat_sc[kind] = check_k1(
            f"flat sc {'any-hit' if any_hit else 'closest'} (bunny {kind}, "
            f"S = {accel.sc_lo.shape[0]})", waves[kind], rows, entry,
            counts, scale, any_hit, **sc_tl)
        check_k1_edges(f"flat sc (bunny {kind})", waves[kind], rows, entry,
                       counts, scale, any_hit, **sc_tl)
        del entry
    sc_regs = {hit: kernel_registers("tileloop_kernel", f"{k},0,1,0")
               for hit, k in (("closest", 0), ("lean", 1))}
    log(f"[kernels] K1 flat sc registers (ptxas): {sc_regs}; closest "
        f"{flat_sc['bounce']['ms']:.3f} ms at "
        f"{flat_sc['bounce']['bound_ms'] / flat_sc['bounce']['ms']:.1%} of "
        f"its bound, lean {flat_sc['shadow']['ms']:.3f} ms at "
        f"{flat_sc['shadow']['bound_ms'] / flat_sc['shadow']['ms']:.1%}")
    k3 = {kind: check_k3(f"bunny {kind}", waves[kind], lo, hi)
          for kind in ("bounce", "shadow")}
    # past the entry-row gate: K1's pair segments (TPURT_ENTRY_ROWS=0) at
    # the bunny config's pair-segment capacity, and K4 (TPURT_PAIR_LOOP=0)
    # at its per-wave pair budgets
    cfg = get_config("bunny")
    cap_avg = max(cfg.pairs_avg, cfg.pairs_avg_bounce, cfg.pairs_avg_shadow)
    pcap = min(tw.TILES_PER_LAUNCH * min(cap_avg, lo.shape[0]),
               tw.MAX_PAIRS_PER_LAUNCH)
    seg = {kind: check_seg(f"bunny {kind}", waves[kind], accel,
                           kind == "shadow", pcap)
           for kind in ("bounce", "shadow")}
    grid = {kind: check_grid(f"bunny {kind}", waves[kind], accel,
                             kind == "shadow", avg, edges=True)
            for kind, avg in (("bounce", cfg.pairs_avg_bounce),
                              ("shadow", cfg.pairs_avg_shadow))}
    del waves
    k6 = {kind: check_k6(f"bunny {kind}", raw[kind], accel)
          for kind in ("primary", "shadow")}
    del accel
    torch.cuda.empty_cache()

    # the packet BVH of the same scene: K5 on the same waves
    scene = load_scene(cfg.scene)
    pacc = build_packet_accel(None, scene_meta(scene), scene=scene).to(device)
    tables = pk.packet_tables(pacc)
    log(f"[kernels] bunny packet BVH: {pacc.n_nodes} nodes, {pacc.n_rows} "
        f"rows of 12 triangles, "
        f"{int((pacc.node_count > 0).sum())} leaves")
    k5 = {kind: check_k5(f"bunny {kind}", raw[kind], tables,
                         kind == "shadow")
          for kind in ("primary", "bounce", "shadow")}
    del pacc, tables, raw
    torch.cuda.empty_cache()

    # sponza 1920×1080 × 2 spp: supercluster and per-cluster entries
    accel, waves, _ = batch_waves("sponza", device, 2, sort=True)
    rows = accel.tri_rows
    tl = dict(pair_meta=accel.pair_meta, inv_xform=accel.inv_xform)
    log(f"[kernels] sponza wave: {waves['bounce'][0].shape[0]} rays, "
        f"C = {accel.cluster_lo.shape[0]} instance-clusters, "
        f"S = {accel.sc_lo.shape[0]} superclusters")
    k2_sponza, k1 = {}, {}
    for mode, lo, hi, extra in (
            ("sc", accel.sc_lo, accel.sc_hi, dict(sc_meta=accel.sc_meta)),
            ("cluster", accel.cluster_lo, accel.cluster_hi, {})):
        for kind, any_hit in (("bounce", False), ("shadow", True)):
            entry, counts, scale, rec = check_k2(
                f"sponza {kind}, {mode} entries", waves[kind], lo, hi)
            k2_sponza[f"{mode}_{kind}"] = rec
            k1[(mode, kind)] = check_k1(
                f"two-level {mode} {'any-hit' if any_hit else 'closest'} "
                f"(sponza {kind})", waves[kind], rows, entry, counts, scale,
                any_hit, **tl, **extra)
            check_k1_edges(f"two-level {mode} (sponza {kind})", waves[kind],
                           rows, entry, counts, scale, any_hit, **tl, **extra)
            del entry
    del accel, waves
    torch.cuda.empty_cache()

    # cornell 512×512 × 16 spp: all-pairs (no sort, one cluster row)
    accel, waves, _ = batch_waves("cornell", device, 16, sort=False)
    n_c = accel.cluster_lo.shape[0]
    ap = {}
    for kind, any_hit in (("primary", False), ("shadow", True)):
        n_tiles = waves[kind][0].shape[0] // tw.TILE
        entry = torch.arange(n_c, dtype=torch.int32, device=device)
        entry = entry[None].expand(n_tiles, n_c).contiguous()
        counts = torch.full((n_tiles,), n_c, dtype=torch.int32, device=device)
        ap[kind] = check_k1(
            f"all-pairs {'any-hit' if any_hit else 'closest'} (cornell "
            f"{kind}, C = {n_c})", waves[kind], accel.tri_rows, entry,
            counts, 0.0, any_hit)
        grid[f"allpairs_{kind}"] = check_grid(
            f"all-pairs cornell {kind}, C = {n_c}", waves[kind], accel,
            any_hit, n_c, all_pairs=True)
    del accel, waves

    k2_all = [k2_bunny, *k2_sc.values(), *k2_sponza.values()]
    return [
        dict(name="entries", route="cuda",
             source="tpurt_torch/csrc/entries.cu",
             replaces="tpurt/kernels/tilewave.py:843", max_abs_err=0.0,
             ms=k2_bunny["ms"], plain_ms=k2_bunny["plain_ms"],
             bound_ms=k2_bunny["bound_ms"], bound_by=k2_bunny["bound_by"],
             library_ms=None,
             mismatches=sum(r["mismatches"] for r in k2_all),
             sponza_ms={k: r["ms"] for k, r in k2_sponza.items()},
             sponza_plain_ms={k: r["plain_ms"] for k, r in k2_sponza.items()},
             sponza_bound_ms={k: r["bound_ms"]
                              for k, r in k2_sponza.items()},
             bunny_sc_ms={k: r["ms"] for k, r in k2_sc.items()},
             bunny_sc_plain_ms={k: r["plain_ms"] for k, r in k2_sc.items()},
             bunny_sc_bound_ms={k: r["bound_ms"] for k, r in k2_sc.items()}),
        dict(name="exact_mask", route="cuda",
             source="tpurt_torch/csrc/entries.cu",
             replaces="tpurt/kernels/tilewave.py:709", max_abs_err=0.0,
             ms=k3["bounce"]["ms"], plain_ms=k3["bounce"]["plain_ms"],
             bound_ms=k3["bounce"]["bound_ms"],
             bound_by=k3["bounce"]["bound_by"], library_ms=None,
             mismatches=sum(r["mismatches"] for r in k3.values()),
             shadow_ms=k3["shadow"]["ms"],
             shadow_plain_ms=k3["shadow"]["plain_ms"],
             shadow_bound_ms=k3["shadow"]["bound_ms"]),
        dict(name="pair", route="cuda",
             source="tpurt_torch/csrc/pairwave.cu",
             replaces="tpurt/kernels/pairwave.py:123",
             max_abs_err=max(r["max_abs_err"] for r in k6.values()),
             ms=k6["primary"]["ms"], plain_ms=k6["primary"]["plain_ms"],
             bound_ms=k6["primary"]["bound_ms"],
             bound_by=k6["primary"]["bound_by"], library_ms=None,
             mismatches=sum(r["mismatches"] for r in k6.values()),
             shadow_ms=k6["shadow"]["ms"],
             shadow_plain_ms=k6["shadow"]["plain_ms"],
             shadow_bound_ms=k6["shadow"]["bound_ms"]),
        k1_record("tileloop", flat_c, flat_a),
        k1_record("tileloop_allpairs", ap["primary"], ap["shadow"]),
        k1_record("tileloop_tl", k1[("cluster", "bounce")],
                  k1[("cluster", "shadow")]),
        k1_record("tileloop_tl_sc", k1[("sc", "bounce")],
                  k1[("sc", "shadow")]),
        k1_record("tileloop_sc", flat_sc["bounce"], flat_sc["shadow"],
                  registers=sc_regs),
        k1_record("tileloop_seg", seg["bounce"], seg["shadow"]),
        k1_record("tilegrid", grid["bounce"], grid["shadow"],
                  replaces="tpurt/kernels/tilewave.py:276"),
        k1_record("tilegrid_allpairs", grid["allpairs_primary"],
                  grid["allpairs_shadow"],
                  replaces="tpurt/kernels/tilewave.py:276"),
        dict(name="packet", route="cuda", source="tpurt_torch/csrc/packet.cu",
             replaces="tpurt/kernels/packet.py:143",
             max_abs_err=max(r["max_abs_err"] for r in k5.values()),
             ms=k5["bounce"]["ms"], plain_ms=k5["bounce"]["plain_ms"],
             plain_rays=k5["bounce"]["plain_rays"],
             bound_ms=k5["bounce"]["bound_ms"],
             bound_by=k5["bounce"]["bound_by"], library_ms=None,
             mismatches=sum(r["mismatches"] for r in k5.values()),
             **{f"{kind}_{key}": k5[kind][key]
                for kind in ("primary", "shadow")
                for key in ("ms", "plain_ms", "bound_ms")},
             node_steps={kind: r["node_steps"] for kind, r in k5.items()},
             leaf_rows={kind: r["leaf_rows"] for kind, r in k5.items()}),
    ]


# S1's bytes a ray (csrc/shade.cu), each read or written once: in, the
# wave's org, dirn, radiance and throughput (4 x 12), alive and
# allow_emission (2 x 1), pix and sample (2 x 8), the hit's t, u, v (3 x
# 4), slot (4) and valid (1); out, the next wave's four vectors (4 x 12)
# and two masks (2 x 1), the shadow ray's org and dir (2 x 12), tmax (4),
# contribution (12) and want (1). A shade record (32 f32) is read once for
# each record the wave's hits reach. Its operations (a few hundred a hit)
# take under a third of the bytes' time at the f32 rate: bytes bound it.
SHADE_IN_BYTES = 4 * 12 + 2 + 2 * 8 + 3 * 4 + 4 + 1
SHADE_OUT_BYTES = 4 * 12 + 2 + 2 * 12 + 4 + 12 + 1
SHADE_ROW_BYTES = 32 * 4
SHADE_REL, SHADE_ABS = 1e-5, 1e-6  # tests/test_torch_shade.py


def shade_phase(device, name: str = "bunny", spp: int = 8) -> dict:
    """S1 on the three waves of one batch of the preset (the primary
    wave, then each bounce wave as the staged loop hands it over, at the
    preset's size): the kernel alone, mean of 10 launches by CUDA events,
    against the loop's PyTorch shade (``_shade`` with the batch's
    PixelSampler made: the same function in PyTorch's kernels, its
    ``library_ms``), held to it as ``tests/test_torch_shade.py`` holds
    it (masks and counters equal; a ray's floats within 1e-5 relative,
    1e-6 absolute), beside the bytes bound. Returns the kernel table's
    record."""
    import torch

    from tpurt_torch.render import build_accel
    from tpurt_torch.render.intersectors import scene_meta
    from tpurt_torch.render.staged import StagedRenderer
    from tpurt_torch.scene.device import to_device
    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.utils.config import get_config

    config = get_config(name, spp=spp, spp_per_batch=spp)
    scene = load_scene(config.scene)
    meta = scene_meta(scene)
    ds = to_device(scene, device=device)
    accel = build_accel(config, ds, meta, scene=scene, device=device)
    r = StagedRenderer(ds, accel, meta=meta, config=config, device=device)
    if r.shade_path != "cuda":
        raise AssertionError(f"{name}: shade path {r.shade_path} "
                             f"({r.shade_reason})")
    r.set_inputs(scene.camera, config.seed, 0)
    state = r.raygen(r.camera(), r.seed_buf, r.sample0_buf)
    waves = []
    for bounce in range(config.max_bounces + 1):
        hit, state = r.trace(state, bounce)
        plain = lambda: r._shade(state, hit, r.sampler(r.seed_buf,
                                                       r.sample0_buf),
                                 bounce)
        kernel = lambda: r.shade(state, hit, None, bounce)
        got, want = kernel(), plain()
        ms, library_ms = cuda_ms(kernel, 10), cuda_ms(plain, 10)
        hv = hit.valid & state.alive
        n = int(hv.shape[0])
        rows = int(torch.unique(hit.slot[hv]).numel())
        n_bytes = n * (SHADE_IN_BYTES + SHADE_OUT_BYTES) + rows * \
            SHADE_ROW_BYTES
        masks = [(got[0].alive, want[0].alive),
                 (got[0].allow_emission, want[0].allow_emission),
                 (got[0].rays, want[0].rays)]
        floats = [(got[0].org, want[0].org), (got[0].dirn, want[0].dirn),
                  (got[0].radiance, want[0].radiance),
                  (got[0].throughput, want[0].throughput)]
        if want[1] is not None:
            w = want[1][4][:, None]
            masks.append((got[1][4], want[1][4]))
            floats += [(got[1][0], want[1][0]), (got[1][1], want[1][1]),
                       (got[1][2][:, None], want[1][2][:, None]),
                       (torch.where(w, got[1][3], 0.0),
                        torch.where(w, want[1][3], 0.0))]
        bad = sum(int((a != b).sum()) for a, b in masks)
        held = torch.ones(n, dtype=torch.bool, device=device)
        max_err = 0.0
        for a, b in floats:
            d = (a - b).abs()
            held &= (d <= SHADE_ABS + SHADE_REL * b.abs()).all(dim=1)
            max_err = max(max_err, float(d.max()))
        share = float(held.float().mean())
        rec = dict(bound(n_bytes, 0), wave=bounce, rays=n,
                   hits=int(hv.sum()), rows=rows, bytes=n_bytes, ms=ms,
                   library_ms=library_ms, mask_mismatches=bad,
                   share_within=share, max_abs_err=max_err)
        waves.append(rec)
        log(f"[shade] {name} wave {bounce}: {n} rays, {rec['hits']} hits on "
            f"{rows} records; {n_bytes} B; S1 {ms:.4f} ms, the PyTorch "
            f"shade {library_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}, {rec['bound_ms'] / ms:.1%}); masks and "
            f"counters differ in {bad}, floats held on {share:.6f} of rays "
            f"(max abs err {max_err:.3g})")
        if bad or share < 0.999:
            raise AssertionError(f"S1 {name} wave {bounce} departs from the "
                                 "PyTorch shade")
        state, shadow = got
        if shadow is not None:
            state = r.occlude(state, shadow, bounce)
    total = lambda k: sum(w[k] for w in waves)
    log(f"[shade] {name} batch: S1 {total('ms'):.4f} ms, the PyTorch shade "
        f"{total('library_ms'):.4f} ms, bound {total('bound_ms'):.4f} ms "
        f"({total('bound_ms') / total('ms'):.1%})")
    return dict(name="shade", route="cuda", source="tpurt_torch/csrc/shade.cu",
                replaces=None, max_abs_err=max(w["max_abs_err"]
                                               for w in waves),
                ms=total("ms"), plain_ms=None, library_ms=total("library_ms"),
                bound_ms=total("bound_ms"), bound_by="bytes",
                mismatches=total("mask_mismatches"), waves=waves)


def golden_configs() -> dict:
    """GOLDENS from tests/golden/configs.py, loaded by path (an installed
    package named ``tests`` may shadow the repository's)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "golden_configs", os.path.join(ROOT, "tests", "golden", "configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GOLDENS


# each main path: (preset, spp per batch, the stand-in's column segments
# and rings or None for the preset's own scene, config overrides, the
# environment switches set around its renders, the kernels it must launch)
PATHS = {
    "bunny": ("bunny", 8, None, {}, {}, ("entries", "tileloop", "shade")),
    "sponza": ("sponza", 2, None, {}, {}, ("entries", "tileloop_tl_sc")),
    "cornell": ("cornell", 16, None, {}, {}, ("tileloop_allpairs",
                                              "shade")),
    "hello_triangle": ("hello_triangle", 1, None, {}, {},
                       ("tileloop_allpairs",)),
    "sponza_small": ("sponza", 2, (8, 3), {}, {},
                     ("entries", "tileloop_tl")),
    "bunny_budget": ("bunny", 8, None, dict(pairs_per_tile=256), {},
                     ("exact_mask", "tileloop")),
    "bunny_pair": ("bunny", 8, None, dict(intersector="bvh_pair"), {},
                   ("pair",)),
    "bunny_packet": ("bunny", 8, None, dict(intersector="bvh_packet"), {},
                     ("packet",)),
    "bunny_seg": ("bunny", 8, None, {}, dict(TPURT_ENTRY_ROWS="0"),
                  ("exact_mask", "tileloop_seg")),
    "bunny_grid": ("bunny", 8, None, {}, dict(TPURT_PAIR_LOOP="0"),
                   ("tilegrid",)),
    "cornell_grid": ("cornell", 16, None, {}, dict(TPURT_PAIR_LOOP="0"),
                     ("tilegrid_allpairs",)),
    # the alternate pipelines and builders; () = no kernel may launch
    # (the brute force and the LBVH walk are plain torch: neither may
    # quietly take the tile intersector)
    "bunny_mega": ("bunny", 8, None, dict(pipeline="mega"), {},
                   ("entries", "tileloop")),
    "bunny_wavefront": ("bunny", 8, None, dict(pipeline="wavefront"), {},
                        ("entries", "tileloop")),
    "bunny_sorted": ("bunny", 8, None, dict(sorted_wave=True), {},
                     ("entries", "tileloop")),
    "bunny_morton": ("bunny", 8, None, dict(tile_ray_sort="morton",
                                            tile_shadow_sort="morton"), {},
                     ("entries", "tileloop")),
    "sponza_mega": ("sponza", 2, None, dict(pipeline="mega"), {},
                    ("entries", "tileloop_tl_sc")),
    "cornell_brute": ("cornell", 16, None, dict(pipeline="mega",
                                                intersector="brute"), {}, ()),
    "bunny_bvh": ("bunny", 8, None, dict(pipeline="mega", intersector="bvh"),
                  {}, ()),
}
# paths held to the staged bunny path's image (RMSE, share of pixels off)
ALTERNATE_BUNNY = ("bunny_mega", "bunny_wavefront", "bunny_sorted",
                   "bunny_morton")
ALTERNATE_OFF = 0.02  # tests/test_torch_render.py
# waves of one batch in the order the staged loop traces them (2 bounces)
WAVE_NAMES = ("trace0", "occlude0", "trace1", "occlude1", "trace2",
              "occlude2")


@contextlib.contextmanager
def wave_log():
    """Record, per wave traced inside the block, what the budget paths
    measure: the tile intersector's per-tile entry counts before its clamp
    (maximum, mean, overflow) and the pair intersector's live pairs per
    alive ray (and overflow). A wave traced while a CUDA graph is being
    captured is not read (the host may not read it then): the staged
    loop's warm-up run of the same stage, just before, logged it."""
    import torch

    from tpurt_torch.kernels import pairwave as pw
    from tpurt_torch.kernels import tilewave as tw

    def capturing():
        return (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing())

    rows = []
    clamp_rows, cull_expand = tw._clamp_rows, pw._cull_expand

    def clamp_logged(mask, pairs_per_tile):
        out = clamp_rows(mask, pairs_per_tile)
        if capturing():
            return out
        raw = mask.sum(dim=1).float()
        rows.append(f"max {int(raw.max())} mean {float(raw.mean()):.1f} "
                    f"entries/tile{' OVERFLOW' if bool(out[2]) else ''}")
        return out

    def cull_logged(org, dirn, tmax, lo, hi, **kw):
        out = cull_expand(org, dirn, tmax, lo, hi, **kw)
        if capturing():
            return out
        alive = int((tmax >= 0).sum())
        rows.append(f"{float(out[4]) / max(alive, 1):.3f} pairs/ray of "
                    f"{alive}{' OVERFLOW' if bool(out[5]) else ''}")
        return out

    tw._clamp_rows, pw._cull_expand = clamp_logged, cull_logged
    try:
        yield rows
    finally:
        tw._clamp_rows, pw._cull_expand = clamp_rows, cull_expand


@contextlib.contextmanager
def environ(env: dict):
    """The switches in ``env`` set inside the block, the old values (or
    their absence) restored after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def staged_renderer():
    """The staged renderer render_scene last built and kept, or None
    (the megakernel and wavefront loops keep a function)."""
    from tpurt_torch import render as rd
    from tpurt_torch.render.staged import StagedRenderer

    for ctx in rd._SCENE_CACHE.values():
        r = ctx.get("renderer") if isinstance(ctx, dict) else None
        if isinstance(r, StagedRenderer):
            return r
    return None


def by_device_kernel(counts: dict) -> dict:
    """Launch counters (``launch_counts()``'s keys; any other key is
    left out) summed by the device kernel they launch
    (``kernels.KERNELS``)."""
    from tpurt_torch.kernels import KERNELS

    out = {}
    for k, n in counts.items():
        if n and k in KERNELS:
            out[KERNELS[k]] = out.get(KERNELS[k], 0) + n
    return out


def kernel_of_symbol(symbol: str):
    """The ``kernels.KERNELS`` name of a mangled kernel symbol
    (slab_kernel split by its template argument), or None for another
    kernel."""
    import re

    from tpurt_torch.kernels import KERNELS

    names = sorted({k.split("<")[0] for k in KERNELS.values()})
    m = re.search(r"\d(" + "|".join(names) + r")(ILb[01]E)?", symbol)
    if m is None:
        return None
    if m.group(1) == "slab_kernel":
        return "slab_kernel" + ("<true>" if m.group(2) == "ILb1E"
                                else "<false>")
    return m.group(1)


def keep_graphs() -> None:
    """From here on, every CUDA graph the run captures keeps its
    ``cudaGraph_t`` (``keep_graph=True``), so ``graph_kernel_nodes`` can
    read it."""
    import torch

    made = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = lambda *a, **k: made(*a, keep_graph=True, **k)


def graph_kernel_nodes(graph) -> dict:
    """The kernel nodes of a captured graph, by ``KERNELS`` name, read
    through libcuda (``profiling.graph_nodes``,
    cuGraphKernelNodeGetParams, cuFuncGetName or, for a library kernel,
    cuKernelGetName)."""
    import ctypes

    from tpurt_torch.utils.profiling import cu_call, graph_nodes, node_type

    out = {}
    for node in graph_nodes(graph.raw_cuda_graph()):
        if node_type(node) != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56
        params = (ctypes.c_byte * 128)()
        cu_call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node),
                params)
        func = ctypes.c_void_p.from_buffer(params, 0).value
        kern = ctypes.c_void_p.from_buffer(params, 56).value
        symbol = ctypes.c_char_p()
        if func:
            cu_call("cuFuncGetName", ctypes.byref(symbol),
                    ctypes.c_void_p(func))
        else:
            cu_call("cuKernelGetName", ctypes.byref(symbol),
                    ctypes.c_void_p(kern))
        name = kernel_of_symbol(symbol.value.decode())
        if name is not None:
            out[name] = out.get(name, 0) + 1
    return out


def check_graph_nodes(label: str, renderer) -> None:
    """A replay runs no Python, so the launches a graph adds on replay
    are its capture's tally: hold each graph's tally to the kernel nodes
    libcuda holds for it (captured after ``keep_graphs``)."""
    total = {}
    for k, (graph, tally, _) in enumerate(renderer._graphs):
        want, nodes = by_device_kernel(tally), graph_kernel_nodes(graph)
        if nodes != want:
            raise AssertionError(f"{label}: graph {k} holds the kernel "
                                 f"nodes {nodes}, its capture counted "
                                 f"{want}")
        for name, n in nodes.items():
            total[name] = total.get(name, 0) + n
    log(f"[graphs] {label}: the kernel nodes of its "
        f"{len(renderer._graphs)} graphs, each equal to its capture's "
        f"count (a replay's launches): {total}")


def render_path(name: str, device, paths=PATHS):
    """One batch of the path (``paths[name]``) at its preset's size:
    warmup, then a timed run with the launch counters zeroed just before
    it. Returns its counts, its accumulated image and the timed render's
    stats."""
    import torch

    from tpurt_torch import kernels as kn
    from tpurt_torch.render import framebuffer as fb
    from tpurt_torch.render import render_scene
    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.scene.procedural import sponza_standin
    from tpurt_torch.utils.config import get_config

    preset, spp, standin, over, env, kernels = paths[name]
    config = get_config(preset, spp=spp, **over)
    scene = (load_scene(config.scene) if standin is None
             else sponza_standin(*standin))
    with environ(env):
        with wave_log() as waves:
            warm, _ = render_scene(config, device=device, scene=scene)
        kn.reset_launch_counts()
        state, stats = render_scene(config, device=device, scene=scene)
        launches = kn.launch_counts()
    img = fb.resolve(state)
    finite = bool(torch.isfinite(img).all())
    same = bool(torch.equal(warm.accum, state.accum))
    r = staged_renderer()
    if r is not None:
        log(f"[render] {name}: loop {r.mode}, stage graphs {r.graphs}"
            + (f" ({len(r.programs())} a batch)" if r.graphs else "")
            + (f"; eager: {r.graph_reason}" if r.graph_reason else "")
            + f"; shade {r.shade_path}"
            + (f" ({r.shade_reason})" if r.shade_reason else "")
            + f", {stats['shade_waves_cuda']} waves by the kernel")
        if r.graphs:
            check_graph_nodes(name, r)
    log(f"[render] {name} {config.width}x{config.height} x {stats['spp']} "
        f"spp{' ' + str(env) if env else ''}: {stats['rays_traced']:.0f} rays ({stats['rays_closest']:.0f} "
        f"closest + {stats['rays_shadow']:.0f} shadow) in "
        f"{stats['elapsed_s']:.4f} s = {stats['mrays_per_s']:.4f} Mrays/s; "
        f"live {stats['live_counts']}, want {stats['want_counts']}, "
        f"live_overflow {stats['live_overflow']}, pair_overflow "
        f"{stats['pair_overflow']}, budget_retries "
        f"{stats['budget_retries']}; launches {launches}; "
        f"image finite {finite}, mean {float(img.mean()):.6f}; "
        f"bit-equal to the warmup render (same seed) {same}")
    for k in range(0, len(waves), len(WAVE_NAMES)):  # one line per attempt
        log(f"[render] {name} warmup attempt {k // len(WAVE_NAMES)}: "
            + "; ".join(f"{w} {r}" for w, r in zip(WAVE_NAMES,
                                                    waves[k:])))
    if not finite:
        raise AssertionError(f"{name}: rendered image has non-finite pixels")
    if not same:
        raise AssertionError(f"{name}: two renders with the same seed differ")
    if stats["pair_overflow"]:
        raise AssertionError(f"{name}: the render ended with a pair overflow")
    on_card = torch.device(device).type == "cuda"  # else a CPU dry run
    for k in kernels if on_card else ():
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched in the "
                                 "main-path render")
    if not kernels and any(launches.values()):
        raise AssertionError(f"{name}: a plain-torch path launched "
                             f"kernels {launches}")
    return launches, state.accum, stats


def compare_accums(label, got, want, spp: int):
    """RMSE and share of pixels off by more than 1e-3 between two
    accumulations of ``spp`` samples; raises past the tests' bars."""
    import torch

    d = (got - want).abs() / spp
    rmse = float(torch.sqrt((d * d).mean()))
    off = float((d > 1e-3).float().mean())
    log(f"[render] {label} against the bunny path's image: RMSE "
        f"{rmse:.3e}, {off:.4%} of pixels off by more than 1e-3")
    if not (rmse <= GOLDEN_RMSE and off < ALTERNATE_OFF):
        raise AssertionError(f"{label}: image differs from the bunny path's")


def sorted_cap_check(device, uncapped):
    """The sorted-wave bunny with live caps too small for its waves:
    render_scene must warn, re-render uncapped and end bit-equal to the
    uncapped sorted render."""
    import warnings

    import torch

    from tpurt_torch.render import render_scene
    from tpurt_torch.utils.config import get_config

    config = get_config("bunny", spp=8, sorted_wave=True,
                        live_caps=(1024, 1024))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, stats = render_scene(config, device=device)
    loud = any("re-rendering uncapped" in str(w.message) for w in caught)
    same = bool(torch.equal(state.accum, uncapped))
    log(f"[render] bunny_sorted with live_caps (1024, 1024): loud uncapped "
        f"re-render {loud}, live_overflow left {stats['live_overflow']}, "
        f"bit-equal to the uncapped sorted render {same}")
    if not (loud and same) or stats["live_overflow"]:
        raise AssertionError("bunny_sorted: a cut live cap was not "
                             "re-rendered uncapped")


# the golden fixtures of phase 4: (fixture, config overrides, switches)
GOLDEN_CASES = (
    ("bunny", {}, {}), ("hello_triangle", {}, {}),
    ("cornell", {}, {}), ("sponza", {}, {}), ("cornell_pt", {}, {}),
    ("bunny", dict(intersector="bvh_pair"), {}),
    ("bunny", dict(intersector="bvh_pair", pairs_per_ray=1), {}),
    ("bunny", dict(intersector="bvh_packet"), {}),
    ("bunny", {}, dict(TPURT_ENTRY_ROWS="0")),
    # at the golden's 64×48 one 1024-ray tile spans the screen,
    # so the primary interval mask holds ~every cluster: the
    # primary budget starts at the bounce waves' 384 a tile (the
    # default 48 cannot reach it in the 3 retries)
    ("bunny", dict(pairs_avg=384), dict(TPURT_PAIR_LOOP="0")),
    ("cornell", {}, dict(TPURT_PAIR_LOOP="0")),
    # the paths that generated the goldens: the megakernel with
    # the two-level LBVH (> 128 triangles) or the brute force
    ("bunny", dict(pipeline="mega", intersector="bvh"), {}),
    ("hello_triangle", dict(pipeline="mega", intersector="brute"),
     {}),
    ("cornell", dict(pipeline="mega", intersector="brute"), {}),
    ("sponza", dict(pipeline="mega", intersector="bvh"), {}),
)


def golden_phase(device, cases=GOLDEN_CASES) -> None:
    """The golden fixtures rendered on the card, each under its config
    overrides and switches."""
    import numpy as np

    from tpurt_torch.render import framebuffer as fb
    from tpurt_torch.render import render_scene
    from tpurt_torch.utils.config import get_config

    goldens = golden_configs()
    for name, over, env in cases:
        want = np.load(os.path.join(ROOT, "tests", "golden", "data",
                                    f"{name}.npz"))["image"]
        cfg = get_config(name, **dict(goldens[name], **over))
        with environ(env):
            state, stats = render_scene(cfg, device=device)
        img = fb.resolve(state).cpu().numpy()
        rmse = float(np.sqrt(np.mean((img - want) ** 2)))
        bias = float(img.mean()) - float(want.mean())
        off = float((np.abs(img - want) > 1e-3).mean())
        log(f"[render] golden {name} {over or ''}{env or ''} "
            f"{cfg.width}x{cfg.height} "
            f"x {cfg.spp} spp: RMSE {rmse:.3e}, energy bias {bias:+.3e}, "
            f"{off:.4%} of pixels off by more than 1e-3; budget_retries "
            f"{stats['budget_retries']}, pair_overflow "
            f"{stats['pair_overflow']}")
        if img.shape != want.shape or not np.isfinite(img).all():
            raise AssertionError(f"golden {name} {over}{env}: bad image")
        if stats["pair_overflow"]:
            raise AssertionError(f"golden {name} {over}{env}: ended with a "
                                 "pair overflow")
        if over.get("pairs_per_ray") == 1:
            if stats["budget_retries"] < 1:
                raise AssertionError("golden bunny with pairs_per_ray=1: "
                                     "no budget retry")
        elif name in ("sponza", "cornell_pt"):
            if not abs(bias) <= GOLDEN_BIAS:
                raise AssertionError(f"golden {name}: energy bias over "
                                     "the limit")
            if name == "sponza" and not off < 0.02:
                raise AssertionError("golden sponza: too many pixels off")
        elif not rmse <= GOLDEN_RMSE:
            raise AssertionError(f"golden {name} {over}{env}: RMSE over the "
                                 "limit")


# --- 5. the reference's switches ----------------------------------------

# the variant paths: as PATHS (the switches set around both renders)
VARIANT_PATHS = {
    "bunny_sc": ("bunny", 8, None, {}, dict(TPURT_SUPERCLUSTER="1"),
                 ("entries", "tileloop_sc")),
    "sponza_cluster": ("sponza", 2, None, {}, dict(TPURT_SUPERCLUSTER="0"),
                       ("entries", "tileloop_tl")),
    "bunny_interval": ("bunny", 8, None, {}, dict(TPURT_EXACT_MASK="0"),
                       ("tileloop",)),
    "bunny_exact_all": ("bunny", 8, None, {}, dict(TPURT_EXACT_MASK="all"),
                        ("entries", "tileloop")),
    "bunny_unfused": ("bunny", 8, None, {}, dict(TPURT_FUSED_ENTRIES="0"),
                      ("exact_mask", "tileloop")),
    "bunny_kdsah": ("bunny", 8, None, {}, dict(TPURT_CLUSTERING="kdsah"),
                    ("entries", "tileloop")),
    "bunny_kd": ("bunny", 8, None, {}, dict(TPURT_CLUSTERING="kd"),
                 ("entries", "tileloop")),
    # the input (Morton) order; bunny_morton is the ray sort's path
    "bunny_morton_order": ("bunny", 8, None, {},
                           dict(TPURT_CLUSTERING="morton"),
                           ("entries", "tileloop")),
}
VARIANT_GOLDENS = (
    ("bunny", {}, dict(TPURT_SUPERCLUSTER="1")),
    ("sponza", {}, dict(TPURT_SUPERCLUSTER="0")),
    ("bunny", {}, dict(TPURT_EXACT_MASK="0")),
    ("bunny", {}, dict(TPURT_EXACT_MASK="all")),
    ("bunny", {}, dict(TPURT_FUSED_ENTRIES="0")),
    ("bunny", {}, dict(TPURT_CLUSTERING="kdsah")),
    ("bunny", {}, dict(TPURT_CLUSTERING="kd")),
    ("bunny", {}, dict(TPURT_CLUSTERING="morton")),
)
CAPTURE_FILES = {f"bounce{b}_wave.npz": ("org", "dirn", "alive")
                 for b in (1, 2)}
CAPTURE_FILES.update({f"shadow{b}_wave.npz": ("org", "dirn", "tmax", "want")
                      for b in (0, 1, 2)})


def energy(label, got, want, spp: int) -> None:
    """Energy bias and RMSE between two accumulations of ``spp`` samples
    (sponza's bar: bias ≤ 1e-3)."""
    import torch

    a, b = got / spp, want / spp
    bias = float(a.mean() - b.mean())
    rmse = float(torch.sqrt(((a - b) ** 2).mean()))
    off = float(((a - b).abs() > 1e-3).float().mean())
    log(f"[variants] {label} against the sponza path's image: energy bias "
        f"{bias:+.3e}, RMSE {rmse:.3e}, {off:.4%} of pixels off by more "
        "than 1e-3")
    if not abs(bias) <= GOLDEN_BIAS:
        raise AssertionError(f"{label}: energy bias over the limit")


def threefry_check(device) -> None:
    """(f): batch_key and uniform2 of shape (600, 800) on the card,
    bit-equal to the same calls on the CPU."""
    import torch

    from tpurt_torch.core import sampling

    out = {}
    for dev in (torch.device("cpu"), device):
        key = sampling.batch_key(sampling._threefry_seed(42).to(dev), 5)
        out[dev.type] = (key.cpu(), sampling.uniform2(key, (600, 800)))
    (k_cpu, u_cpu), (k_dev, u_dev) = out["cpu"], out[device.type]
    same = torch.equal(k_cpu, k_dev) and torch.equal(u_cpu, u_dev.cpu())
    log(f"[variants] threefry: batch_key {k_dev.tolist()} and uniform2 "
        f"{tuple(u_dev.shape)} on {u_dev.device}, mean "
        f"{float(u_dev.mean()):.6f}; bit-equal to the CPU's {same}")
    if not same or u_dev.device.type != device.type:
        raise AssertionError("threefry on the card differs from the CPU's")


def capture_check(device, default_accum) -> None:
    """(g): one bunny batch under TPURT_CAPTURE_WAVES and
    TPURT_DEBUG_STAGES: the reference's files, keys and shapes, the stage
    lines, and the image bit-equal to the default loop's."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tpurt_torch.render import render_scene
    from tpurt_torch.utils.config import get_config

    config = get_config("bunny", spp=8)
    n = config.width * config.height * config.spp_per_batch
    tmp = tempfile.mkdtemp(prefix="chip_smoke_capture_")
    out = io.StringIO()
    try:
        with environ(dict(TPURT_CAPTURE_WAVES=tmp, TPURT_DEBUG_STAGES="1")):
            with contextlib.redirect_stdout(out):
                state, _ = render_scene(config, device=device)
        files = sorted(os.listdir(tmp))
        shapes = {}
        for name in files:
            z = np.load(os.path.join(tmp, name))
            shapes[name] = {k: z[k].shape for k in z.files}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stages = [ln.strip() for ln in out.getvalue().splitlines()
              if ln.startswith("    [stage] ")]
    for ln in stages:
        log(f"[variants] capture run: {ln}")
    same = bool(torch.equal(state.accum, default_accum))
    want = {name: {k: (n, 3) if k in ("org", "dirn") else (n,)
                   for k in keys} for name, keys in CAPTURE_FILES.items()}
    log(f"[variants] capture: {files}, shapes {shapes}; {len(stages)} stage "
        f"lines; image bit-equal to the default loop's {same}")
    if shapes != want:
        raise AssertionError(f"capture files {shapes}, want {want}")
    if len(stages) != 1 + 3 * (config.max_bounces + 1) or not same:
        raise AssertionError("the capture run's stage lines or image are "
                             "wrong")


def variants_phase(device, launches: dict, images: dict, base: dict,
                   mrays: dict, smi: str) -> None:
    """Phase 5 of the module docstring on ``device`` (a CPU dry run counts
    no launches). ``images`` and ``base`` hold the bunny and sponza
    paths' accumulations and launch counts from phase 4; the variant
    paths' launches join ``launches``."""
    import time as _time

    import torch

    from tpurt_torch.render import build_accel
    from tpurt_torch.render.intersectors import scene_meta
    from tpurt_torch.scene.device import to_device
    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.utils.config import get_config

    got = {}
    for name in VARIANT_PATHS:
        counts, accum, stats = render_path(name, device, VARIANT_PATHS)
        mrays[name] = stats["mrays_per_s"]
        got[name] = (counts, accum)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    log(f"[variants] Mrays/s a path ({smi}): bunny {mrays['bunny']:.4f}, "
        f"sponza {mrays['sponza']:.4f}, "
        + ", ".join(f"{k} {mrays[k]:.4f}" for k in VARIANT_PATHS))
    # (a), (c), (e): the bunny variants against the bunny path's image
    for name in VARIANT_PATHS:
        if name.startswith("bunny_"):
            compare_accums(name, got[name][1], images["bunny"], 8)
    # (b) per-cluster two-level entries at 1080p against the sc default
    energy("sponza_cluster", got["sponza_cluster"][1], images["sponza"], 2)
    # (c) K2's launches: none without the exact mask, one more a batch
    # (the primary wave) on every wave; (d) K3 in K2's place, bit-equal
    b2 = base["bunny"].get("entries", 0)
    k2 = {name: got[name][0].get("entries", 0)
          for name in ("bunny_interval", "bunny_exact_all", "bunny_unfused")}
    k3 = {name: got[name][0].get("exact_mask", 0) for name in k2}
    unfused_same = bool(torch.equal(got["bunny_unfused"][1],
                                    images["bunny"]))
    log(f"[variants] K2 launches a batch: bunny {b2}, {k2}; K3 {k3}; "
        f"bunny_unfused bit-equal to the bunny path {unfused_same}")
    on_card = torch.device(device).type == "cuda"  # else a CPU dry run
    if (on_card and (k2["bunny_interval"] or k3["bunny_interval"]
                     or k2["bunny_exact_all"] != b2 + 1
                     or k2["bunny_unfused"] or k3["bunny_unfused"] != b2)
            or not unfused_same):
        raise AssertionError("the exact-mask or fused-entry switches ran "
                             "other kernels than they should")
    # (e) the host build of each clustering at the preset's size
    scene = load_scene("bunny")
    meta = scene_meta(scene)
    ds = to_device(scene, device=device)
    for mode in ("hier", "kdsah", "kd", "morton"):
        with environ(dict(TPURT_CLUSTERING=mode)):
            t0 = _time.perf_counter()
            accel = build_accel(get_config("bunny"), ds, meta, scene=scene,
                                device=device)
            build_s = _time.perf_counter() - t0
        name = {"hier": "bunny", "morton": "bunny_morton_order"}.get(
            mode, f"bunny_{mode}")
        log(f"[variants] TPURT_CLUSTERING={mode}: host build + upload "
            f"{build_s:.3f} s, {accel.cluster_lo.shape[0]} clusters; "
            f"{mrays[name]:.4f} Mrays/s ({smi})")
        del accel
    # every variant's image against its golden
    golden_phase(device, VARIANT_GOLDENS)
    threefry_check(device)
    capture_check(device, images["bunny"])


# --- 6. files and CLI ---------------------------------------------------

CUTOUT_RMSE = 1e-3  # the cut-out scene against its geometric twin
CUTOUT_OFF = 2e-3  # a pixel "differs" past this (logged)
ROUNDTRIP_TOL = 1e-5  # tests/unit/test_export.py:102-121
FENCE_TEXELS = 16
# the fence: a vertical quad x in [x0, x1], y in [y0, y1] at depth z,
# between the bunny preset's camera and the blob, under the lamp's edge
FENCE = (-2.4, 1.8, 0.0, 3.4, -1.75)
# the reference's checkpoint keys (tpurt/render/checkpoint.py)
CHECKPOINT_KEYS = {"version", "accum", "n_samples", "seed", "batch_index",
                   "config_json"}


def fence_rgba():
    """(16, 16, 4) f32: a distinct RGB per texel and a checkerboard alpha
    (texels with an even row + column opaque)."""
    import numpy as np

    i, j = np.indices((FENCE_TEXELS, FENCE_TEXELS))
    rgba = np.ones((FENCE_TEXELS, FENCE_TEXELS, 4), np.float32)
    rgba[..., 0] = (j + 0.5) / FENCE_TEXELS
    rgba[..., 1] = (i + 0.5) / FENCE_TEXELS
    rgba[..., 2] = ((i * 7 + j * 3) % FENCE_TEXELS + 0.5) / FENCE_TEXELS
    rgba[..., 3] = (i + j + 1) % 2
    return rgba


def _fence_corners(u0=0.0, v0=0.0, u1=1.0, v1=1.0):
    """The fence's sub-rectangle over uv [u0, u1] × [v0, v1] (v-down: v 0
    is the top edge): four corners, two triangles, their uvs."""
    import numpy as np

    x0, x1, y0, y1, z = FENCE
    x = lambda u: x0 + u * (x1 - x0)
    y = lambda v: y1 - v * (y1 - y0)
    verts = np.array([[x(u0), y(v0), z], [x(u1), y(v0), z],
                      [x(u1), y(v1), z], [x(u0), y(v1), z]], np.float32)
    uvs = np.array([[u0, v0], [u1, v0], [u1, v1], [u0, v1]], np.float32)
    return verts, np.array([[0, 1, 2], [0, 2, 3]], np.int32), uvs


def add_fence(scene, rgba, geometric: bool):
    """The fence into ``scene``: one quad textured with ``rgba`` and cut
    out at alpha 0.5, or (``geometric``) its opaque texels as real
    sub-quads, each with a Lambert material of its texel's colour — with
    nearest sampling the two are the same surface
    (tests/unit/test_alpha_cutout.py)."""
    import numpy as np

    from tpurt_torch.scene.types import LAMBERT, Instance, Material, Mesh

    if not geometric:
        tex = scene.add_texture(rgba)
        mat = scene.add_material(Material(
            LAMBERT, (1.0, 1.0, 1.0), base_color_texture=tex,
            alpha_cutoff=0.5, name="fence"))
        verts, idx, uvs = _fence_corners()
        mesh = Mesh(verts, idx, mat, uvs=uvs, name="fence")
    else:
        n = rgba.shape[0]
        vs, ids, mats = [], [], []
        for i, j in zip(*np.nonzero(rgba[..., 3] >= 0.5)):
            m = scene.add_material(Material(
                LAMBERT, tuple(float(c) for c in rgba[i, j, :3]),
                name=f"texel_{i}_{j}"))
            verts, idx, _ = _fence_corners(j / n, i / n, (j + 1) / n,
                                           (i + 1) / n)
            ids.append(idx + 4 * len(vs))
            vs.append(verts)
            mats += [m, m]
        mesh = Mesh(np.concatenate(vs), np.concatenate(ids),
                    np.asarray(mats, np.int32), name="fence_texels")
    scene.add_instance(Instance(scene.add_mesh(mesh), name=mesh.name))
    return scene


def fence_scenes(subdivisions: int = 6):
    """(cut-out scene, geometric twin): the bunny preset plus the
    fence."""
    from tpurt_torch.scene.procedural import bunny_standin

    rgba = fence_rgba()
    return (add_fence(bunny_standin(subdivisions), rgba, False),
            add_fence(bunny_standin(subdivisions), rgba, True))


def compare_twins(label, a, b):
    """RMSE and share of pixels off by more than CUTOUT_OFF between two
    images (mean radiance); raises past CUTOUT_RMSE."""
    import torch

    d = (a - b).float()
    rmse = float(torch.sqrt(torch.mean(d * d)))
    off = float((d.abs().amax(dim=-1) > CUTOUT_OFF).float().mean())
    log(f"[files] {label}: RMSE {rmse:.3e}, {off:.4%} of pixels differ by "
        f"more than {CUTOUT_OFF:g}")
    if not rmse <= CUTOUT_RMSE:
        raise AssertionError(f"{label}: RMSE {rmse:.3e} over {CUTOUT_RMSE}")
    return rmse, off


def cutout_twin_check(device, width, height, spp, subdivisions=6,
                      intersectors=("bvh_tile", "bvh_packet")):
    """Render the fence scene and its geometric twin through each
    intersector (the shade-record and the per-field alpha probes) at
    ``width``×``height`` × ``spp`` (2 bounces, NEE), each once as warmup
    and once with the launch counters zeroed around it; hold each pair
    to CUTOUT_RMSE. Returns {intersector: (cut-out stats, twin stats,
    cut-out launches)}; on the card the cut-out renderer's graphs are
    held to their kernel nodes."""
    from tpurt_torch import kernels as kn
    from tpurt_torch.render import framebuffer as fb
    from tpurt_torch.render import render_scene
    from tpurt_torch.render.intersectors import scene_meta
    from tpurt_torch.utils.config import get_config

    cut, twin = fence_scenes(subdivisions)
    if not scene_meta(cut).has_alpha_cutout or \
            scene_meta(twin).has_alpha_cutout:
        raise AssertionError("fence scenes: wrong alpha-cutout flags")
    out = {}
    for kind in intersectors:
        # the bunny preset's config; "custom" keeps the bunny's measured
        # live caps off a scene whose live counts differ
        cfg = get_config("bunny", scene="custom", width=width,
                         height=height, spp=spp, spp_per_batch=spp,
                         intersector=kind)
        runs = []
        for scene in (cut, twin):
            render_scene(cfg, device=device, scene=scene)
            kn.reset_launch_counts()
            state, stats = render_scene(cfg, device=device, scene=scene)
            runs.append((state, stats, kn.launch_counts()))
            r = staged_renderer()
            if scene is cut and r is not None and r.graphs:
                check_graph_nodes(f"fence {kind}", r)
        (a, sa, la), (b, sb, _) = runs
        for name, s in (("cut-out", sa), ("twin", sb)):
            if s["pair_overflow"]:
                raise AssertionError(f"fence {kind} {name}: pair overflow")
        log(f"[files] fence {kind} {width}x{height} x {spp} spp: cut-out "
            f"{sa['mrays_per_s']:.4f} Mrays/s ({sa['rays_traced']:.0f} rays "
            f"in {sa['elapsed_s']:.4f} s), twin {sb['mrays_per_s']:.4f} "
            f"Mrays/s ({sb['rays_traced']:.0f} rays in "
            f"{sb['elapsed_s']:.4f} s); cut-out launches {la}")
        if not bool(fb.resolve(a).isfinite().all()):
            raise AssertionError(f"fence {kind}: non-finite pixels")
        compare_twins(f"fence {kind} cut-out vs geometric twin",
                      fb.resolve(a), fb.resolve(b))
        out[kind] = (sa, sb, la)
    return out


def rgba_png(img) -> bytes:
    """(H, W, 4) uint8 → PNG bytes (color type 6, filter 0)."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                         axis=1)

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


def fence_gltf(path: str):
    """Write a .gltf by hand: the fence (an embedded base64 RGBA PNG,
    alphaMode MASK at 0.5) over a ground plane, an area light and a
    camera. Returns the same scene built in memory (the texture through
    the loader's sRGB → linear conversion)."""
    import base64
    import json

    import numpy as np

    from tpurt_torch.core.camera import Camera
    from tpurt_torch.render.png import srgb_to_linear
    from tpurt_torch.scene.types import (LAMBERT, Instance, Material, Mesh,
                                         Scene)

    u8 = np.round(fence_rgba() * 255.0).astype(np.uint8)
    ground = np.array([[-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6]],
                      np.float32)
    lamp = np.array([[-1.5, 5.5, -1.5], [1.5, 5.5, -1.5], [1.5, 5.5, 1.5],
                     [-1.5, 5.5, 1.5]], np.float32)
    fence, idx, uvs = _fence_corners()
    tri = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    blobs = [ground, tri, lamp, tri, fence, uvs, tri]
    views, off = [], 0
    for b in blobs:
        views.append({"buffer": 0, "byteOffset": off,
                      "byteLength": b.nbytes})
        off += b.nbytes
    acc = lambda v, n, t, c: {"bufferView": v, "componentType": c,
                              "count": n, "type": t}
    lambert = lambda rgb, em=(0.0, 0.0, 0.0), cut=0.0: {"tpurt": {
        "kind": LAMBERT, "albedo": list(rgb), "emission": list(em),
        "param0": 0.0, "param1": 0.0, "alpha_cutoff": cut}}
    cam = dict(position=[3.2, 2.6, -4.5], look_at=[0.0, 1.1, 0.0],
               up=[0.0, 1.0, 0.0], vfov_deg=38.0)
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1, 2, 3],
                    "extras": {"tpurt_background": [0.35, 0.45, 0.6]}}],
        "nodes": [{"mesh": 0, "name": "ground"}, {"mesh": 1, "name": "lamp"},
                  {"mesh": 2, "name": "fence"},
                  {"camera": 0, "name": "camera",
                   "extras": {"tpurt_camera": cam}}],
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.6632, "znear": 0.01}}],
        "meshes": [
            {"name": "ground", "primitives": [{
                "attributes": {"POSITION": 0}, "indices": 1,
                "material": 0}]},
            {"name": "lamp", "primitives": [{
                "attributes": {"POSITION": 2}, "indices": 3,
                "material": 1}]},
            {"name": "fence", "primitives": [{
                "attributes": {"POSITION": 4, "TEXCOORD_0": 5},
                "indices": 6, "material": 2}]}],
        "materials": [
            {"name": "ground", "extras": lambert((0.6, 0.6, 0.62))},
            {"name": "lamp", "extras": lambert((0.0, 0.0, 0.0),
                                               (10.0, 9.5, 9.0))},
            {"name": "fence", "alphaMode": "MASK", "alphaCutoff": 0.5,
             "pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                      "metallicFactor": 0.0},
             "extras": lambert((1.0, 1.0, 1.0), cut=0.5)}],
        "images": [{"uri": "data:image/png;base64,"
                    + base64.b64encode(rgba_png(u8)).decode()}],
        "textures": [{"source": 0}],
        "accessors": [acc(0, 4, "VEC3", 5126), acc(1, 6, "SCALAR", 5125),
                      acc(2, 4, "VEC3", 5126), acc(3, 6, "SCALAR", 5125),
                      acc(4, 4, "VEC3", 5126), acc(5, 4, "VEC2", 5126),
                      acc(6, 6, "SCALAR", 5125)],
        "bufferViews": views,
        "buffers": [{"byteLength": off, "uri":
                     "data:application/octet-stream;base64,"
                     + base64.b64encode(b"".join(
                         b.tobytes() for b in blobs)).decode()}],
    }
    with open(path, "w") as f:
        json.dump(doc, f)

    scene = Scene(name="fence", background=(0.35, 0.45, 0.6))
    tex = scene.add_texture(np.concatenate(
        [srgb_to_linear(u8[..., :3]),
         u8[..., 3:4].astype(np.float32) / 255.0], axis=2))
    m_ground = scene.add_material(Material(LAMBERT, (0.6, 0.6, 0.62)))
    m_lamp = scene.add_material(Material(LAMBERT, (0.0, 0.0, 0.0),
                                         emission=(10.0, 9.5, 9.0)))
    m_fence = scene.add_material(Material(
        LAMBERT, (1.0, 1.0, 1.0), base_color_texture=tex, alpha_cutoff=0.5))
    scene.add_material(Material())
    quad = idx
    for verts, mat, uv in ((ground, m_ground, None), (lamp, m_lamp, None),
                           (fence, m_fence, uvs)):
        scene.add_instance(Instance(scene.add_mesh(
            Mesh(verts, quad, mat, uvs=uv))))
    scene.camera = Camera.make(cam["position"], cam["look_at"], cam["up"],
                               cam["vfov_deg"])
    return scene


def cli(argv) -> str:
    """``python -m tpurt_torch`` in process; returns what it printed."""
    import contextlib as cl
    import io

    from tpurt_torch.cli import main as cli_main

    buf = io.StringIO()
    with cl.redirect_stdout(buf):
        rc = cli_main(argv)
    out = buf.getvalue().strip()
    log(f"[files] tpurt_torch {' '.join(argv)} → rc {rc}: "
        + out.replace("\n", " | "))
    if rc != 0:
        raise AssertionError(f"tpurt_torch {argv[0]} exited {rc}")
    return out


def accum_of(path):
    import numpy as np

    with np.load(path) as z:
        return z["accum"], int(z["n_samples"]), set(z.files)


def hold_roundtrip(label, got, want):
    """A file scene's render against its preset's: rtol and atol
    ROUNDTRIP_TOL (tests/unit/test_export.py)."""
    import numpy as np

    (a, na, _), (b, nb, _) = got, want
    if na != nb:
        raise AssertionError(f"{label}: {na} spp against {nb}")
    a, b = a / na, b / nb
    err = np.abs(a - b)
    bad = err > ROUNDTRIP_TOL + ROUNDTRIP_TOL * np.abs(b)
    log(f"[files] {label}: max |diff| {float(err.max()):.3e}, "
        f"{int(bad.sum())} of {bad.size} values past rtol/atol "
        f"{ROUNDTRIP_TOL:g}; bit-equal {bool((a == b).all())}")
    if bad.any():
        raise AssertionError(f"{label}: render differs from the preset's")


def native_check(bunny_obj: str) -> str:
    """The host library: loaded or why not; its OBJ parse equal to the
    Python parser on the bunny file, and its tree build holding the
    tree contract beside the Python twin's on the bunny's packet leaves."""
    import numpy as np

    from tpurt_torch.bvh import cluster
    from tpurt_torch.scene.obj import load_obj
    from tpurt_torch.utils import native

    lib = native.get_lib()
    if lib is None:
        log(f"[files] native host library not loaded, the Python twins "
            f"carry the run: {native.build_error()}")
        return "python"
    log(f"[files] native host library loaded: {native.SO}")
    a = load_obj(bunny_obj)
    with environ({"TPURT_NO_NATIVE": "1"}):
        b = load_obj(bunny_obj)
    for f in ("vertices", "indices", "normals", "material_ids"):
        x, y = getattr(a.meshes[0], f), getattr(b.meshes[0], f)
        if x.tobytes() != y.tobytes():
            raise AssertionError(f"native obj_parse: {f} differs from the "
                                 "Python parser's")
    rng = np.random.default_rng(0)
    c = rng.normal(size=(4096, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.2, (4096, 3)).astype(np.float32)
    trees = (native.bvh_build(c - h, c + h),
             tuple(cluster._median_split_tree(c - h, c + h)))
    for t in trees:
        lo, hi, first, count, skip = t
        m = first.shape[0]
        if not (m == 2 * 4096 - 1 and skip[0] == m
                and sorted(first[count > 0].tolist()) == list(range(4096))
                and (lo[0] == trees[1][0][0]).all()
                and (hi[0] == trees[1][1][0]).all()):
            raise AssertionError("native bvh_build breaks the tree contract")
    log(f"[files] native obj_parse equals the Python parser on "
        f"{a.num_triangles} bunny triangles; bvh_build and the Python twin "
        "both hold the tree contract over 4096 boxes (same root box, every "
        "item in one leaf; their leaf orders differ by design)")
    return "native"


def files_phase(device, launches: dict, bunny=(800, 600, 8),
                sponza=(1920, 1080, 2), fence_subdivisions=6) -> None:
    """Scene files, textures, cutout and the CLI on ``device`` (phase 6
    of the module docstring), at the bunny and sponza presets' sizes
    (width, height, spp) unless told smaller: the cut-out fence against
    its geometric twin, the OBJ and GLB round trips, a hand-written
    textured glTF, the sponza flythrough, checkpoint/resume and the
    native host library. Adds the launches of its main paths (the
    cut-out renders and the flythrough) to ``launches``."""
    import tempfile

    import numpy as np
    import torch

    from tpurt_torch import kernels as kn
    from tpurt_torch import render as rd
    from tpurt_torch.render import framebuffer as fb
    from tpurt_torch.render import render_scene
    from tpurt_torch.render.png import read_png
    from tpurt_torch.scene.device import to_device
    from tpurt_torch.scene.gltf import load_gltf
    from tpurt_torch.utils.config import get_config

    on_card = torch.device(device).type == "cuda"

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # 1. cut-out and textured, at the bunny preset's size
    for kind, (_, _, la) in cutout_twin_check(
            device, *bunny, subdivisions=fence_subdivisions).items():
        need = ("packet",) if kind == "bvh_packet" else ("entries",
                                                         "tileloop")
        for k in need:
            if on_card and la.get(k, 0) <= 0:
                raise AssertionError(f"fence {kind}: {k} never launched")
        add(la)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_files_")
    t = lambda name: os.path.join(tmp, name)
    cpu = [] if on_card else ["--cpu"]
    size = lambda w, h, spp: ["--width", str(w), "--height", str(h), "--spp",
                              str(spp), "--spp-per-batch", str(spp),
                              "--max-bounces", "2", *cpu]
    s_wh, b_wh = sponza, bunny
    sponza, bunny = size(*sponza), size(*bunny)

    # 2. OBJ round trip
    cli(["render", "--config", "bunny", *bunny, "--out", t("b.png"),
         "--checkpoint", t("b.npz")])
    cli(["export", "--config", "bunny", "--out", t("bunny.obj")])
    cli(["render", "--config", t("bunny.obj"), *bunny, "--out",
         t("b_obj.png"), "--checkpoint", t("b_obj.npz")])
    hold_roundtrip("bunny.obj against the bunny preset",
                   accum_of(t("b_obj.npz")), accum_of(t("b.npz")))

    # 3. GLB round trip
    cli(["render", "--config", "sponza", *sponza, "--out", t("s.png"),
         "--checkpoint", t("s.npz")])
    cli(["export", "--config", "sponza", "--out", t("sponza.glb")])
    cli(["render", "--config", t("sponza.glb"), *sponza, "--out",
         t("s_glb.png"), "--checkpoint", t("s_glb.npz")])
    hold_roundtrip("sponza.glb against the sponza preset",
                   accum_of(t("s_glb.npz")), accum_of(t("s.npz")))

    # 4. a hand-written glTF with a texture
    built = fence_gltf(t("fence.gltf"))
    loaded = load_gltf(t("fence.gltf"))
    a_ds = to_device(loaded, device="cpu")
    b_ds = to_device(built, device="cpu")
    for f in a_ds._fields:
        x, y = getattr(a_ds, f), getattr(b_ds, f)
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"fence.gltf: device array {f} differs "
                                 "from the scene built in memory")
    cfg = get_config("bunny", scene="custom", width=b_wh[0],
                     height=b_wh[1], spp=b_wh[2], spp_per_batch=b_wh[2])
    states = [render_scene(cfg, device=device, scene=s)[0]
              for s in (loaded, built)]
    same = bool(torch.equal(states[0].accum, states[1].accum))
    log(f"[files] fence.gltf: {len(a_ds._fields)} device arrays equal to "
        f"the scene built in memory; its render bit-equal {same}; image "
        f"mean {float(fb.resolve(states[0]).mean()):.6f}")
    if not same:
        raise AssertionError("fence.gltf: render differs from the scene "
                             "built in memory")

    # 5. flythrough
    frames_run = []  # (wall ms, batch stats) a frame
    plain = rd.render_scene

    def counted(*args, **kw):
        t0 = time.perf_counter()
        state, stats = plain(*args, **kw)  # ends with a device sync
        frames_run.append(((time.perf_counter() - t0) * 1e3, stats))
        return state, stats

    builds = rd.scene_context_builds()
    rd.render_scene = counted
    try:
        kn.reset_launch_counts()
        t0 = time.perf_counter()
        line = cli(["animate", "--config", "sponza", *sponza, "--frames",
                    "8", "--out-dir", t("frames")])
        wall = time.perf_counter() - t0
        la = kn.launch_counts()
    finally:
        rd.render_scene = plain
    n_builds = rd.scene_context_builds() - builds
    r = staged_renderer()
    if r is not None and r.graphs:
        check_graph_nodes("flythrough", r)
    later = frames_run[1:]
    rays = sum(float(st["counts_device"][0] + st["counts_device"][1])
               for _, st in later)
    later_ms = sum(ms for ms, _ in later)
    batch_s = sum(st["elapsed_s"] for _, st in later)
    frames = [read_png(t(f"frames/frame_{k:04d}.png")) for k in range(8)]
    first_equal = bool(np.array_equal(frames[0], read_png(t("s.png"))))
    distinct = all(not np.array_equal(frames[a], frames[b])
                   for a in range(8) for b in range(a + 1, 8))
    log(f"[files] flythrough sponza {s_wh[0]}x{s_wh[1]} x {s_wh[2]} spp "
        f"x 8 frames: "
        f"{wall:.4f} s for the command (scene load and PNG writes "
        f"included); frame 0 {frames_run[0][0]:.3f} ms with the scene "
        f"context's upload and accel build; frames 1-7 "
        f"{later_ms / len(later):.3f} ms a frame "
        f"({batch_s / len(later) * 1e3:.3f} ms of it the batch), "
        f"{rays:.0f} rays traced (device counters) = "
        f"{rays / (later_ms / 1e3) / 1e6:.4f} Mrays/s a frame, "
        f"{rays / batch_s / 1e6:.4f} Mrays/s in the batches; scene "
        f"contexts built {n_builds}; launches {la}; frame 0 bit-equal to "
        f"render's {first_equal}; frames pairwise distinct {distinct}")
    if n_builds != 1:
        raise AssertionError(f"flythrough built {n_builds} scene contexts")
    if not (first_equal and distinct):
        raise AssertionError("flythrough frames wrong")
    if "0 capped-frame" not in line:
        raise AssertionError("flythrough: frames re-rendered for overflow")
    for k in ("entries", "tileloop_tl_sc"):
        if on_card and la.get(k, 0) <= 0:
            raise AssertionError(f"flythrough: {k} never launched")
    add(la)

    # 6. resume
    half = ["--config", "bunny", "--width", str(b_wh[0]), "--height",
            str(b_wh[1]), "--spp-per-batch", "4", *cpu]
    cli(["render", *half, "--spp", "4", "--out", t("r4.png"),
         "--checkpoint", t("r4.npz")])
    cli(["render", *half, "--resume", t("r4.npz"), "--spp", "8", "--out",
         t("r8.png"), "--checkpoint", t("r8.npz")])
    cli(["render", *half, "--spp", "8", "--out", t("s8.png"),
         "--checkpoint", t("s8.npz")])
    (r, nr, keys), (s, ns, _) = accum_of(t("r8.npz")), accum_of(t("s8.npz"))
    log(f"[files] resume 4 → 8 spp: bit-equal to one 8-spp render "
        f"{r.tobytes() == s.tobytes()} ({nr} / {ns} spp); checkpoint keys "
        f"{sorted(keys)}")
    if keys != CHECKPOINT_KEYS:
        raise AssertionError(f"checkpoint keys {sorted(keys)}")
    if nr != ns or r.tobytes() != s.tobytes():
        raise AssertionError("resumed render differs from the straight one")

    # 7. native
    native_check(t("bunny.obj"))
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)


# the worlds of the mesh phase: (preset, config overrides, sample shards,
# tile shards, the kernels every rank must launch)
MESH_WORLDS = {
    "bunny_2x2": ("bunny", dict(spp=8, spp_per_batch=4), 2, 2,
                  ("entries", "tileloop")),
    "sponza_2x2": ("sponza", dict(spp=2, spp_per_batch=1), 2, 2,
                   ("entries", "tileloop_tl_sc")),
    "cornell_mega_2x1": ("cornell", dict(spp=16, spp_per_batch=8,
                                         pipeline="mega"), 2, 1,
                         ("tileloop_allpairs",)),
}
MESH_LIMIT_S = 300  # wall clock of one world, start-up included


def mesh_config(name: str, sharded: bool, size=None):
    """The world's config (its preset's size unless ``size`` = (width,
    height)), with its shards or without."""
    from tpurt_torch.utils.config import get_config

    preset, over, n_sample, n_tile, _ = MESH_WORLDS[name]
    if sharded:
        over = dict(over, n_sample_shards=n_sample, n_tile_shards=n_tile)
    if size:
        over = dict(over, width=size[0], height=size[1])
    return get_config(preset, **over)


def mesh_rank(name: str, out_dir: str, device: str, *size) -> int:
    """One rank of a mesh-phase world (torchrun's environment): join the
    world, render the sharded config twice (warmup, then timed with the
    launch counters zeroed around it), and write what the parent checks:
    rank{r}.json, and from rank 0 the two accumulations. On the card the
    rank loads the kernel library and records whether it had to build it."""
    import torch
    import torch.distributed as dist

    from tpurt_torch import kernels as kn
    from tpurt_torch.kernels import cuda_build
    from tpurt_torch.parallel import init_multihost
    from tpurt_torch.render import render_scene

    build_s = cuda_build.load().seconds if device == "cuda" else 0.0
    rank, world = init_multihost(device=device)
    config = mesh_config(name, sharded=True, size=[int(v) for v in size])
    warm, _ = render_scene(config, device=device)
    kn.reset_launch_counts()
    state, stats = render_scene(config, device=device)
    launches = kn.launch_counts()
    if rank == 0:
        torch.save({"accum": state.accum.cpu(), "warm": warm.accum.cpu()},
                   os.path.join(out_dir, "accum.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": world,
                   "backend": dist.get_backend(), "device": stats["device"],
                   "build_s": build_s, "launches": launches,
                   "spp": stats["spp"], "elapsed_s": stats["elapsed_s"],
                   "rays_closest": stats["rays_closest"],
                   "rays_shadow": stats["rays_shadow"],
                   "mrays_per_s": stats["mrays_per_s"],
                   "live_overflow": stats["live_overflow"],
                   "pair_overflow": stats["pair_overflow"]}, f)
    return 0


def run_world(name: str, out_dir: str, device: str, size=()) -> list:
    """The world's ranks as children on a free port; their rank{r}.json
    records. Any nonzero exit, or the limit running out (the whole world
    is then killed), raises."""
    import signal
    import socket

    _, _, n_sample, n_tile, _ = MESH_WORLDS[name]
    n = n_sample * n_tile
    # the coordinator's port stays bound (SO_REUSEADDR, not listening)
    # until the world ends: no other bind takes it before rank 0's store
    held = socket.socket()
    held.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    held.bind(("localhost", 0))
    port = held.getsockname()[1]
    procs, logs = [], []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        logs.append(open(os.path.join(out_dir, f"rank{r}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", name,
             out_dir, device, *map(str, size)], cwd=ROOT, env=env, stdout=logs[-1],
            stderr=subprocess.STDOUT, start_new_session=True))
    deadline = time.perf_counter() + MESH_LIMIT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.perf_counter(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        held.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in failed:
        logs[r].seek(0)
        log(f"[mesh] {name} rank {r} exit {procs[r].returncode}; its output "
            "ends: " + logs[r].read()[-3000:].replace("\n", " | "))
    for f in logs:
        f.close()
    if failed:
        raise AssertionError(f"{name}: ranks {failed} failed or ran past "
                             f"{MESH_LIMIT_S} s")
    out = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def mesh_phase(device, launches: dict, smi: str, sizes=None) -> None:
    """Phase 7 of the module docstring: each world against this process's
    render of the same sample window on ``device`` (the ranks on its
    type: cuda:0 from the card, CPU ranks for a dry run), at the presets'
    sizes unless ``sizes`` maps a world to (width, height)."""
    import shutil
    import tempfile

    import torch

    from tpurt_torch import kernels as kn
    from tpurt_torch.render import render_scene

    on_card = torch.device(device).type == "cuda"
    for name, (_, _, n_sample, n_tile, need) in MESH_WORLDS.items():
        size = (sizes or {}).get(name, ())
        config = mesh_config(name, sharded=False, size=size)
        warm, _ = render_scene(config, device=device)
        kn.reset_launch_counts()
        single, s_stats = render_scene(config, device=device)
        s_launches = kn.launch_counts()
        del warm
        if on_card:
            torch.cuda.empty_cache()
        out_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
        t0 = time.perf_counter()
        ranks = run_world(name, out_dir, torch.device(device).type, size)
        wall = time.perf_counter() - t0
        got = torch.load(os.path.join(out_dir, "accum.pt"))
        shutil.rmtree(out_dir, ignore_errors=True)
        want = single.accum.cpu()
        r0 = ranks[0]
        same = bool(torch.equal(got["accum"], want))
        d = (got["accum"] - want).abs()
        counts_same = (r0["rays_closest"] == s_stats["rays_closest"]
                       and r0["rays_shadow"] == s_stats["rays_shadow"])
        warm_same = bool(torch.equal(got["warm"], got["accum"]))
        log(f"[mesh] {name}: {config.width}x{config.height} x {r0['spp']} "
            f"spp on {n_sample} sample x {n_tile} tile shards, "
            f"{len(ranks)} ranks on {sorted({r['device'] for r in ranks})}, "
            f"backend {r0['backend']}; world {wall:.2f} s wall (start-up "
            f"and scene builds included); rank builds "
            f"{[r['build_s'] for r in ranks]} s; rank 0's timed render "
            f"{r0['rays_closest'] + r0['rays_shadow']:.0f} rays in "
            f"{r0['elapsed_s']:.4f} s = {r0['mrays_per_s']:.4f} Mrays/s "
            f"(ranks {[round(r['mrays_per_s'], 4) for r in ranks]}) against "
            f"the single process's {s_stats['rays_traced']:.0f} rays in "
            f"{s_stats['elapsed_s']:.4f} s = {s_stats['mrays_per_s']:.4f} "
            f"Mrays/s, {smi}; the ranks share one card, so this measures no "
            f"scaling; launches by rank {[r['launches'] for r in ranks]}, "
            f"single {s_launches}; rank 0's accumulation bit-equal to the "
            f"single process's {same} ({int((d > 0).any(dim=-1).sum())} "
            f"pixels differ, max |diff| {float(d.max()):.3e}); closest and "
            f"shadow counters equal {counts_same} ({r0['rays_closest']:.0f} "
            f"/ {r0['rays_shadow']:.0f} against "
            f"{s_stats['rays_closest']:.0f} / {s_stats['rays_shadow']:.0f}); "
            f"warmup bit-equal {warm_same}")
        for r in ranks:
            if r["build_s"] != 0.0:
                raise AssertionError(f"{name}: rank {r['rank']} compiled the "
                                     "kernels")
            if r["pair_overflow"] or r["live_overflow"]:
                raise AssertionError(f"{name}: rank {r['rank']} ended with "
                                     "an overflow")
            for k in need if on_card else ():
                if r["launches"].get(k, 0) <= 0:
                    raise AssertionError(f"{name}: rank {r['rank']} never "
                                         f"launched {k}")
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        if not (same and counts_same and warm_same):
            raise AssertionError(f"{name}: the world's render differs from "
                                 "the single process's")


# --- 8. the stage programs as CUDA graphs --------------------------------

# each path of the graphs phase: (preset, spp, config overrides, scene
# or None for the preset's own): the preset's size, its measured caps
GRAPH_PATHS = {
    "bunny": ("bunny", 8, {}, None),
    "sponza": ("sponza", 2, {}, None),
    "cornell": ("cornell", 16, {}, None),
    "hello_triangle": ("hello_triangle", 1, {}, None),
    "bunny_sorted": ("bunny", 8, dict(sorted_wave=True), None),
    "bunny_packet": ("bunny", 8, dict(intersector="bvh_packet"), None),
    # "custom" keeps the bunny's measured caps off the fence's waves
    "fence": ("bunny", 8, dict(scene="custom"), "fence"),
}
# the loops each path runs: (label, switches, graphs keyword)
GRAPH_MODES = (
    ("eager", dict(TPURT_FUSE_STAGES="0"), False),  # the default loop
    ("unfused", dict(TPURT_FUSE_STAGES="0"), True),
    ("stages_eager", dict(TPURT_FUSE_STAGES="1"), False),
    ("stages", dict(TPURT_FUSE_STAGES="1"), True),
    ("whole_eager", dict(TPURT_FUSE_BOUNCES="1"), False),
    ("whole", dict(TPURT_FUSE_BOUNCES="1"), True),
)
GRAPH_TIMED = ("eager", "unfused", "stages", "whole")  # timed in turns
GRAPHED = ("unfused", "stages", "whole")  # the modes that capture


def graph_renderers(name: str, device):
    """The path's scene and camera, and one StagedRenderer per loop of
    GRAPH_MODES that applies to it (the whole batch is not for flat
    shading or the sorted loop: there its switch leaves the loop as it
    is, and the path keeps the other modes)."""
    from tpurt_torch.render import build_accel
    from tpurt_torch.render.intersectors import scene_meta
    from tpurt_torch.render.staged import StagedRenderer
    from tpurt_torch.scene.device import to_device
    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.utils import autotune
    from tpurt_torch.utils.config import get_config

    preset, spp, over, scene = GRAPH_PATHS[name]
    config = get_config(preset, spp=spp, **over)
    config = get_config(preset, spp=spp,
                        live_caps=autotune.live_caps_for(config),
                        shadow_caps=autotune.want_caps_for(config), **over)
    scene = (fence_scenes()[0] if scene == "fence"
             else load_scene(config.scene))
    meta = scene_meta(scene)
    ds = to_device(scene, device=device)
    accel = build_accel(config, ds, meta, scene=scene, device=device)
    out = {}
    for label, env, graphs in GRAPH_MODES:
        with environ(env):
            r = StagedRenderer(ds, accel, meta=meta, config=config,
                               device=device, graphs=graphs)
        if label.startswith("whole") and r.mode != "whole":
            continue
        out[label] = r
    return scene, config, out


def idle_share(fn) -> tuple:
    """(device idle share of ``fn()``'s wall time, busy ms, kernels the
    profiler saw): ``torch.profiler`` over one call that ends in a
    synchronize, as ``utils/profiling.py`` reads a batch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            busy += getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)) / 1e3
            n += e.count
    return max(0.0, 1.0 - busy / (wall * 1e3)), busy, n


def graphs_phase(device, smi: str) -> None:
    """Phase 8 of the module docstring on ``device`` (a CPU dry run has
    no graphs: every loop runs eagerly there)."""
    import torch

    from tpurt_torch import kernels as kn
    from tpurt_torch.core.camera import Camera

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for name in GRAPH_PATHS:
        t_path = time.perf_counter()
        scene, config, rs = graph_renderers(name, device)
        spp = config.spp_per_batch
        cam = scene.camera
        # a second camera: 2% of the way to the look-at point
        moved = Camera(cam.position + 0.02 * (cam.look_at - cam.position),
                       cam.look_at, cam.up, cam.vfov_deg)
        inputs = ((cam, config.seed, 0), (cam, config.seed, spp),
                  (moved, config.seed, 0))
        info = {k: (r.mode, r.graphs, r.graph_reason) for k, r in rs.items()}
        log(f"[graphs] {name} {config.width}x{config.height} x {spp} spp: "
            f"loops {info}")
        # the unfused and the stage graphs captured by prewarm; the whole
        # batch's by its first batch (the warm-up chain's result is that
        # batch's)
        cap = {}
        for label in ("unfused", "stages"):
            sync()
            t0 = time.perf_counter()
            kn.reset_launch_counts()
            n = rs[label].prewarm(cam, config.seed, 0)
            sync()
            cap[label] = (n, time.perf_counter() - t0, kn.launch_counts())
        results = {}
        for label, r in rs.items():
            runs = []
            for c, seed, s0 in inputs:
                kn.reset_launch_counts()
                sync()
                t0 = time.perf_counter()
                img, rays = r(c, seed, s0)
                sync()
                runs.append((img, rays, kn.launch_counts(),
                             time.perf_counter() - t0))
            results[label] = runs
        if "whole" in rs:
            cap["whole"] = (len(rs["whole"]._graphs or ()),
                            results["whole"][0][3], results["whole"][0][2])
        for label, (n, sec, counts) in cap.items():
            log(f"[graphs] {name} {label}: {n} graphs; prewarm / first "
                f"batch {sec:.3f} s (warm-up batch and captures), its "
                f"launches {counts}")
            if on_card and rs[label].graphs and n != len(
                    rs[label].programs()):
                raise AssertionError(f"{name} {label}: {n} graphs captured")
        # bit-equal: each graph mode to its split run eagerly, the stage
        # split to the default loop, batch by batch, launches too
        pairs = [("unfused", "eager"), ("stages", "stages_eager"),
                 ("stages_eager", "eager"), ("whole", "whole_eager")]
        for got, want in pairs:
            if got not in results:
                continue
            for k, ((ig, rg, lg, _), (iw, rw, lw, _)) in enumerate(
                    zip(results[got], results[want])):
                same = torch.equal(ig, iw) and torch.equal(rg, rw)
                launches_same = lg == lw
                log(f"[graphs] {name} {got} against {want}, batch {k} "
                    f"{inputs[k][1:]}{' moved camera' if k == 2 else ''}: "
                    f"image and counters bit-equal {same}; launches {lg}"
                    f"{'' if launches_same else f' against {lw}'}")
                if not (same and launches_same):
                    raise AssertionError(f"{name}: {got} differs from "
                                         f"{want} at batch {k}")
        # each graph mode's counts a replay held to its kernel nodes
        for label in GRAPHED:
            if label in rs and rs[label].graphs:
                check_graph_nodes(f"{name} {label}", rs[label])
        if "whole" in results:
            for k, ((iw, rw, _, _), (ie, re, _, _)) in enumerate(
                    zip(results["whole"], results["eager"])):
                d = (iw - ie).abs() / spp
                rmse = float(torch.sqrt((d * d).mean()))
                off = float((d > 1e-3).float().mean())
                diff = {i: (float(rw[i]), float(re[i]))
                        for i in range(rw.shape[0]) if rw[i] != re[i]}
                log(f"[graphs] {name} whole batch (uncapped waves) against "
                    f"the default loop, batch {k}: RMSE {rmse:.3e}, "
                    f"{off:.4%} of pixels off by more than 1e-3; counters "
                    f"that differ (slot: whole, default) {diff}")
                if not (rmse <= GOLDEN_RMSE and off < ALTERNATE_OFF):
                    raise AssertionError(f"{name}: the whole batch differs "
                                         "from the default loop")
        # Mrays/s in turns, one batch a turn, after an untimed round (a
        # capture empties the allocator's cache: an eager batch after
        # one allocates anew)
        timed = [k for k in GRAPH_TIMED if k in rs]
        times = {k: [] for k in timed}
        for label in timed:
            rs[label](cam, config.seed, 0)
        for label in timed + timed[::-1]:
            sync()
            t0 = time.perf_counter()
            _, rays = rs[label](cam, config.seed, 0)
            sync()
            times[label].append((float(rays[0] + rays[1]),
                                 time.perf_counter() - t0))
        log(f"[graphs] {name} Mrays/s in turns ({smi}): " + ", ".join(
            f"{k} " + " / ".join(f"{n / t / 1e6:.4f}" for n, t in v)
            for k, v in times.items()))
        if name == "bunny" and on_card:
            share = {k: idle_share(lambda r=rs[k]: r(cam, config.seed, 0))
                     for k in ("eager", "stages")}
            log(f"[graphs] bunny device idle share of one batch "
                f"(torch.profiler, {smi}): " + ", ".join(
                    f"{k} {v[0]:.4f} (busy {v[1]:.3f} ms, {v[2]} kernels)"
                    for k, v in share.items()))
        del rs, results
        if on_card:
            torch.cuda.empty_cache()
        log(f"[graphs] {name}: {time.perf_counter() - t_path:.1f} s")


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    from tpurt_torch.utils.profiling import nvidia_smi_line

    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    keep_graphs()  # check_graph_nodes reads every graph the run captures
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    # 2. build
    from tpurt_torch.kernels import cuda_build

    lib = cuda_build.load()
    log(f"[build] {lib.path} in {lib.seconds:.2f} s")
    for line in lib.log.splitlines():
        if ("registers" in line or "spill" in line or "error" in line
                or "Compiling entry" in line):
            log(f"[build] {line.strip()}")

    # 3. kernels against their plain versions, the shade kernel against
    # the loop's PyTorch shade
    report = check_kernels(device)
    report.append(shade_phase(device))
    report.append(raysort_phase(device))
    k2_live = k2_live_phase(device)

    # 4. render: each preset's main path, then the goldens
    launches, images, mrays, base = {}, {}, {}, {}
    for name in PATHS:
        base[name], images[name], stats = render_path(name, device)
        mrays[name] = stats["mrays_per_s"]
        for k, v in base[name].items():
            launches[k] = launches.get(k, 0) + v
    log(f"[render] Mrays/s a path ({smi}): "
        + ", ".join(f"{k} {v:.4f}" for k, v in mrays.items()))
    # the clamp at its last attempt keeps every cluster, and the pair
    # segments hold the entry rows' entries in the same order: both must
    # give the bunny path's image bit for bit
    for name in ("bunny_budget", "bunny_seg"):
        same = bool(torch.equal(images[name], images["bunny"]))
        log(f"[render] {name} image bit-equal to the bunny path's {same}")
        if not same:
            raise AssertionError(f"{name}: image differs from the bunny "
                                 "path's")
    for name in ALTERNATE_BUNNY:
        compare_accums(name, images[name], images["bunny"], PATHS[name][1])
    sorted_cap_check(device, images["bunny_sorted"])
    images = {k: images[k] for k in ("bunny", "sponza")}
    golden_phase(device)

    # 5. the reference's switches
    variants_phase(device, launches, images, base, mrays, smi)
    del images

    # 6. files and CLI
    files_phase(device, launches)

    # 7. worlds of ranks on the card
    mesh_phase(device, launches, smi)
    for k in report:
        k["launches"] = launches.get(k["name"], 0)

    # 8. the stage programs as CUDA graphs
    graphs_phase(device, smi)

    # 9. report
    print(json.dumps({"kernels": report, "k2_live": k2_live}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(*sys.argv[2:]))
    rc = main()
    print(f"[chip_smoke] {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    sys.exit(rc)
