#!/usr/bin/env python3
"""Smoke run of tpurt_torch's main path on one CUDA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and prints no result:

  1. device   — require CUDA; print the card's name and the nvidia-smi
                name/power-limit line;
  2. build    — compile the CUDA kernels from tpurt_torch/csrc with nvcc;
  3. kernels  — take the first bounce wave (and the first shadow wave) of
                a bunny 800×600 × 8 spp batch, run each kernel wrapper on
                it and hold the result against its plain PyTorch version
                on the same inputs: the entry build (K2) bit-equal, the
                tile loop (K1, closest and lean any-hit) with the slot
                equal on ≥ 99.99% of live rays and bt within 1e-6
                relative on those; time both with CUDA events;
  4. render   — the bunny preset at 800×600, spp=8 (one batch) through
                render_scene(device="cuda"): one warmup, then one timed
                run with the launch counters zeroed just before it; both
                kernels must have launched, the image must be finite and
                bit-equal to the warmup's (same seed);
                then the bunny golden fixture on the card against
                tests/golden/data/bunny.npz (RMSE ≤ 1e-3);
  5. report   — one JSON line per kernel set, the nvidia-smi line, and
                last the {"ok": true, "device": ...} line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

GOLDEN_RMSE = 1e-3  # tests/golden/test_golden.py
K1_SLOT_AGREE = 0.9999  # share of live rays whose slot must match
K1_T_RTOL = 1e-6
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def first_waves(device):
    """The first bounce wave (closest) and the first shadow wave (any-hit)
    of a bunny 800×600 × 8 spp batch, prepared exactly as the tile
    intersector prepares a sorted wave (scene-exit cap, octant sort)."""
    import torch

    from tpurt_torch.render import build_accel
    from tpurt_torch.render.intersectors import scene_meta
    from tpurt_torch.render.staged import StagedRenderer
    from tpurt_torch.scene.device import to_device
    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.kernels import tilewave as tw
    from tpurt_torch.utils.config import get_config

    config = get_config("bunny", spp=8)
    scene = load_scene(config.scene)
    meta = scene_meta(scene)
    ds = to_device(scene, device)
    accel = build_accel(config, ds, meta, scene=scene, device=device)
    r = StagedRenderer(ds, accel, meta=meta, config=config, device=device)
    sampler = r.sampler(config.seed, 0)
    state = r.raygen(scene.camera, config.seed, 0)
    hit, state = r.trace(state, 0)
    state, shadow = r.shade(state, hit, sampler, 0)

    lo, hi = accel.cluster_lo, accel.cluster_hi
    lo_all, hi_all = lo.amin(dim=0), hi.amax(dim=0)
    ext = hi_all - lo_all
    diag = torch.sqrt(ext[0] * ext[0] + ext[1] * ext[1] + ext[2] * ext[2])
    scale = tw.tn_scale_of(lo.cpu().numpy(), hi.cpu().numpy())

    def prepare(org, dirn, tmax):
        tmv = torch.where(torch.isfinite(tmax), tmax, tw.BIG)
        tmv = tw._scene_exit_cap(org, dirn, tmv, lo_all, hi_all, diag)
        keys = tw._octant_sort_keys(org, dirn, tmv, lo_all, hi_all)
        perm = torch.sort(keys, stable=True).indices
        org, dirn, tmv = (org[perm].contiguous(), dirn[perm].contiguous(),
                          tmv[perm].contiguous())
        return org, dirn, tw._safe_inv(dirn), tmv

    bounce = prepare(state.org, state.dirn,
                     torch.where(state.alive, math.inf, -1.0))
    shadow_wave = prepare(shadow[0], shadow[1], shadow[2])
    return accel, scale, bounce, shadow_wave


def check_kernels(device) -> list:
    """Phase 3: each kernel against its plain version at main-path shapes."""
    import torch

    from tpurt_torch.kernels import tilewave as tw

    accel, scale, bounce, shadow = first_waves(device)
    lo, hi, rows = accel.cluster_lo, accel.cluster_hi, accel.tri_rows
    n_tiles = bounce[0].shape[0] // tw.TILE
    log(f"[kernels] wave: {bounce[0].shape[0]} rays = {n_tiles} tiles, "
        f"C = {lo.shape[0]} clusters, scale = {scale!r}")
    report = []

    # K2 on the bounce wave
    org, dirn, inv_d, tmv = bounce
    k2 = tw.entries_cuda(org, inv_d, tmv, lo, hi, scale)
    p2 = tw.entries_plain(org, inv_d, tmv, lo, hi, scale)
    torch.cuda.synchronize()
    k2_bad = int((k2 != p2).sum())
    log(f"[kernels] K2 entries {tuple(k2.shape)}: {k2_bad} words differ "
        f"from the plain version")
    if k2_bad:
        raise AssertionError("K2 is not bit-equal to entries_plain")
    ms_k2 = cuda_ms(lambda: tw.entries_cuda(org, inv_d, tmv, lo, hi, scale),
                    10)
    ms_p2 = cuda_ms(lambda: tw.entries_plain(org, inv_d, tmv, lo, hi, scale),
                    2)
    log(f"[kernels] K2 {ms_k2:.3f} ms, plain {ms_p2:.3f} ms")
    report.append(dict(
        name="entries", route="cuda", source="tpurt_torch/csrc/entries.cu",
        replaces="tpurt/kernels/tilewave.py:843", max_abs_err=0.0,
        ms=ms_k2, plain_ms=ms_p2, mismatches=k2_bad))

    # K1 closest on the bounce wave, lean any-hit on the shadow wave
    k1_stats = {}
    for label, wave, any_hit in (("closest", bounce, False),
                                 ("any-hit", shadow, True)):
        org, dirn, inv_d, tmv = wave
        entry = tw.exact_entries(org, inv_d, tmv, lo, hi, scale)
        counts = (entry != tw.INT32_MAX).sum(dim=1, dtype=torch.int32)
        entry = torch.sort(entry, dim=1).values
        args = (org, dirn, inv_d, tmv, rows, entry, counts, scale, any_hit)
        kt, ku, kv, ks = tw.tileloop_cuda(*args)
        pt, pu, pv, ps = tw.tileloop_plain(*args)
        torch.cuda.synchronize()
        live = tmv >= 0.0
        n_live = int(live.sum())
        same = live & (ks == ps)
        agree = int(same.sum()) / max(n_live, 1)
        err = (kt - pt).abs()
        rel = err / torch.clamp_min(pt.abs(), 1e-30)
        diff = torch.maximum(err, torch.maximum((ku - pu).abs(),
                                                (kv - pv).abs()))
        max_rel = float(rel[same].max()) if bool(same.any()) else 0.0
        max_abs = float(diff[same].max()) if bool(same.any()) else 0.0
        log(f"[kernels] K1 {label}: {n_live} live rays, "
            f"{n_live - int(same.sum())} slot mismatches "
            f"(agree {agree:.6f}), bt max rel err {max_rel:.3e}, "
            f"max abs err (bt/bu/bv) {max_abs:.3e}, "
            f"{int(counts.sum())} (tile, cluster) entries")
        if agree < K1_SLOT_AGREE or max_rel > K1_T_RTOL:
            raise AssertionError(f"K1 {label} disagrees with tileloop_plain")
        ms_k = cuda_ms(lambda: tw.tileloop_cuda(*args), 10)
        ms_p = cuda_ms(lambda: tw.tileloop_plain(*args), 1)
        log(f"[kernels] K1 {label} {ms_k:.3f} ms, plain {ms_p:.3f} ms")
        k1_stats[label] = dict(ms=ms_k, plain_ms=ms_p, max_abs_err=max_abs,
                               mismatches=n_live - int(same.sum()))
    c, a = k1_stats["closest"], k1_stats["any-hit"]
    report.append(dict(
        name="tileloop", route="cuda", source="tpurt_torch/csrc/tileloop.cu",
        replaces="tpurt/kernels/tilewave.py:1191",
        max_abs_err=max(c["max_abs_err"], a["max_abs_err"]),
        ms=c["ms"], plain_ms=c["plain_ms"], mismatches=c["mismatches"],
        anyhit_ms=a["ms"], anyhit_plain_ms=a["plain_ms"],
        anyhit_mismatches=a["mismatches"]))
    return report


def golden_configs() -> dict:
    """GOLDENS from tests/golden/configs.py, loaded by path (an installed
    package named ``tests`` may shadow the repository's)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "golden_configs", os.path.join(ROOT, "tests", "golden", "configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GOLDENS


def render_phase(device):
    """Phase 4: the main path end to end, then the golden fixture."""
    import numpy as np
    import torch

    from tpurt_torch.kernels import tilewave as tw
    from tpurt_torch.render import framebuffer as fb
    from tpurt_torch.render import render_scene
    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.utils.config import get_config

    config = get_config("bunny", spp=8)  # 800×600, 8 spp per batch
    scene = load_scene(config.scene)
    warm, _ = render_scene(config, device=device, scene=scene)  # warmup
    tw.reset_launch_counts()
    state, stats = render_scene(config, device=device, scene=scene)
    launches = {"entries": tw.entries_cuda.launches,
                "tileloop": tw.tileloop_cuda.launches}
    img = fb.resolve(state)
    finite = bool(torch.isfinite(img).all())
    same = bool(torch.equal(warm.accum, state.accum))
    log(f"[render] bunny {config.width}x{config.height} x {stats['spp']} spp:"
        f" {stats['rays_traced']:.0f} rays ({stats['rays_closest']:.0f} "
        f"closest + {stats['rays_shadow']:.0f} shadow) in "
        f"{stats['elapsed_s']:.4f} s = {stats['mrays_per_s']:.4f} Mrays/s; "
        f"live {stats['live_counts']}, want {stats['want_counts']}, "
        f"live_overflow {stats['live_overflow']}; launches {launches}; "
        f"image finite {finite}, mean {float(img.mean()):.6f}; "
        f"bit-equal to the warmup render (same seed) {same}")
    if not finite:
        raise AssertionError("rendered image has non-finite pixels")
    if not same:
        raise AssertionError("two renders with the same seed differ")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched in the "
                                 "main-path render")

    golden = np.load(os.path.join(ROOT, "tests", "golden", "data",
                                  "bunny.npz"))
    gcfg = get_config("bunny", **golden_configs()["bunny"])
    gstate, _ = render_scene(gcfg, device=device)
    gimg = fb.resolve(gstate).cpu().numpy()
    rmse = float(np.sqrt(np.mean((gimg - golden["image"]) ** 2)))
    log(f"[render] golden bunny {gcfg.width}x{gcfg.height} x {gcfg.spp} spp:"
        f" RMSE {rmse:.3e} (limit {GOLDEN_RMSE})")
    if not rmse <= GOLDEN_RMSE:
        raise AssertionError("golden bunny RMSE over the limit")
    return launches, stats


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    # 2. build
    from tpurt_torch.kernels import cuda_build

    lib = cuda_build.load()
    log(f"[build] {lib.path} in {lib.seconds:.2f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build] {line.strip()}")

    # 3. kernels against their plain versions
    report = check_kernels(device)

    # 4. render
    launches, _ = render_phase(device)
    for k in report:
        k["launches"] = launches[k["name"]]

    # 5. report
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t_start = time.perf_counter()
    rc = main()
    print(f"[chip_smoke] {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr)
    sys.exit(rc)
