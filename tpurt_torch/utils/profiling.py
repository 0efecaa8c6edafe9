"""Tracing and profiling — port of ``tpurt.utils.profiling``, and where
one render batch spends its device time.

The reference's helpers, on torch:

  * ``trace(dir)``   — ``torch.profiler`` (CPU, and CUDA where the card is
                       in use) → a Chrome/Perfetto JSON trace in ``dir``
                       (open it in ui.perfetto.dev);
  * ``timed(name)``  — a wall-clock bracket that waits for the current
                       CUDA device at its exit, so the number covers the
                       device work queued inside it;
  * ``frame_log(…)`` — the structured per-frame log line, optionally
                       appended to a JSONL file.

The per-stage profiler:

    python3 -m tpurt_torch.utils.profiling [--preset bunny] [--out FILE]
        [--intersector bvh_tile|bvh_pair|bvh_packet] [--pairs-per-tile K]
        [--pairs-per-ray K]

Renders one warm batch of the preset on CUDA three times, with the given
intersector and pair budgets (no budget retries; the overflow flag is
reported): once by the host clock, once with CUDA events around every
stage of the staged loop's active path (by default the stage graphs
trace[b], shade_occlude[b] and resolve; under ``TPURT_FUSE_STAGES=0``
raygen, trace[b], shade[b], occlude[b] and resolve; under
``TPURT_FUSE_BOUNCES=1`` the batch alone) and the raster scatter, and
once under ``torch.profiler`` for device time by kernel
name and the device's busy share of the batch's wall time. With
``bvh_packet`` it also reports the walk's counters on the primary wave
(node steps and leaf rows, summed over its rays). The switches
(``TPURT_*``) are read from the environment and recorded. Prints one JSON object (and writes it to
``--out``) with the card's name and power limit beside every number.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from typing import Optional


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None):
    """``torch.profiler`` trace of everything inside the block, written to
    ``log_dir/trace.json`` at its end (the block gets that path). CUDA
    activity is traced when ``cuda`` is true, by default when a CUDA
    device is available."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def timed(name: str, sink: Optional[dict] = None, verbose: bool = False):
    """Wall-clock bracket; at exit it waits for the current CUDA device
    (where CUDA is initialised) so the time covers the work queued inside
    (kernels launch asynchronously). Adds the seconds to ``sink[name]``
    and, ``verbose``, prints them in ms."""
    import torch

    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + dt
        if verbose:
            print(f"[tpurt] {name}: {dt * 1e3:.2f} ms")


def frame_log(frame: int, samples: int, rays: float, seconds: float,
              chips: int = 1, jsonl_path: Optional[str] = None) -> str:
    """Structured per-frame log line (the reference's keys and rounding);
    appended to ``jsonl_path`` when one is given."""
    rec = {
        "frame": frame,
        "samples": samples,
        "rays": int(rays),
        "mrays_per_s": round(rays / max(seconds, 1e-9) / 1e6, 3),
        "frame_ms": round(seconds * 1e3, 2),
        "chips": chips,
    }
    line = json.dumps(rec)
    if jsonl_path:
        with open(jsonl_path, "a") as f:
            f.write(line + "\n")
    return line


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them: the
    line every time measured on the card is reported beside."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _stage_times(renderer, cam, seed):
    """Device ms per stage of one batch of the renderer's active loop
    (CUDA events between its stages — between the graphs' replays where
    it runs them; the whole batch is one stage; no host syncs), and the
    raster scatter as "frame"."""
    import torch

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    mark("start")
    renderer.frame(*renderer.shard(cam, seed, 0, mark=mark))
    mark("frame")
    torch.cuda.synchronize()
    return {name: marks[i - 1][1].elapsed_time(ev)
            for i, (name, ev) in enumerate(marks) if i}


def profile_batch(preset: str = "bunny", **overrides) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpurt_torch import kernels
    from tpurt_torch.render import build_accel
    from tpurt_torch.render.intersectors import scene_meta
    from tpurt_torch.render.staged import StagedRenderer
    from tpurt_torch.scene.device import to_device
    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.utils import autotune
    from tpurt_torch.utils.config import get_config

    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA device")
    device = torch.device("cuda", 0)
    config = get_config(preset, **overrides)
    config = get_config(preset, spp=config.spp_per_batch,
                        live_caps=autotune.live_caps_for(config),
                        shadow_caps=autotune.want_caps_for(config),
                        **overrides)
    scene = load_scene(config.scene)
    meta = scene_meta(scene)
    ds = to_device(scene, device=device)
    accel = build_accel(config, ds, meta, scene=scene, device=device)
    renderer = StagedRenderer(ds, accel, meta=meta, config=config,
                              device=device)
    cam, seed = scene.camera, config.seed

    renderer(cam, seed, 0)  # warmup
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, counts = renderer(cam, seed, 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rays = float(counts[0] + counts[1])

    stages = _stage_times(renderer, cam, seed)

    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer(cam, seed, 0)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # kernels, memcpy, memset
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    launches = kernels.launch_counts()
    walk = None
    if hasattr(renderer.closest[0], "traversal_stats"):  # the packet BVH
        state = renderer.raygen(cam, seed, 0)
        tmax = torch.where(state.alive, float("inf"), -1.0)
        _, counters = renderer.closest[0].traversal_stats(
            state.org, state.dirn, 0.0, tmax)
        steps, leaf_rows = (float(x) for x in counters.sum(dim=0))
        walk = {"primary_rays": state.org.shape[0], "node_steps": steps,
                "leaf_rows": leaf_rows}
    return {
        "card": nvidia_smi_line(),
        "preset": preset,
        "resolution": f"{config.width}x{config.height}",
        "spp_per_batch": config.spp_per_batch,
        "intersector": config.resolved_intersector(),
        "pairs_per_tile": config.pairs_per_tile,
        "pairs_per_ray": config.pairs_per_ray,
        "pair_overflow": bool(counts[2] > 0),
        "loop": renderer.mode,
        "stage_graphs": renderer.graphs,
        "graph_reason": renderer.graph_reason,
        "rays": rays,
        "batch_s": wall,
        "mrays_per_s": rays / wall / 1e6,
        "stage_ms": stages,
        "profiled_batch_s": prof_wall,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (prof_wall * 1e3)),
        "switches": {k: v for k, v in os.environ.items()
                     if k.startswith("TPURT_")},
        "launches": launches,
        "packet_walk": walk,
        "kernels_ms": [{"name": k[:120], "ms": ms, "calls": n}
                       for k, ms, n in rows[:30]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="bunny")
    ap.add_argument("--intersector", default="auto",
                    choices=("auto", "bvh_tile", "bvh_pair",
                             "bvh_packet"))
    ap.add_argument("--pairs-per-tile", type=int, default=None)
    ap.add_argument("--pairs-per-ray", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    overrides = dict(intersector=args.intersector)
    if args.pairs_per_tile is not None:
        overrides["pairs_per_tile"] = args.pairs_per_tile
    if args.pairs_per_ray is not None:
        overrides["pairs_per_ray"] = args.pairs_per_ray
    result = profile_batch(args.preset, **overrides)
    text = json.dumps(result, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
