"""Where one render batch spends its device time.

    python3 -m tpurt_torch.utils.profiling [--preset bunny] [--out FILE]

Renders one warm batch of the preset on CUDA twice: once with CUDA events
around every stage of the staged loop (raygen, trace[b], shade[b],
occlude[b], resolve) and once under ``torch.profiler`` for device time by
kernel name and the device's busy share of the batch's wall time. Prints
one JSON object (and writes it to ``--out``) with the card's name and
power limit beside every number. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _stage_times(renderer, cam, seed):
    """Device ms per stage of one batch (CUDA events, no host syncs)."""
    import torch

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    mark("start")
    sampler = renderer.sampler(seed, 0)
    state = renderer.raygen(cam, seed, 0)
    mark("raygen")
    for b in range(renderer.config.max_bounces + 1):
        hit, state = renderer.trace(state, b)
        mark(f"trace[{b}]")
        state, shadow = renderer.shade(state, hit, sampler, b)
        mark(f"shade[{b}]")
        if shadow is not None:
            state = renderer.occlude(state, shadow, b)
            mark(f"occlude[{b}]")
    renderer.resolve(state)
    mark("resolve")
    torch.cuda.synchronize()
    return {name: marks[i - 1][1].elapsed_time(ev)
            for i, (name, ev) in enumerate(marks) if i}


def profile_batch(preset: str = "bunny") -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpurt_torch.kernels import tilewave as tw
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
    config = get_config(preset)
    config = get_config(preset, spp=config.spp_per_batch,
                        live_caps=autotune.live_caps_for(config),
                        shadow_caps=autotune.want_caps_for(config))
    scene = load_scene(config.scene)
    meta = scene_meta(scene)
    ds = to_device(scene, device)
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

    tw.reset_launch_counts()
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
    return {
        "card": _card(),
        "preset": preset,
        "resolution": f"{config.width}x{config.height}",
        "spp_per_batch": config.spp_per_batch,
        "rays": rays,
        "batch_s": wall,
        "mrays_per_s": rays / wall / 1e6,
        "stage_ms": stages,
        "profiled_batch_s": prof_wall,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (prof_wall * 1e3)),
        "launches": {"entries": tw.entries_cuda.launches,
                     "tileloop": tw.tileloop_cuda.launches},
        "kernels_ms": [{"name": k[:120], "ms": ms, "calls": n}
                       for k, ms, n in rows[:30]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="bunny")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    result = profile_batch(args.preset)
    text = json.dumps(result, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
