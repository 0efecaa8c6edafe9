"""Benchmark entry of the port: the counterpart of the repository's root
``bench.py``, measured on one CUDA card.

    python -m tpurt_torch.bench [--scene bunny] [--width 800] [--height 600]
        [--spp 8] [--spp-per-batch 8] [--max-bounces 2] [--intersector NAME]
        [--retries 3] [--cpu]

Prints ONE JSON line: the primary metric Mrays/sec/chip (closest-hit and
shadow rays actually traced, counted on the device) on the bunny ladder
config by default: 800×600, 8 spp in one batch, 2 bounces.
``--scene sponza --width 1920 --height 1080 --spp 2 --spp-per-batch 2``
is one frame of the sponza flythrough; its ``detail.elapsed_s`` is the
1080p frame time.

The measured render runs in a child process (``--_child``), retried in a
fresh process up to ``--retries`` times; after the last failure the
parent prints a line with ``value`` 0.0 and ``detail.error`` and exits 1.

The child renders on the card unless ``--cpu`` is given (the kernels'
plain versions); without ``--cpu`` on a machine where torch finds no
CUDA device it raises, and there is no fallback to the CPU. It makes:

  * one untimed warmup render of a single batch (``spp =
    spp_per_batch``, no stats readback), its wall time ``warmup_s``
    split into ``warmup_build_s`` (the CUDA kernel library's nvcc
    seconds, 0.0 when a build was reused or on the CPU),
    ``warmup_scene_s`` (the scene context: host scene, accel build and
    upload) and ``warmup_other_s`` (the rest: the stage graphs'
    warm-up and capture, and the first batch);
  * ``RUNS`` fresh accumulations of the full config, each timed by
    ``render_scene``'s own ``elapsed_s`` (wall time between two device
    synchronizes). ``value`` is the median run's Mrays/s; ``detail``
    holds that run's ``elapsed_s`` and ``rays_traced``, the other runs'
    spread (``mrays_min``, ``mrays_max``, ``runs_mrays``), the device
    (``device``: the card's name or "cpu"; ``platform``: "gpu" or "cpu")
    and, on the card, ``gpu``: its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them. The median of several runs replaces the root bench's
    slower-of-two guard, which was written against an accelerator clock
    that could return early: the card's calls spread by about ±15%, so
    one or two runs do not place the number.

Fields of the root bench that are left out, each a number taken on or
for a TPU: ``mfu`` (a share of the v5e VPU's lane-op peak),
``projected_v5p`` and ``vs_baseline_v5p`` (a v5e → v5p clock
projection), and ``vs_baseline`` (its divisor is the 150 Mrays/s target
set for a v5p chip). The port states no share of a peak here: a share
of its kernels' roofline is for the benchmark to define.
"""

import argparse
import json
import os
import subprocess
import sys
import time

RUNS = 5  # measured accumulations; the median is reported


def child_main(args) -> int:
    import torch

    from tpurt_torch.render import _scene_context, render_scene
    from tpurt_torch.scene.device import torch_device
    from tpurt_torch.utils.config import get_config

    device = torch_device("cpu" if args.cpu else "cuda")
    on_card = device.type == "cuda"
    overrides = dict(
        width=args.width,
        height=args.height,
        spp=args.spp,
        spp_per_batch=args.spp_per_batch,
        max_bounces=args.max_bounces,
    )
    if args.intersector:
        overrides["intersector"] = args.intersector
    config = get_config(args.scene, **overrides)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    # warmup: one batch, untimed, with no stats readback
    warm = get_config(args.scene, **{**overrides, "spp": args.spp_per_batch})
    t0 = time.perf_counter()
    build_s = 0.0
    if on_card:
        from tpurt_torch.kernels import cuda_build

        build_s = cuda_build.load().seconds
    t1 = time.perf_counter()
    _scene_context(warm, None, device)  # render_scene finds it cached
    sync()
    scene_s = time.perf_counter() - t1
    render_scene(warm, readback_stats=False, device=device)
    sync()
    warm_s = time.perf_counter() - t0

    runs = [render_scene(config, device=device)[1] for _ in range(RUNS)]
    mrays = [s["mrays_per_s"] for s in runs]
    stats = runs[sorted(range(RUNS), key=mrays.__getitem__)[RUNS // 2]]
    detail = {
        "scene": args.scene,
        "resolution": f"{args.width}x{args.height}",
        "spp": stats["spp"],
        "rays_traced": stats["rays_traced"],
        "elapsed_s": stats["elapsed_s"],
        "mrays_min": min(mrays),
        "mrays_max": max(mrays),
        "runs_mrays": mrays,
        "warmup_s": warm_s,
        "warmup_build_s": build_s,
        "warmup_scene_s": scene_s,
        "warmup_other_s": max(warm_s - build_s - scene_s, 0.0),
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "platform": "gpu" if on_card else "cpu",
    }
    if on_card:
        from tpurt_torch.utils.profiling import nvidia_smi_line

        detail["gpu"] = nvidia_smi_line()
    print(json.dumps({
        "metric": f"Mrays/sec/chip ({args.scene})",
        "value": stats["mrays_per_s"],
        "unit": "Mrays/s",
        "detail": detail,
    }))
    return 0


def make_parser():
    ap = argparse.ArgumentParser(
        prog="python -m tpurt_torch.bench",
        description="Mrays/s of the port on one CUDA card (one JSON line)")
    ap.add_argument("--scene", default="bunny")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--spp-per-batch", type=int, default=8,
                    dest="spp_per_batch")
    ap.add_argument("--max-bounces", type=int, default=2,
                    dest="max_bounces")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (the kernels' plain versions)")
    ap.add_argument("--intersector", default="",
                    help="override config intersector (e.g. bvh_tile)")
    ap.add_argument("--_child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--retries", type=int, default=3)
    return ap


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args._child:
        return child_main(args)

    cmd = [sys.executable, "-m", "tpurt_torch.bench", "--_child",
           "--scene", args.scene, "--width", str(args.width),
           "--height", str(args.height), "--spp", str(args.spp),
           "--spp-per-batch", str(args.spp_per_batch),
           "--max-bounces", str(args.max_bounces)]
    if args.intersector:
        cmd += ["--intersector", args.intersector]
    if args.cpu:
        cmd.append("--cpu")
    # the child imports this package from wherever it is started
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    last_err = ""
    for attempt in range(args.retries):
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=4200, env=env)
        except subprocess.TimeoutExpired:
            last_err = "the child ran past its 4200 s limit"
        else:
            for line in r.stdout.splitlines():
                if line.startswith("{"):
                    print(line)
                    return 0
            last_err = (r.stderr.splitlines() or ["?"])[-1][:200]
        print(f"# attempt {attempt + 1} failed: {last_err}",
              file=sys.stderr)
    print(json.dumps({
        "metric": f"Mrays/sec/chip ({args.scene})",
        "value": 0.0,
        "unit": "Mrays/s",
        "detail": {"error": last_err},
    }))
    return 1


if __name__ == "__main__":
    sys.exit(main())
