"""The benchmark of the port (``tpurt_torch``) on NVIDIA GPUs.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` once, in this process, on the card,
from the root of a checkout: set-up (the kernel library, the scene and its
accel, the renderer and its stage graphs, one warm unit), a closed loop of
the cell's traffic for ``--seconds`` seconds, then the correctness check
against the plain reference. Prints the result as the last line of
standard output (one JSON object) and the numbers compared, beside their
limits, as the last lines of standard error. ``--trace 1`` reports the
per-layer metrics from a window of twice the traffic's ``trace_seconds``:
untraced, then a ``torch.profiler`` record of the device's activity;
``--trace 0`` the end-to-end metrics.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), without the program beside it, or when JAX or
the JAX package is loaded once the window has closed.
"""

import os
import sys
import time

T_TOP = time.perf_counter()


def _since_start() -> float:
    """Seconds since this process started (Linux), to 10 ms."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


SINCE_START = _since_start()


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    # a clean environment: the program's switches are all at their
    # defaults, and its measured caps come from the benchmark's own table
    for k in [k for k in os.environ if k.startswith("TPURT_")]:
        del os.environ[k]
    os.environ["TPURT_AUTOTUNE_PATH"] = os.path.join(
        root, "perfbench", "autotune.json")

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); torch "
              f"finds {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import tpurt_torch  # noqa: F401  (the program must be beside us)

    from perfbench import cell as cell_mod

    result = cell_mod.run(root, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0),
                          SINCE_START, T_TOP)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
