"""The control of the correctness check: the plain reference put in the
program's place and computed in bfloat16, the precision below the float32
the configurations state. Its ``off_share`` has to come out above the
cell's limit; the readings set the limit's upper end.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--cpu]

For each seed it takes the cell's check sample from the first 240 units of
the traffic, at the cell's own sizes, and prints one JSON line a seed with the control's ``off_share``. The
benchmark's runs never run it.
"""

import argparse
import json
import os
import sys

import numpy as np


def control_share(root, workload, seed, device, dtype):
    import torch

    from perfbench import cell as cell_mod
    from perfbench import check, scenes, traffic
    from perfbench.reference.render import WorldScene, render_pixels

    bench = cell_mod.load_bench(root)
    _, config, mix, limits = cell_mod.resolve(root, bench, workload)
    render = {**config["render"], **mix.get("render", {})}
    sd = scenes.build(config["scene"]["builder"], config["scene"]["args"])
    span = 240
    gen = traffic.units(mix, seed)
    pool = [next(gen) for _ in range(span)]
    rng = np.random.default_rng([int(seed), 4])
    pick = sorted(rng.choice(span, size=int(mix["check"]["units"]),
                             replace=False))
    kept = [(pool[i], None) for i in pick]
    low = WorldScene(sd, device, dtype)
    w, h = render["width"], render["height"]

    def produced(unit, px, py):
        total = render_pixels(low, sd.camera, unit.seed, unit.samples, px, py,
                              w, h, render["max_bounces"],
                              render["use_nee"])
        return total / float(unit.samples)

    ws = WorldScene(sd, device)
    off, n_ch, _ = check.compare(ws, kept, sd.camera, render, mix, seed,
                                 device, produced=produced)
    return off, n_ch, float(limits["off_share"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("no CUDA device (use --cpu)", file=sys.stderr)
        return 2
    for seed in args.seeds:
        off, n_ch, limit = control_share(root, args.workload, seed, device,
                                         torch.bfloat16)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_off_share": off, "channels": n_ch,
                          "limit": limit, "fails": off > limit}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
