"""One perfbench cell with the port's span recorder, its spans laid over the
cell's traced stretch: the step and idle split that perfbench does not
read yet.

    python3 span_cell.py on|off --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Runs ``perfbench/run.py`` in this process, unchanged, with the recorder
(``tpurt_torch.utils.profiling``) switched on at process start (``on``)
or left off (``off``, to time the recorder's cost against ``on`` with
``--trace 0``). It prints the cell's result line as perfbench does, then
one line ``SPANS {...}``. Under ``on`` and ``--trace 1`` that line holds
``profiling.attribute``'s split of the traced stretch, a batch or a unit
as perfbench's own metrics are:

  * ``step_ms.<step>``: device ms a batch by step (``rng``, ``shade``,
    ``sort``, ``entries``, ``walk``, ...; ``unattributed`` where a
    replay's records are not its graph's op nodes), with their sum beside
    ``shade_plus_traverse_ms`` (perfbench's ``shade_ms`` + ``traverse_ms``
    of the same records);
  * ``idle_ms.launch`` / ``.call`` / ``.outside``: the untraced stretch's
    idle ms a unit (perfbench's ``idle_share`` basis) apportioned by each
    group's share of the traced idle;
  * ``device_steps``, ``device_stages``, ``idle_spans``: the top entries
    in seconds; ``replays``: [replays, replays whose records equal their
    graph's op nodes] (the graph node check);
  * ``traversal_by_step``: device s of perfbench's traversal kernels by
    the step that holds them (``entries`` and ``walk`` alone, when the
    split is right);
  * ``accel_build_s``: the ``accel.build`` spans of set-up;
  * ``accel``: the program's record of that build (its phases' seconds
    and its triangle, cluster, supercluster, byte, instance and stored
    triangle counts), ``wave_modes``: the run's waves by tile mode
    (``sc_rows``, ``cluster_rows``, ...), and ``launches``: the launch
    counts since the harness last reset them (under ``--trace 1``, the
    traced stretch's), with ``shade.plain`` for the waves the PyTorch
    shade shaded; all kept with the recorder off too;
  * ``slab_rays``: the ray slots K2 (``entries``) and K3
    (``exact_mask``) were launched over, the live rays among them and
    the live share, counted on the card since the harness last reset the
    launch counts (under ``--trace 1``, the traced stretch).

Needs a CUDA device, as perfbench does; run it from the root of a
checkout.
"""

import collections
import json
import os
import sys
import time

STEPS = ("rng", "shade", "sort", "entries", "walk", "trace", "occlude",
         "raygen", "sums", "unnamed", "unattributed")


def traversal_by_step(P, tr, dev, host, spans) -> dict:
    """Device s of perfbench's traversal kernels, by the step
    ``attribute`` gives their records."""
    runtime = {c: (a, n) for a, _, n, c in host}
    groups = collections.defaultdict(list)
    for rec in dev:
        groups[rec[3]].append(rec)
    keys = sorted(c for c in groups if c in runtime)
    where = dict(zip(keys, P._innermost(spans, [runtime[c][0]
                                                for c in keys])))
    out = collections.Counter()
    for c, recs in groups.items():
        i = where.get(c, -1)
        recs.sort()
        nodes = spans[i].nodes if i >= 0 else None
        if (c in runtime and "cudaGraphLaunch" in runtime[c][1]
                and nodes is not None and nodes[0] == len(recs)):
            labels = P._node_steps(nodes)
        else:
            labels = [spans[i].name if i >= 0 else "outside"] * len(recs)
        for (a, b, name, _), lab in zip(recs, labels):
            if any(k in name for k in tr.TRAVERSAL):
                out[lab or "unnamed"] += (b - a) * 1e-9
    return dict(out)


def split(P, got) -> dict:
    """The SPANS line's readings from the attribution and perfbench's
    context of the traced run."""
    a, ctx = got["attr"], got["ctx"]
    t, n = ctx["trace"], ctx["traced"]
    b, u = n["batches"], n["units"]
    steps = a["device_steps"]
    out = {"replays": [a["replays"], a["replays_matched"]]}
    for k in STEPS:
        out[f"step_ms.{k}"] = steps.get(k, 0.0) * 1e3 / b
    out["sum_steps_ms"] = sum(steps.values()) * 1e3 / b
    out["shade_plus_traverse_ms"] = (t["traversal_s"] + t["other_s"]) \
        * 1e3 / b
    idle_unit = n["plain_unit_s"] - t["busy_s"] / u
    groups = a["idle_groups"]
    total = sum(groups.values())
    for k in ("launch", "call", "outside"):
        out[f"idle_ms.{k}"] = (idle_unit * 1e3 * groups.get(k, 0.0) / total
                               if total else None)
    out.update(idle_unit_ms=idle_unit * 1e3,
               unit_ms_untraced=n["plain_unit_s"] * 1e3,
               batches=b, units=u, busy_s=t["busy_s"],
               attr_busy_s=a["busy_s"],
               device_steps=list(steps.items())[:14],
               device_stages=list(a["device_stages"].items())[:14],
               idle_spans=list(a["idle_spans"].items())[:10],
               idle_groups=groups, attr_s=got["attr_s"],
               traversal_by_step=got["trav"], n_dev=got["n_dev"])
    return out


def main(argv) -> int:
    mode = argv.pop(0)
    if mode not in ("on", "off"):
        raise SystemExit(f"span_cell.py on|off ...: not {mode!r}")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from tpurt_torch.utils import profiling as P

    if mode == "on":
        P.record(True)
    from perfbench import cell as cell_mod
    from perfbench import run as run_mod
    from perfbench import trace as tr

    got = {}
    reduce, read_metric = tr.reduce, cell_mod.read_metric

    def reduce_too(prof):
        out = reduce(prof)
        if P.recording():
            t = time.perf_counter()
            dev, host = P.kineto_events(prof)
            spans = P.records()["spans"]
            got.update(attr=P.attribute(dev, host, spans), n_dev=len(dev),
                       trav=traversal_by_step(P, tr, dev, host, spans),
                       attr_s=time.perf_counter() - t)
        return out

    def read_metric_too(root_, name, ctx):
        got["ctx"] = ctx
        return read_metric(root_, name, ctx)

    tr.reduce, cell_mod.read_metric = reduce_too, read_metric_too
    rc = run_mod.main(argv)
    rec = P.records()
    out = {"mode": mode, "n_spans": len(rec["spans"]),
           "dropped": rec["dropped"], "counts": rec["counts"],
           "accel_build_s": [(s.end_ns - s.start_ns) * 1e-9
                             for s in rec["spans"]
                             if s.name == "accel.build"]}
    from tpurt_torch import kernels, render
    from tpurt_torch.kernels import tilewave

    out["accel"] = render.accel_build_record()
    out["wave_modes"] = {k[len("waves."):]: n
                         for k, n in kernels.counts("waves.").items()}
    out["launches"] = kernels.launch_counts()
    # [slots, live rays, live share] by kernel
    out["slab_rays"] = {k: [n, live, live / n if n else None]
                        for k, (n, live) in tilewave.slab_ray_counts().items()}
    if "attr" in got and "ctx" in got:
        out.update(split(P, got))
    print("SPANS " + json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
