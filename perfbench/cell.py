"""One run of one cell: set-up, the measured window, the traced window of a
``--trace 1`` run, and the correctness check. Everything a cell is made of
is found by name: ``BENCHMARK.json`` names its configuration
(``perfbench/configs/<name>.json``), its traffic
(``perfbench/traffic/<name>.json``), its limits
(``perfbench/limits/<cell>.json``) and its metrics (per-layer readers in
``perfbench/metrics/<metric>.py``, or ``<quantity>.py`` for a metric named
``<quantity>.<part>``)."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from perfbench import check, program, scenes, traffic
from perfbench import trace as tr

FORBIDDEN = {"jax", "jaxlib", "flax", "tpurt"}


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def load_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(root: str, bench: dict, name: str):
    """(cell, configuration file, traffic mix, limits) of a cell."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    mix = traffic.load(root, cell["traffic"])
    with open(os.path.join(root, "perfbench", "limits", f"{name}.json")) as f:
        limits = json.load(f)
    return cell, config, mix, limits


def metrics_of(bench: dict, cell: str):
    """(end-to-end, per-layer) metric entries this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def read_metric(root: str, name: str, ctx: dict):
    """The value of per-layer metric ``name``, read by
    ``perfbench/metrics/<name>.py`` where there is one, else by the reader
    of its quantity (``<quantity>.py`` for ``<quantity>.<part>``), which
    finds the whole name in ``ctx["metric"]``."""
    folder = os.path.join(root, "perfbench", "metrics")
    path = os.path.join(folder, f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(folder, name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read({**ctx, "metric": name})


class Timer:
    """Unit times on the device's clock (CUDA events around the unit,
    the host's clock on the CPU)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds(self, a, b):
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b) * 1e-3
        return b - a


def run(root: str, name: str, seed: int, seconds: float, trace: bool,
        device: torch.device, since_start: float, t_top: float):
    """One run of cell ``name``: the result line (a dict) and the checks."""
    bench = load_bench(root)
    cell, config, mix, limits = resolve(root, bench, name)
    e2e, layer = metrics_of(bench, name)
    render = {**config["render"], **mix.get("render", {})}
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    spans = {}
    log(f"process start to set-up of the cell: "
        f"{since_start + time.perf_counter() - t_top:.3f} s "
        f"(interpreter, imports, the CUDA runtime)")

    t = time.perf_counter()
    program.load_kernels(device)
    spans["build"] = time.perf_counter() - t

    t = time.perf_counter()
    sd = scenes.build(config["scene"]["builder"], config["scene"]["args"])
    port_scene = program.port_scene(sd)
    rc = program.render_config(render)
    program.build_context(rc, port_scene, device)
    sync()
    spans["scene"] = time.perf_counter() - t

    t = time.perf_counter()
    driver = program.Driver(rc, port_scene, mix, device)
    warm = next(traffic.units(mix, seed, stream=1))
    driver.run(warm)  # builds the renderer, captures its graphs
    sync()
    spans["graphs"] = time.perf_counter() - t
    setup_s = since_start + (time.perf_counter() - t_top)
    log(f"setup: {setup_s:.3f} s (build {spans['build']:.3f}, "
        f"scene {spans['scene']:.3f}, graphs and warm unit "
        f"{spans['graphs']:.3f}); switches "
        + json.dumps({k: v for k, v in os.environ.items()
                      if k.startswith("TPURT_")}))

    # --- the measured window ----------------------------------------------
    # A --trace 1 run's window is two stretches of the traffic's
    # trace_seconds: untraced, then traced. The profiler slows the host path
    # (CUPTI's own work in every launch), so the idle share compares the
    # traced stretch's device seconds a unit with the untraced one's wall
    # seconds a unit.
    check_spec = mix["check"]
    keeper = check.Keeper(int(check_spec["units"]), seed,
                          bool(check_spec.get("slowest", False)))
    timer = Timer(device)
    driver.rays = 0.0
    plain = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # the device's activity alone: recording every host operation too
        # would slow the host path further
        prof = profile(activities=[ProfilerActivity.CUDA
                                   if device.type == "cuda"
                                   else ProfilerActivity.CPU])
        stretch = min(float(mix.get("trace_seconds", seconds)), seconds)
        marker = torch.empty(1, device=device)
    unit_s, attempted, failed, samples, batches = [], 0, 0, 0, 0

    def start_trace():
        """Close the untraced stretch and open the traced one: the untraced
        stretch's (units, batches, seconds) and the traced one's start."""
        sync()
        done = (attempted, batches, time.perf_counter() - t0)
        program.reset_launch_counts()
        prof.start()
        marker.fill_(0)  # the traced stretch's first device operation
        sync()  # the profiler's first launch sets it up: seconds, untimed
        return done, time.perf_counter()

    sync()
    t0 = time.perf_counter()
    deadline = t0 + (stretch if trace else seconds)
    for unit in traffic.units(mix, seed):
        a = timer.mark()
        try:
            image, n_b = driver.run(unit)
        except Exception:  # a unit that fails is counted and reported
            failed += 1
            if failed == 1:
                log(traceback.format_exc())
            image, n_b = None, 0
        b = timer.mark()
        attempted += 1
        if image is not None:
            dt = timer.seconds(a, b)
            unit_s.append(dt)
            samples += (render["width"] * render["height"]
                        * int(mix["samples_per_unit"]))
            batches += n_b
            keeper.offer(unit, image)
            keeper.offer_time(dt, unit, image)
        if time.perf_counter() >= deadline:
            if not trace or plain is not None:
                break
            plain, t1 = start_trace()
            deadline = t1 + stretch
    sync()
    window = time.perf_counter() - t0
    if trace:
        marker.fill_(0)  # and its last
        sync()
        traced = {"units": attempted - plain[0],
                  "batches": batches - plain[1],
                  "seconds": time.perf_counter() - t1,
                  "launches": program.launch_counts(),
                  "plain_unit_s": plain[2] / max(plain[0], 1)}
        t = time.perf_counter()
        prof.stop()
        log(f"profiler stopped in {time.perf_counter() - t:.3f} s; "
            f"untraced stretch {plain[2]:.3f} s, {plain[0]} units: "
            f"{plain[2] / max(plain[0], 1) * 1e3:.4f} ms a unit; traced "
            f"{traced['seconds']:.3f} s, {traced['units']} units: "
            f"{traced['seconds'] / max(traced['units'], 1) * 1e3:.4f} ms a "
            f"unit (the profiler's cost)")
    found = sorted(FORBIDDEN & {m.split(".")[0] for m in sys.modules})
    if found:
        log(f"modules of the JAX package or JAX are loaded: {found}")
        raise SystemExit(3)

    mem_peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    frames = len(unit_s)
    # a metric named <quantity>.<part> reports that quantity
    values = {
        "msamples_per_s": samples / window / 1e6,
        "frame_ms": window / max(frames, 1) * 1e3,
        "setup_s": setup_s,
    }
    values = {m["name"]: values[m["name"].split(".")[0]] for m in e2e}
    if not trace:
        log(f"window: {window:.3f} s, {attempted} units, {failed} failed, "
            f"{batches} batches, {driver.rays / window / 1e6:.4f} Mrays/s "
            f"(the program's ray count); " + json.dumps(values))
    if unit_s:
        q = np.percentile(np.asarray(unit_s) * 1e3, [0, 25, 50, 75, 95, 100])
        log("unit ms min/q1/median/q3/p95/max: "
            + " ".join(f"{v:.4f}" for v in q))

    result = {"correct": False, "attempted": attempted, "failed": failed}
    device_info = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": 1,
        "memory_peak_bytes": int(mem_peak),
    }
    breakdown = None
    if trace:
        t = time.perf_counter()
        summary = tr.reduce(prof)
        del prof
        log(f"trace reduced in {time.perf_counter() - t:.3f} s")
        ctx = {"spans": spans, "trace": summary, "traced": traced}
        metrics = {}
        for m in layer:
            v = read_metric(root, m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if summary:
            device_info["busy_s"] = summary["busy_s"]
            device_info["window_s"] = summary["window_s"]
            breakdown = {"device_ops": summary["device_ops"],
                         "idle_gaps": summary["idle_gaps"]}
            launches = traced.get("launches", {})
            k1 = sum(v for k, v in launches.items()
                     if k.startswith(("tileloop", "tilegrid")))
            k2 = launches.get("entries", 0)
            same = k1 == summary["k1_records"] and k2 == summary["k2_records"]
            log(f"trace: {summary['window_s']:.4f} s traced, "
                f"{traced['units']} units, {traced['batches']} batches; "
                f"profiler records K1 {summary['k1_records']} K2 "
                f"{summary['k2_records']}, launch counters K1 {k1} K2 {k2}"
                + ("" if same else " -- MISMATCH"))
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}

    # --- correctness ------------------------------------------------------
    del driver
    program.free_program_state()
    t = time.perf_counter()
    from perfbench.reference.render import WorldScene

    ws = WorldScene(sd, device)
    off, n_ch, gaps = check.compare(ws, keeper.units(), sd.camera, render,
                                    mix, seed, device)
    limit = float(limits["off_share"])
    if gaps.numel():
        q = np.quantile(gaps.numpy(), [0.5, 0.99, 0.999, 1.0])
        log("check gaps median/p99/p999/max: "
            + " ".join(f"{v:.6g}" for v in q))
    log(f"check: {len(keeper.units())} units, {n_ch} channels, "
        f"{time.perf_counter() - t:.3f} s")
    correct = (failed == 0 and frames > 0 and n_ch > 0 and off <= limit)
    result["correct"] = bool(correct)
    result["metrics"] = metrics
    result["device"] = device_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {"off_share": {"value": off, "limit": limit}}
    log(f"off_share {off!r} limit {limit!r}")
    return result
