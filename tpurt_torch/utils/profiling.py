"""Tracing and profiling — port of ``tpurt.utils.profiling``, the port's
span and counter recorder, and where one render batch spends its device
time.

The reference's helpers, on torch:

  * ``trace(dir)``   — ``torch.profiler`` (CPU, and CUDA where the card is
                       in use) → a Chrome/Perfetto JSON trace in ``dir``
                       (open it in ui.perfetto.dev);
  * ``timed(name)``  — a wall-clock bracket that waits for the current
                       CUDA device at its exit, so the number covers the
                       device work queued inside it;
  * ``frame_log(…)`` — the structured per-frame log line, optionally
                       appended to a JSONL file.

The recorder: ``span(name)``, ``step(name)`` and ``count(name, n)`` mark
the program's layers (``render_scene``'s call, set-up and batch loop, the
staged loop's stage programs and their steps, delivery); ``record(on)``,
``records()`` and ``clear()`` switch it and read it. Off, the default,
each mark costs one check. ``attribute`` lays the spans over a
``torch.profiler`` trace (``kineto_events``): device time by step and by
stage program — a CUDA graph's replay by the node ranges its steps marked
while it was captured — and idle time by the span the host was in. A
graph's nodes are read through libcuda (``graph_op_nodes``,
``CaptureOpNodes``).

The per-stage profiler:

    python3 -m tpurt_torch.utils.profiling [--preset bunny] [--out FILE]
        [--intersector bvh_tile|bvh_pair|bvh_packet] [--pairs-per-tile K]
        [--pairs-per-ray K]

Renders one warm batch of the preset on CUDA twice, with the given
intersector and pair budgets (no budget retries; the overflow flag is
reported): once by the host clock, and once under ``torch.profiler``
(device activity) with the recorder on, for device time by kernel name,
by stage program of the staged loop's active path (by default the stage
graphs trace[b], shade_occlude[b] and resolve; under
``TPURT_FUSE_STAGES=0`` raygen, trace[b], shade[b], occlude[b] and
resolve; under ``TPURT_FUSE_BOUNCES=1`` the batch alone; the raster
scatter as "frame") and by step, the graph node check (replays, and
replays whose records equal their op nodes), the graph pool's bytes
(the ``graphs.pool_bytes`` counter), and the device's busy share of the
batch's wall time. With ``bvh_packet`` it also reports the
walk's counters on the primary wave (node steps and leaf rows, summed
over its rays). The switches (``TPURT_*``) are read from the environment
and recorded. Prints one JSON object (and writes it to ``--out``) with
the card's name and power limit beside every number. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from typing import NamedTuple, Optional


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


# --- the span and counter recorder ----------------------------------------
#
# Off (the default), ``span`` and ``step`` return one shared no-op context
# and ``count`` returns at once: one check of a module-level name each.
# On, every span is kept in memory as (name, start_ns, end_ns, parent,
# nodes) on the ``time.time_ns()`` clock, which is the clock of
# torch.profiler's records (kineto's), so the spans lay over a device
# trace as they are; ``attribute`` does that.

MAX_RECORDS = 1 << 20  # spans kept a recording; later ones are counted


class Span(NamedTuple):
    """One recorded span. ``parent`` is the index of the enclosing span in
    ``records()["spans"]`` (-1 at the top); ``nodes`` a stage graph's
    replay: (its op nodes, its steps' ((step, first node, end node),
    ...)), else None."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    nodes: Optional[tuple]


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


class _Recorder:
    """The spans and counters of one recording (host times kept on
    ``perf_counter_ns`` and moved to the ``time_ns`` epoch, when read, by
    one pair of readings taken when the recording starts)."""

    def __init__(self):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        self.offset = wall - (a + time.perf_counter_ns()) // 2
        self.clear()

    def clear(self):
        self.spans, self.counts, self.dropped = [], {}, 0
        # spans open now keep their place on the stack, out of the records
        self.stack = [-1] * len(getattr(self, "stack", ()))


class _Open:
    """A span of ``_Recorder`` between its enter and its exit."""

    __slots__ = ("rec", "name", "nodes", "entry")

    def __init__(self, rec, name, nodes):
        self.rec, self.name, self.nodes = rec, name, nodes

    def __enter__(self):
        rec = self.rec
        if len(rec.spans) >= MAX_RECORDS:
            rec.dropped += 1
            self.entry = None
            rec.stack.append(-1)
        else:
            self.entry = [self.name, time.perf_counter_ns(), 0,
                          rec.stack[-1] if rec.stack else -1, self.nodes]
            rec.stack.append(len(rec.spans))
            rec.spans.append(self.entry)
        return None

    def __exit__(self, *exc):
        self.rec.stack.pop()
        if self.entry is not None:
            self.entry[2] = time.perf_counter_ns()
        return False


_REC: Optional[_Recorder] = None  # the recording under way, else None
_LAST: Optional[_Recorder] = None  # the latest recording (records())


def record(on: bool = True) -> None:
    """Start recording (a new recording: the last one's records go) or
    stop (its records stay for ``records``)."""
    global _REC, _LAST
    if on and _REC is None:
        _REC = _LAST = _Recorder()
    elif not on:
        _REC = None


def recording() -> bool:
    return _REC is not None


def records() -> dict:
    """The latest recording: ``spans`` (``Span`` tuples, in the order they
    began, on the ``time.time_ns()`` clock; a span still open ends at 0),
    ``counts`` (name → total) and ``dropped`` (spans past
    ``MAX_RECORDS``). Empty when nothing was recorded."""
    rec = _LAST
    if rec is None:
        return {"spans": [], "counts": {}, "dropped": 0}
    off = rec.offset
    return {"spans": [Span(n, a + off, b + off if b else 0, p, nodes)
                      for n, a, b, p, nodes in rec.spans],
            "counts": dict(rec.counts), "dropped": rec.dropped}


def clear() -> None:
    """Drop the latest recording's spans and counts (recording goes on
    where it is on)."""
    if _LAST is not None:
        _LAST.clear()


def span(name: str, *, nodes: Optional[tuple] = None):
    """A context that records one span named ``name`` while recording;
    ``nodes`` is a stage graph's (``Span.nodes``)."""
    if _REC is None:
        return _NOOP
    return _Open(_REC, name, nodes)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording."""
    if _REC is None:
        return
    _REC.counts[name] = _REC.counts.get(name, 0) + n


# --- steps of a stage program, and their graph nodes ------------------------

_MARKS = None  # the stage graph's NodeMarks while one is captured


class NodeMarks:
    """The op-node ranges of a stage graph's steps, taken while the graph
    is captured: ``count()`` gives the capture's kernel, memset and memcpy
    nodes so far, at each step's enter and exit. ``ranges`` holds (step,
    first node, end node) for every step that made a node, inner steps
    before the steps around them; ``total`` the graph's op nodes. A count
    that fails leaves the graph without ranges (its replays are then
    ``unattributed``): tracing never fails the capture."""

    def __init__(self, count):
        self._count = count
        self.ranges = []
        self.total = 0
        self.failed = False

    def count(self) -> int:
        if not self.failed:
            try:
                return self._count()
            except Exception:  # libcuda missing or refusing: no ranges
                self.failed = True
        return 0

    def nodes(self) -> Optional[tuple]:
        """``Span.nodes`` of the graph's replays (None where a count
        failed)."""
        return None if self.failed else (self.total, tuple(self.ranges))


class _Mark:
    __slots__ = ("marks", "name", "first")

    def __init__(self, marks, name):
        self.marks, self.name = marks, name

    def __enter__(self):
        self.first = self.marks.count()
        return None

    def __exit__(self, *exc):
        end = self.marks.count() if exc[0] is None else self.first
        if end > self.first:
            self.marks.ranges.append((self.name, self.first, end))
        return False


@contextlib.contextmanager
def node_marks(count):
    """While a stage graph is captured: every ``step`` inside marks its
    op-node range (``count``: the capture's op nodes so far, for example
    ``CaptureOpNodes``). Yields the ``NodeMarks``, whose ``total`` is read
    at the end of the block (the capture still open)."""
    global _MARKS
    marks, outer = NodeMarks(count), _MARKS
    _MARKS = marks
    try:
        yield marks
        marks.total = marks.count()
    finally:
        _MARKS = outer


# --- CUDA graph nodes, through libcuda -----------------------------------------

# CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY and _MEMSET: the nodes that run on the
# device and leave one record each in a device trace
OP_NODE_TYPES = (0, 1, 2)
_LIBCUDA = None


def cu_call(name: str, *args) -> None:
    """libcuda's ``name`` through ctypes; raises on a CUresult other than
    CUDA_SUCCESS."""
    global _LIBCUDA
    import ctypes

    if _LIBCUDA is None:
        _LIBCUDA = ctypes.CDLL("libcuda.so.1")
    err = getattr(_LIBCUDA, name)(*args)
    if err:
        raise RuntimeError(f"{name} failed: CUresult {err}")


def graph_nodes(graph: int) -> list:
    """The node handles of a ``CUgraph`` (a ``cudaGraph_t``: the same
    handle), as libcuda lists them."""
    import ctypes

    handle, n = ctypes.c_void_p(graph), ctypes.c_size_t(0)
    cu_call("cuGraphGetNodes", handle, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    if n.value:
        cu_call("cuGraphGetNodes", handle, nodes, ctypes.byref(n))
    return list(nodes[:n.value])


def node_type(node: int) -> int:
    """A graph node's ``CUgraphNodeType``."""
    import ctypes

    kind = ctypes.c_int(-1)
    cu_call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
    return kind.value


def graph_op_nodes(graph: int) -> int:
    """The kernel, memset and memcpy nodes of a captured ``cudaGraph_t``
    (``torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()``)."""
    return sum(node_type(v) in OP_NODE_TYPES for v in graph_nodes(graph))


class CaptureOpNodes:
    """Called, the kernel, memset and memcpy nodes so far in the CUDA graph
    that ``stream`` (a ``cudaStream_t``, ``torch.cuda.Stream.cuda_stream``)
    is capturing (``cuStreamGetCaptureInfo``); each node's type is read
    once. Raises where the stream is not capturing."""

    def __init__(self, stream: int):
        self.stream = stream
        self.is_op = {}  # node handle -> an op node

    def __call__(self) -> int:
        import ctypes

        status, graph = ctypes.c_int(0), ctypes.c_void_p()
        cu_call("cuStreamGetCaptureInfo_v2", ctypes.c_void_p(self.stream),
                ctypes.byref(status), None, ctypes.byref(graph), None, None)
        if status.value != 1 or not graph.value:  # not _STATUS_ACTIVE
            raise RuntimeError("the stream is not capturing")
        nodes, is_op = graph_nodes(graph.value), self.is_op
        for v in nodes:
            if v not in is_op:
                is_op[v] = node_type(v) in OP_NODE_TYPES
        return sum(is_op[v] for v in nodes)


def step(name: str):
    """A step of a stage program (``raygen``, ``rng``, ``sort``,
    ``entries``, ``walk``, ``trace``, ``shade``, ``occlude``, ``sums``):
    while its graph is captured, the node range it made; otherwise a
    ``span``. A replay runs no Python, so its steps are told apart in a
    device trace by their graph's node ranges (``attribute``)."""
    if _MARKS is not None:
        return _Mark(_MARKS, name)
    if _REC is None:
        return _NOOP
    return _Open(_REC, name, None)


# --- device records against the spans ----------------------------------------

def kineto_events(prof):
    """The device records and the host's runtime calls of a
    ``torch.profiler`` run, each as (start_ns, end_ns, name, correlation
    id): a device record shares its id with the runtime call that launched
    it (every record of a graph replay with its ``cudaGraphLaunch``)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_user_annotation", bool)():
            continue
        a = e.start_ns()
        rec = (a, a + e.duration_ns(), e.name(), e.correlation_id())
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            dev.append(rec)
        elif kind == DeviceType.CPU and rec[2].startswith("cu"):
            host.append(rec)  # a CUDA API call (cuda*, cu*), not a torch op
    return dev, host


def _innermost(spans, times):
    """For each of ``times`` (ascending), the index of the innermost span
    (``spans`` in the order they began, properly nested) that covers it,
    or -1: one sweep, as a span that ends before one time covers no later
    one."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i].start_ns <= t:
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]].end_ns < t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


def _node_steps(nodes) -> list:
    """A replay's step per op node (None outside every step's range): the
    innermost range that holds it."""
    total, ranges = nodes
    out = [None] * total
    # outer ranges first, so inner ones paint over them (an inner range
    # as wide as its outer one was recorded first: last here)
    order = sorted(range(len(ranges)),
                   key=lambda k: (ranges[k][1] - ranges[k][2], -k))
    for k in order:
        name, a, b = ranges[k]
        out[a:b] = [name] * (b - a)
    return out[:total]


def _ancestors(spans, i):
    while i >= 0:
        yield spans[i]
        i = spans[i].parent


def _stage_of(spans, i) -> str:
    """The stage program a span runs in (its ``replay:``/``eager:`` span's
    name, prefix dropped), else its outermost span's name."""
    name = "outside"
    for s in _ancestors(spans, i):
        if s.name.startswith(("replay:", "eager:")):
            return s.name.split(":", 1)[1]
        name = s.name
    return name


def _idle_group(spans, i) -> str:
    """``launch`` inside a ``batch`` span, ``call`` inside a ``render``
    (not a batch) or ``deliver.*`` span, else ``outside``."""
    group = "outside"
    for s in _ancestors(spans, i):
        if s.name == "batch":
            return "launch"
        if s.name == "render" or s.name.startswith("deliver."):
            group = "call"
    return group


def attribute(dev, host, spans) -> dict:
    """Device time and idle time of a trace by program span (seconds).

    ``dev`` and ``host`` as ``kineto_events`` gives them, ``spans`` as
    ``records()["spans"]`` (the same clock). The records that one runtime
    call launched are grouped by correlation id. A ``cudaGraphLaunch``
    inside a replay span: its records, sorted by start, are the graph's
    op nodes in order, and each takes the step whose node range holds it
    (``unnamed`` outside every range); a replay whose record count is not
    its graph's op-node count is ``unattributed`` whole, not guessed. Any
    other launch takes the innermost span around its runtime call
    (``outside`` where none is), and a record with no runtime call in the
    trace is ``unattributed``. Idle gaps between the device's busy
    intervals are labelled by the innermost span at their middle.

    Returns ``device_steps`` (step or span → s), ``device_stages`` (stage
    program → s, ``_stage_of``), ``idle_spans`` (span → s),
    ``idle_groups`` (``_idle_group`` → s), ``busy_s``, ``window_s``,
    ``replays`` and ``replays_matched`` (the graph node check)."""
    import collections

    runtime = {c: (a, name) for a, _, name, c in host}
    groups = collections.defaultdict(list)
    for rec in dev:
        groups[rec[3]].append(rec)
    keys = sorted(c for c in groups if c in runtime)
    where = dict(zip(keys, _innermost(spans, [runtime[c][0] for c in keys])))
    steps, stages = collections.Counter(), collections.Counter()
    replays = matched = 0
    for c, recs in groups.items():
        i = where.get(c, -1)
        if c not in runtime:
            labels = [("unattributed", "unattributed")] * len(recs)
        elif "cudaGraphLaunch" in runtime[c][1]:
            replays += 1
            nodes = spans[i].nodes if i >= 0 else None
            recs.sort()
            stage = _stage_of(spans, i) if i >= 0 else "outside"
            if nodes is not None and nodes[0] == len(recs):
                matched += 1
                labels = [(n or "unnamed", stage) for n in _node_steps(nodes)]
            else:
                labels = [("unattributed", stage)] * len(recs)
        else:
            name = spans[i].name if i >= 0 else "outside"
            labels = [(name, _stage_of(spans, i) if i >= 0
                       else "outside")] * len(recs)
        for (a, b, _, _), (step_name, stage) in zip(recs, labels):
            steps[step_name] += b - a
            stages[stage] += b - a
    # the device's busy intervals and the gaps between them
    dev = sorted(dev)
    busy, gaps = 0, []
    if dev:
        cur0, cur1 = dev[0][0], dev[0][1]
        for a, b, _, _ in dev[1:]:
            if a > cur1:
                busy += cur1 - cur0
                gaps.append((cur1, a))
                cur0, cur1 = a, b
            else:
                cur1 = max(cur1, b)
        busy += cur1 - cur0
    idle, idle_groups = collections.Counter(), collections.Counter()
    for (a, b), i in zip(gaps, _innermost(spans, [(a + b) // 2
                                                   for a, b in gaps])):
        idle[spans[i].name if i >= 0 else "outside"] += b - a
        idle_groups[_idle_group(spans, i) if i >= 0 else "outside"] += b - a
    sec = lambda counter: {k: v * 1e-9 for k, v in counter.most_common()}
    return {
        "device_steps": sec(steps),
        "device_stages": sec(stages),
        "idle_spans": sec(idle),
        "idle_groups": sec(idle_groups),
        "busy_s": busy * 1e-9,
        "window_s": (max(b for _, b, _, _ in dev) - dev[0][0]) * 1e-9
        if dev else 0.0,
        "replays": replays,
        "replays_matched": matched,
    }


def profiled_batch(renderer, cam, seed) -> dict:
    """One batch of ``renderer`` under ``torch.profiler`` (device activity
    alone) with the recorder on: ``attribute``'s split of its device time
    by stage program and by step, its wall seconds and its device records
    (``kineto_events``). A recording under way goes on, its records kept
    (the spans before the batch cover none of its records); else one is
    started for the batch and stopped at its end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    was = recording()
    record(True)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            renderer(cam, seed, 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        record(was)
    dev, host = kineto_events(prof)
    out = attribute(dev, host, records()["spans"])
    out.update(wall_s=wall, records=dev)
    return out


def profile_batch(preset: str = "bunny", **overrides) -> dict:
    import torch

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

    was = recording()
    record(True)  # the warmup captures the graphs: graphs.pool_bytes
    try:
        renderer(cam, seed, 0)  # warmup
    finally:
        record(was)
    pool_bytes = records()["counts"].get("graphs.pool_bytes")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, counts = renderer(cam, seed, 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rays = float(counts[0] + counts[1])

    kernels.reset_launch_counts()
    prof = profiled_batch(renderer, cam, seed)
    by_name = {}
    for a, b, name, _ in prof["records"]:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) * 1e-6, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                  key=lambda r: -r[1])
    busy_ms = prof["busy_s"] * 1e3
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
        "stage_ms": {k: v * 1e3 for k, v in prof["device_stages"].items()},
        "step_ms": {k: v * 1e3 for k, v in prof["device_steps"].items()},
        "graph_replays": [prof["replays"], prof["replays_matched"]],
        "graph_pool_bytes": pool_bytes,
        "profiled_batch_s": prof["wall_s"],
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0,
                                 1.0 - busy_ms / (prof["wall_s"] * 1e3)),
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
    # run as the package's module: under ``python -m`` this file is a
    # second module, whose recorder the renderer's spans would not reach
    from tpurt_torch.utils import profiling

    raise SystemExit(profiling.main())
