"""The span and counter recorder of ``tpurt_torch.utils.profiling``: off,
a render leaves no record and its image is bit-equal to one recorded; on,
``render_scene`` records its spans (names and nesting) and counts its
re-renders; the spans are on the clock of ``torch.profiler``'s records; ``attribute``
splits a trace's device and idle time by span, a graph replay's records by
its steps' node ranges. On the card, each stage graph's marked op-node
count equals the graph's own, and a profiled batch attributes every
replay; a node count that fails leaves a graph without ranges, never
failing the capture."""

import collections
import warnings

import pytest
import torch

from tpurt_torch import render as rd
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.scene.procedural import bunny_standin
from tpurt_torch.utils import profiling as P
from tpurt_torch.utils.config import get_config

SMALL = dict(width=32, height=24, spp=2, spp_per_batch=1, max_bounces=2)
STEPS = {"raygen", "rng", "sort", "entries", "walk", "trace", "shade",
         "occlude", "sums"}


@pytest.fixture
def recorder():
    """Recording off and empty before and after the test."""
    P.record(False)
    P.clear()
    yield
    P.record(False)
    P.clear()


def _render(scene, **over):
    state, stats = rd.render_scene(get_config("bunny", **{**SMALL, **over}),
                                   scene=scene, device="cpu")
    return state, stats


def test_off_records_nothing_and_on_changes_no_pixel(recorder):
    scene = bunny_standin(subdivisions=3)
    off, _ = _render(scene)
    assert P.records() == {"spans": [], "counts": {}, "dropped": 0}
    assert P.span("x") is P.span("y") and P.step("z") is P.span("x")
    P.record(True)
    on, _ = _render(scene)
    P.record(False)
    assert P.records()["spans"]
    assert torch.equal(off.accum, on.accum)


def test_span_names_and_nesting(recorder):
    scene = bunny_standin(subdivisions=3)
    P.record(True)
    state, _ = _render(scene)
    fb.pack_u8(fb.tonemap(fb.resolve(state)))
    _render(scene, seed=3)
    P.record(False)
    rec = P.records()
    spans = rec["spans"]
    assert rec["dropped"] == 0
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)

    def path(s):
        out = [s.name]
        while s.parent >= 0:
            s = spans[s.parent]
            out.append(s.name)
        return "/".join(reversed(out))

    paths = collections.Counter(path(s) for s in spans)
    first = ["render", "render/caps", "render/scene_context",
             "render/scene_context/accel.build",
             "render/scene_context/accel.build/accel.order",
             "render/scene_context/accel.build/accel.pack",
             "render/scene_context/accel.build/accel.shade_rows",
             "render/renderer.build",
             "render/prewarm", "render/batch", "render/batch/set_inputs",
             "render/batch/frame", "render/batch/accumulate",
             "render/readback", "deliver.resolve", "deliver.tonemap",
             "deliver.pack"]
    assert set(first) <= set(paths)
    # two calls of two batches; the scene context and renderer built once
    assert paths["render"] == 2 and paths["render/batch"] == 4
    assert paths["render/scene_context/accel.build"] == 1
    stages = {p.split("/")[2] for p in paths if p.count("/") >= 2
              and p.split("/")[2].startswith("eager:")}
    assert stages == {"eager:trace[0]", "eager:shade_occlude[0]",
                      "eager:trace[1]", "eager:shade_occlude[1]",
                      "eager:trace[2]", "eager:shade_occlude[2]",
                      "eager:resolve"}
    # the steps run inside the stage programs; K1 inside a trace
    steps = {p.split("/")[-1] for p in paths if "/eager:" in p
             and not p.split("/")[-1].startswith("eager:")}
    assert steps == STEPS
    assert any(p.endswith("eager:trace[1]/trace/walk") for p in paths)
    assert any(p.endswith("/shade/rng") for p in paths)
    # each call's spans lie inside its ``render`` span, in order
    calls = [s for s in spans if s.name == "render"]
    assert calls[0].end_ns <= calls[1].start_ns
    for s in spans:
        top = s
        while top.parent >= 0:
            top = spans[top.parent]
        assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
    # no graph captured on the CPU (no graphs.pool_bytes): the counts are
    # the accel build's, once, and the waves by tile mode, six a batch
    assert rec["counts"] == {"accel.triangles": 1286, "accel.clusters": 14,
                             "accel.superclusters": 2,
                             "accel.bytes": rd.accel_build_record()["bytes"],
                             "waves.cluster_rows": 4 * 6}


def test_live_overflow_rerender_is_counted(recorder):
    scene = bunny_standin(subdivisions=3)
    P.record(True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, stats = _render(scene, width=64, height=48, spp=1,
                           live_caps=(1, 1))
    P.record(False)
    assert any("re-rendering uncapped" in str(w.message) for w in caught)
    assert stats["rerenders"] == 1 and not stats["live_overflow"]
    # the capped render and the uncapped one, inside the one call
    assert [s.name for s in P.records()["spans"]
            if s.parent == 0].count("readback") == 2
    _, stats = _render(scene, width=64, height=48, spp=1)
    assert stats["rerenders"] == 0


def test_records_are_capped_and_counted(recorder, monkeypatch):
    monkeypatch.setattr(P, "MAX_RECORDS", 3)
    P.record(True)
    with P.span("a"):
        for _ in range(4):
            with P.span("b"):
                P.count("n", 2)
    rec = P.records()
    assert [s.name for s in rec["spans"]] == ["a", "b", "b"]
    assert rec["dropped"] == 2 and rec["counts"] == {"n": 8}
    P.clear()
    assert P.records() == {"spans": [], "counts": {}, "dropped": 0}


def test_spans_on_the_profilers_clock(recorder):
    """An op run inside a span has its kineto record inside the span's
    bounds, within 50 us."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 16)
    P.record(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with P.span("op"):
                x.mul_(1.0001)
    P.record(False)
    spans = [s for s in P.records()["spans"] if s.name == "op"]
    ops = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mul_")
    assert len(ops) == len(spans) == 3
    for s, t in zip(spans, ops):
        assert s.start_ns - 50_000 <= t <= s.end_ns + 50_000, (s, t)


# --- the reduction on made-up records -------------------------------------

def _span(name, a, b, parent=-1, nodes=None):
    return P.Span(name, a, b, parent, nodes)


def _trace():
    """A batch of two replays (the first with 4 op nodes: rng, a node of
    no step, walk inside trace), an eager launch inside ``accumulate``,
    a copy from outside every span, and a record whose runtime call is
    missing; times in ns."""
    nodes = (4, (("rng", 0, 1), ("walk", 2, 3), ("trace", 1, 4)))
    spans = [_span("render", 0, 1000), _span("batch", 10, 900, 0),
             _span("set_inputs", 10, 100, 1),
             _span("replay:trace[0]", 100, 120, 1, nodes),
             _span("replay:shade_occlude[0]", 120, 140, 1,
                   (2, (("shade", 0, 2),))),
             _span("accumulate", 600, 650, 1), _span("readback", 900, 1000, 0),
             _span("deliver.pack", 1100, 1200)]
    host = [(105, 110, "cudaGraphLaunch", 7),
            (125, 130, "cudaGraphLaunch", 8),
            (610, 615, "cudaLaunchKernel", 9),
            (1300, 1310, "cudaMemcpyAsync", 10)]
    dev = [(200, 210, "k0", 7), (210, 230, "k1", 7), (230, 260, "k2", 7),
           (260, 300, "k3", 7),  # the first replay, nodes in order
           (300, 310, "s0", 8), (310, 330, "s1", 8),
           (700, 740, "add", 9),
           (1150, 1160, "stray", 99),  # its runtime call is not traced
           (1400, 1500, "copy", 10)]
    return dev, host, spans


def test_attribute_by_node_ranges_and_spans():
    dev, host, spans = _trace()
    out = P.attribute(dev, host, spans)
    ms = {k: round(v * 1e9) for k, v in out["device_steps"].items()}
    assert ms == {"rng": 10, "trace": 20 + 40, "walk": 30, "shade": 30,
                  "accumulate": 40, "unattributed": 10, "outside": 100}
    assert sum(out["device_steps"].values()) == pytest.approx(
        sum(b - a for a, b, _, _ in dev) * 1e-9)
    stages = {k: round(v * 1e9) for k, v in out["device_stages"].items()}
    assert stages == {"trace[0]": 100, "shade_occlude[0]": 30,
                      "render": 40, "unattributed": 10, "outside": 100}
    assert (out["replays"], out["replays_matched"]) == (2, 2)
    # gaps: 330-700 (midpoint 515, in the batch), 740-1150 (945, in the
    # readback), 1160-1400 (1280, outside every span)
    idle = {k: round(v * 1e9) for k, v in out["idle_spans"].items()}
    assert idle == {"batch": 370, "readback": 410, "outside": 240}
    groups = {k: round(v * 1e9) for k, v in out["idle_groups"].items()}
    assert groups == {"launch": 370, "call": 410, "outside": 240}
    assert out["busy_s"] == pytest.approx(
        (130 + 40 + 10 + 100) * 1e-9)
    assert out["window_s"] == pytest.approx(1300 * 1e-9)


def test_attribute_counts_a_replay_that_misses_records_unattributed():
    dev, host, spans = _trace()
    dev = [r for r in dev if r[2] != "k2"]  # the profiler lost one
    out = P.attribute(dev, host, spans)
    assert (out["replays"], out["replays_matched"]) == (2, 1)
    steps = out["device_steps"]
    assert "rng" not in steps and "walk" not in steps
    assert round(steps["unattributed"] * 1e9) == 10 + 20 + 10 + 40


def test_node_steps_inner_ranges_win():
    nodes = (6, (("rng", 1, 2), ("shade", 0, 4), ("sort", 4, 5),
                 ("inner", 4, 5), ("outer", 4, 6)))
    # "sort" and "inner" span the same node: the first recorded (exited
    # first: the inner one) wins
    assert P._node_steps(nodes) == ["shade", "rng", "shade", "shade",
                                    "sort", "outer"]


def test_node_marks_record_step_ranges():
    n = [0]
    with P.node_marks(lambda: n[0]) as marks:
        with P.step("shade"):
            n[0] += 2
            with P.step("rng"):
                n[0] += 1
            with P.step("empty"):
                pass
        n[0] += 1
    assert marks.nodes() == (4, (("rng", 2, 3), ("shade", 0, 3)))
    assert P._MARKS is None


def test_node_marks_that_fail_leave_no_ranges():
    """A count that raises (libcuda missing, the stream not capturing)
    marks nothing and fails nothing: the graph's replays are then
    ``unattributed``."""
    n = [0]

    def count():
        if n[0] >= 2:
            raise RuntimeError("cuStreamGetCaptureInfo_v2 failed")
        return n[0]

    with P.node_marks(count) as marks:
        with P.step("shade"):
            n[0] += 2
        with P.step("sums"):
            n[0] += 1
    assert marks.failed and marks.nodes() is None
    with P.node_marks(P.CaptureOpNodes(0)) as marks:  # no card here
        with P.step("rng"):
            pass
    assert marks.nodes() is None
    dev, host, spans = _trace()
    spans[3] = spans[3]._replace(nodes=None)
    out = P.attribute(dev, host, spans)
    assert (out["replays"], out["replays_matched"]) == (2, 1)
    assert round(out["device_steps"]["unattributed"] * 1e9) == 100 + 10


def test_span_cell_split_of_a_traced_cell():
    """``span_cell.py``'s readings from ``attribute`` and perfbench's
    context: step ms a batch summing to the traced records, idle ms a
    unit apportioned by the traced idle's groups, traversal kernels by
    step."""
    import span_cell
    from perfbench import trace as tr

    dev, host, spans = _trace()
    dev = [r if r[2] != "k3" else (*r[:2], "tileloop_kernel", r[3])
           for r in dev]
    attr = P.attribute(dev, host, spans)
    busy = attr["busy_s"]
    ctx = {"trace": {"busy_s": busy, "traversal_s": 40e-9,
                     "other_s": sum(b - a for a, b, _, _ in dev) * 1e-9
                     - 40e-9},
           "traced": {"batches": 2, "units": 1,
                      "plain_unit_s": busy + 2e-6}}
    got = {"attr": attr, "ctx": ctx, "attr_s": 0.0, "n_dev": len(dev),
           "trav": span_cell.traversal_by_step(P, tr, dev, host, spans)}
    out = span_cell.split(P, got)
    assert out["replays"] == [2, 2]
    assert out["sum_steps_ms"] == pytest.approx(
        out["shade_plus_traverse_ms"])
    assert out["step_ms.rng"] == pytest.approx(10e-9 * 1e3 / 2)
    assert out["traversal_by_step"] == {"trace": pytest.approx(40e-9)}
    idle = [out[f"idle_ms.{k}"] for k in ("launch", "call", "outside")]
    assert sum(idle) == pytest.approx(out["idle_unit_ms"]) \
        == pytest.approx(2e-3)
    assert idle[0] / idle[1] == pytest.approx(370 / 410)


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch finds none)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("env", [{}, {"TPURT_FUSE_STAGES": "0"},
                                 {"TPURT_SORTED_WAVE": "1"}],
                         ids=["stages", "unfused", "sorted"])
def test_stage_graph_node_marks_on_cuda(cuda_device, env, monkeypatch):
    """Each stage graph's marked op-node count equals the kernel, memset
    and memcpy nodes of the captured graph, its ranges lie inside it; a
    profiled batch attributes every replay's records by node range."""
    from tpurt_torch.render.staged import StagedRenderer

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    made = torch.cuda.CUDAGraph
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda *a, **k: made(*a, keep_graph=True, **k))
    scene = bunny_standin(subdivisions=3)
    cfg = get_config("bunny", width=96, height=64, spp=2, spp_per_batch=2,
                     max_bounces=2)
    ds = rd.to_device(scene, device=cuda_device)
    meta = rd.scene_meta(scene)
    accel = rd.build_accel(cfg, ds, meta, scene=scene, device=cuda_device)
    r = StagedRenderer(ds, accel, meta=meta, config=cfg, device=cuda_device)
    assert r.prewarm(scene.camera, 1, 0) == len(r._graphs) > 0
    for graph, _, (total, ranges) in r._graphs:
        assert total == P.graph_op_nodes(graph.raw_cuda_graph())
        assert ranges and all(0 <= a < b <= total for _, a, b in ranges)
        assert {name for name, _, _ in ranges} <= STEPS
    P.record(True)
    with P.span("caller"):
        pass
    prof = P.profiled_batch(r, scene.camera, 1)
    assert P.recording()  # the caller's recording goes on, its spans kept
    P.record(False)
    assert P.records()["spans"][0].name == "caller"
    assert prof["replays"] == prof["replays_matched"] == len(r._graphs)
    steps = prof["device_steps"]
    assert "unattributed" not in steps
    assert {"rng", "shade", "sort", "entries", "walk"} <= set(steps)
    assert sum(steps.values()) == pytest.approx(
        sum(b - a for a, b, _, _ in prof["records"]) * 1e-9)
