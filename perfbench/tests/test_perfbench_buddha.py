"""The ``buddha.accum`` cell: found by name (configuration, frozen scene,
traffic, limits, metrics), and a test-size twin of it run on the CPU, its
trace run reading the program's accel build record (``accel_s.order``)."""

import json
import os
import shutil

import pytest

from conftest import ROOT, make_tiny_root, run_tiny

CELL = "buddha.accum"


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_buddha_cell_resolves():
    from perfbench import cell as cell_mod

    bench = _bench()
    cell, config, mix, limits = cell_mod.resolve(ROOT, bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("buddha", "accum", 1)
    assert config["name"] == "buddha" and config["reduced"] == ["scene"]
    assert config["scene"]["builder"] == "buddha_standin"
    bunny = cell_mod.resolve(ROOT, bench, "bunny.accum")[1]
    # the bunny's estimator and frame: only the scene differs
    assert {k: v for k, v in config["render"].items() if k != "scene"} == \
        {k: v for k, v in bunny["render"].items() if k != "scene"}
    assert mix["samples_per_unit"] == 16 and mix["deliver"] == "device"
    assert limits["lower"] < limits["off_share"] < limits["upper"]
    e2e, layer = cell_mod.metrics_of(bench, CELL)
    assert {m["name"] for m in e2e} == {"msamples_per_s", "setup_s"}
    assert {m["name"] for m in layer} == {
        "setup_span.build", "setup_span.scene", "setup_span.graphs",
        "traverse_ms.buddha", "shade_ms.buddha", "idle_share.buddha",
        "accel_s.order"}
    for m in layer:  # each has a reader, by its name or its quantity's
        folder = os.path.join(ROOT, "perfbench", "metrics")
        assert (os.path.exists(os.path.join(folder, m["name"] + ".py"))
                or os.path.exists(os.path.join(
                    folder, m["name"].split(".")[0] + ".py")))


def test_buddha_frozen_scene():
    """The builder gives the scan's triangle count, in well under a
    second's worth of numpy passes, and the scene the configuration
    recorded."""
    from perfbench import scenes

    with open(os.path.join(ROOT, "perfbench", "configs",
                           "buddha.json")) as f:
        config = json.load(f)
    sd = scenes.build(config["scene"]["builder"], config["scene"]["args"])
    assert sd.meshes[0].indices.shape[0] == 1087716
    assert sd.meshes[0].vertices.shape[0] == 543860
    assert config["frozen"] == {
        "triangles": sum(m.indices.shape[0] for m in sd.meshes),
        "instanced_triangles": sd.instanced_triangles(),
        "sha256": sd.checksum()}


def test_buddha_standin_is_closed_and_upright():
    """Every edge of the body is shared by two triangles, every face
    points away from its centre, and it stands on the floor twice as tall
    as it is wide."""
    import numpy as np

    from perfbench.scenes import buddha_standin

    sd = buddha_standin.build(segments=40, bands=41)
    m = sd.meshes[0]
    assert m.indices.shape[0] == 2 * 40 * 40
    e = np.sort(np.concatenate([m.indices[:, [0, 1]], m.indices[:, [1, 2]],
                                m.indices[:, [2, 0]]]), 1)
    _, n = np.unique(e, axis=0, return_counts=True)
    assert (n == 2).all()
    v = m.vertices.astype(np.float64)
    t = v[m.indices]
    out = np.einsum("ij,ij->i", np.cross(t[:, 1] - t[:, 0],
                                         t[:, 2] - t[:, 0]), t.mean(1))
    assert (out > 0).all()
    lo = v.min(0) + sd.instances[0].transform[:, 3]
    hi = v.max(0) + sd.instances[0].transform[:, 3]
    assert 0.0 < lo[1] < 0.2
    assert 1.6 < (hi[1] - lo[1]) / (hi[0] - lo[0]) < 2.4


@pytest.fixture(scope="module")
def tiny_buddha(tmp_path_factory):
    """A test-size copy of the benchmark with ``tinyb.accum``: the Buddha
    configuration at 1,152 + 6 triangles and 32 × 24."""
    root = make_tiny_root(str(tmp_path_factory.mktemp("buddha")))
    cfg_dir = os.path.join(root, "perfbench", "configs")
    with open(os.path.join(cfg_dir, "buddha.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "buddha_tiny"
    cfg["scene"]["args"] = {"segments": 24, "bands": 25}
    cfg["render"]["width"], cfg["render"]["height"] = 32, 24
    with open(os.path.join(cfg_dir, "buddha_tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "buddha_tiny", "source": "test size",
                             "file": "perfbench/configs/buddha_tiny.json",
                             "reduced": [], "why": "test size"})
    bench["workloads"].append({"name": "tinyb.accum",
                               "config": "buddha_tiny", "traffic": "accum",
                               "chips": 1, "why": "test size"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tinyb.accum")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    limits = os.path.join(root, "perfbench", "limits")
    shutil.copy(os.path.join(limits, f"{CELL}.json"),
                os.path.join(limits, "tinyb.accum.json"))
    return root


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_tiny_buddha_runs_correct(tiny_buddha, trace):
    r = run_tiny(tiny_buddha, "tinyb.accum", trace=trace)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    if trace:  # no device on the CPU: the trace readers find nothing
        assert set(r["metrics"]) == {"setup_span.build", "setup_span.scene",
                                     "setup_span.graphs", "accel_s.order"}
        assert 0 < r["metrics"]["accel_s.order"]["value"] <= \
            r["metrics"]["setup_span.scene"]["value"]
    else:
        assert set(r["metrics"]) == {"msamples_per_s", "setup_s"}


def test_accel_reader_finds_nothing_without_a_record(monkeypatch):
    """Where the program keeps no build record (an older program), the
    reader returns None and the line leaves the metric out."""
    from perfbench import cell as cell_mod
    from tpurt_torch import render

    monkeypatch.delattr(render, "accel_build_record")
    assert cell_mod.read_metric(ROOT, "accel_s.order", {}) is None
