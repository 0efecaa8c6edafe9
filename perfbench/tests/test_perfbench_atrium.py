"""The ``atrium.accum`` cell: found by name (configuration, frozen scene,
traffic, limits, metrics), and a test-size twin of it (12-segment,
4-ring columns at 48 × 32) run on the CPU through the two-level
pair-cluster accel."""

import json
import os
import shutil

import pytest

from conftest import ROOT, make_tiny_root, run_tiny

CELL = "atrium.accum"


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_atrium_cell_resolves():
    from perfbench import cell as cell_mod

    bench = _bench()
    cell, config, mix, limits = cell_mod.resolve(ROOT, bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("atrium", "accum", 1)
    assert config["name"] == "atrium" and config["reduced"] == ["scene"]
    assert config["scene"] == {"builder": "atrium_standin",
                               "args": {"column_segments": 48,
                                        "column_rings": 27}}
    # the program's sponza preset's frame, bounces and estimator, at the
    # accumulation traffic's batch: 8 samples a pixel, 16,588,800 camera
    # rays a wave, under the raised cap on a batch's rays
    assert config["render"] == {
        "scene": "atrium", "width": 1920, "height": 1080,
        "spp_per_batch": 8, "max_rays_per_batch": 1 << 24,
        "max_bounces": 2, "use_nee": True,
        "intersector": "auto", "instancing": "auto", "pipeline": "auto"}
    assert 1920 * 1080 * 8 <= config["render"]["max_rays_per_batch"]
    assert mix["samples_per_unit"] == 16 and mix["deliver"] == "device"
    assert limits["lower"] < limits["off_share"] < limits["upper"]
    e2e, layer = cell_mod.metrics_of(bench, CELL)
    assert {m["name"] for m in e2e} == {"msamples_per_s", "setup_s"}
    assert {m["name"] for m in layer} == {
        "setup_span.build", "setup_span.scene", "setup_span.graphs",
        "traverse_ms.atrium", "shade_ms.atrium", "idle_share.atrium"}
    for m in layer:  # each has a reader, by its name or its quantity's
        folder = os.path.join(ROOT, "perfbench", "metrics")
        assert (os.path.exists(os.path.join(folder, m["name"] + ".py"))
                or os.path.exists(os.path.join(
                    folder, m["name"].split(".")[0] + ".py")))


def test_atrium_frozen_scene():
    """The scene builder gives the configuration's recorded scene: 5 meshes,
    126 instances, 2,716 stored and 258,388 instanced triangles."""
    from perfbench import scenes

    with open(os.path.join(ROOT, "perfbench", "configs",
                           "atrium.json")) as f:
        config = json.load(f)
    sd = scenes.build(config["scene"]["builder"], config["scene"]["args"])
    assert (len(sd.meshes), len(sd.instances)) == (5, 126)
    assert sd.meshes[0].indices.shape[0] == 2 * 48 * (27 + 1)
    assert config["frozen"] == {
        "triangles": sum(m.indices.shape[0] for m in sd.meshes),
        "instanced_triangles": sd.instanced_triangles(),
        "sha256": sd.checksum()}
    assert (config["frozen"]["triangles"],
            config["frozen"]["instanced_triangles"]) == (2716, 258388)


@pytest.fixture(scope="module")
def tiny_atrium(tmp_path_factory):
    """A test-size copy of the benchmark with ``tinya.accum``: the atrium
    configuration with 12-segment, 4-ring columns (11,860 instanced
    triangles) at 48 × 32."""
    root = make_tiny_root(str(tmp_path_factory.mktemp("atrium")))
    cfg_dir = os.path.join(root, "perfbench", "configs")
    with open(os.path.join(cfg_dir, "atrium.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "atrium_tiny"
    cfg["scene"]["args"] = {"column_segments": 12, "column_rings": 4}
    cfg["render"]["width"], cfg["render"]["height"] = 48, 32
    with open(os.path.join(cfg_dir, "atrium_tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "atrium_tiny", "source": "test size",
                             "file": "perfbench/configs/atrium_tiny.json",
                             "reduced": [], "why": "test size"})
    bench["workloads"].append({"name": "tinya.accum",
                               "config": "atrium_tiny", "traffic": "accum",
                               "chips": 1, "why": "test size"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tinya.accum")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    limits = os.path.join(root, "perfbench", "limits")
    shutil.copy(os.path.join(limits, f"{CELL}.json"),
                os.path.join(limits, "tinya.accum.json"))
    return root


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_tiny_atrium_runs_correct(tiny_atrium, trace):
    from tpurt_torch import render

    r = run_tiny(tiny_atrium, "tinya.accum", trace=trace)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert render.accel_build_record()["kind"] == "PairAccelTL"
    if trace:  # no device on the CPU: the trace readers find nothing
        assert set(r["metrics"]) == {"setup_span.build", "setup_span.scene",
                                     "setup_span.graphs"}
    else:
        assert set(r["metrics"]) == {"msamples_per_s", "setup_s"}
