"""The harness on the CPU at test size: cells, configurations, traffic
mixes and metric readers found by name; the result line's keys; the
frozen scenes; and, on a card, one short run of each real cell."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, TINY, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", [c for c, _, _ in TINY])
def test_tiny_cell_runs_correct(tiny_root, cell, trace):
    r = run_tiny(tiny_root, cell, trace=trace)
    assert list(r)[:5] == KEYS[:5] and list(r)[-1] == "checks"
    assert set(r) <= set(KEYS) | {"breakdown"}
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    from perfbench.cell import metrics_of

    e2e, layer = metrics_of(bench, cell)
    if trace:  # no device on the CPU: the trace readers find nothing
        assert set(r["metrics"]) == {"setup_span.build", "setup_span.scene",
                                     "setup_span.graphs"}
    else:
        assert set(r["metrics"]) == {m["name"] for m in e2e}
    for m in r["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert r["checks"]["off_share"]["value"] <= \
        r["checks"]["off_share"]["limit"]


def test_new_config_traffic_and_metric_need_no_harness_edit(tmp_path):
    """A later change adds a cell as files only: a configuration, a traffic
    mix, a limits file and a per-layer metric reader."""
    from conftest import make_tiny_root

    root = make_tiny_root(str(tmp_path / "copy"))
    bench_dir = os.path.join(root, "perfbench")
    with open(os.path.join(bench_dir, "configs", "bunny_tiny.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "bunny_flat"
    cfg["render"]["max_bounces"] = 0
    with open(os.path.join(bench_dir, "configs", "bunny_flat.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "traffic", "preview.json")) as f:
        mix = json.load(f)
    mix["units_per_accumulation"] = 3
    with open(os.path.join(bench_dir, "traffic", "burst.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench_dir, "metrics", "units_seen.py"),
              "w") as f:
        f.write("def read(ctx):\n    return 1.0 + ctx['traced']['units']\n")
    shutil.copy(os.path.join(bench_dir, "limits", "tiny.preview.json"),
                os.path.join(bench_dir, "limits", "flat.burst.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "bunny_flat", "source": "test",
                             "file": "perfbench/configs/bunny_flat.json",
                             "reduced": ["max_bounces"], "why": "test"})
    bench["workloads"].append({"name": "flat.burst", "config": "bunny_flat",
                               "traffic": "burst", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"].endswith(".preview"):
            m["workloads"].append("flat.burst")
    bench["per_layer"].append({"name": "units_seen", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "frame_ms.preview",
                               "workloads": ["flat.burst"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    r = run_tiny(root, "flat.burst", trace=True)
    assert r["correct"] is True
    assert r["metrics"]["units_seen"]["value"] > 1.0
    r = run_tiny(root, "flat.burst")
    assert set(r["metrics"]) == {m["name"] for m in bench["end_to_end"]
                                 if "flat.burst" in m.get("workloads",
                                                          ["flat.burst"])}
    assert "frame_ms.preview" in r["metrics"]


@pytest.mark.parametrize("builder,args,triangles,instanced,digest", [
    ("bunny_standin", {"subdivisions": 6}, 81926, 81926,
     "e0cd581133190fb2d9fb0f5f50157a51579bc6de9543a17a051d783f30f1ca22"),
])
def test_frozen_scenes(builder, args, triangles, instanced, digest):
    """The frozen builders give the scenes recorded when the benchmark was
    defined, and the configurations record the same."""
    from perfbench import scenes

    sd = scenes.build(builder, args)
    assert sum(m.indices.shape[0] for m in sd.meshes) == triangles
    assert sd.instanced_triangles() == instanced
    assert sd.checksum() == digest
    name = builder.split("_")[0]
    with open(os.path.join(ROOT, "perfbench", "configs",
                           f"{name}.json")) as f:
        frozen = json.load(f)["frozen"]
    assert frozen == {"triangles": triangles, "instanced_triangles":
                      instanced, "sha256": digest}


def test_traffic_is_the_same_work_for_every_seed():
    from perfbench import traffic

    for name in ("accum", "preview"):
        mix = traffic.load(ROOT, name)
        a = [next(g) for g in [traffic.units(mix, 3)] for _ in range(40)]
        gen = traffic.units(mix, 2**31 + 12345)
        b = [next(gen) for _ in range(40)]
        strip = lambda u: (u.index, u.first, u.samples)
        assert [strip(u) for u in a] == [strip(u) for u in b]
        assert {u.seed for u in a} != {u.seed for u in b}


def test_cli_refuses_without_a_card():
    """Without CUDA (or in a directory without the program) the command
    exits non-zero and prints no result."""
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "bunny.accum", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["bunny.accum", "bunny.preview"])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        cell, "--seed", "2147483649", "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def test_trace_reduction_of_a_made_up_record():
    """Busy time is the union of the device operations' intervals inside
    the window that the first and last of them bound; each idle gap takes
    the name of the host's runtime call in flight at its middle."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from perfbench import trace as tr

    def ev(start, end, name, kind, note=False):
        return SimpleNamespace(start_ns=lambda: start,
                               duration_ns=lambda: end - start,
                               name=lambda: name, device_type=lambda: kind,
                               is_user_annotation=lambda: note)

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    record = [ev(0, 10, "fill", cuda),
              ev(30, 80, "tileloop_kernel<0>", cuda),
              ev(60, 100, "shade", cuda),
              ev(100, 900, "span", cuda, note=True),
              ev(150, 200, "slab_kernel<true>(x)", cuda),
              ev(20, 40, "cudaGraphLaunch", cpu),
              ev(110, 140, "cudaMemcpyAsync", cpu),
              ev(190, 200, "fill", cuda)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: record)))
    s = tr.reduce(prof)
    assert s["window_s"] == pytest.approx(200e-9)
    assert s["busy_s"] == pytest.approx((10 + 70 + 50) * 1e-9)
    assert s["traversal_s"] == pytest.approx(100e-9)
    assert s["k1_records"] == 1 and s["k2_records"] == 1
    assert dict(s["idle_gaps"]) == pytest.approx(
        {"cudaGraphLaunch": 20e-9, "cudaMemcpyAsync": 50e-9})
