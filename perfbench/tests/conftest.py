"""Fixtures of the benchmark's own tests: a copy of the benchmark at test
size (tiny scenes and frames, short windows), run on the CPU through the
program's plain kernel versions."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the test-size twin of each cell: (cell, configuration, traffic)
TINY = (("tiny.accum", "bunny_tiny", "accum"),
        ("tiny.preview", "bunny_tiny", "preview"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skips where torch finds none")


def make_tiny_root(dest: str) -> str:
    """A checkout-like directory at ``dest``: BENCHMARK.json and perfbench/
    copied, plus test-size configurations, cells and limits."""
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(dest, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg_dir = os.path.join(dest, "perfbench", "configs")
    for name, size, scene_args in (
            ("bunny", (32, 24), {"subdivisions": 2}),):
        with open(os.path.join(cfg_dir, f"{name}.json")) as f:
            cfg = json.load(f)
        cfg["name"] = f"{name}_tiny"
        cfg["scene"]["args"] = scene_args
        cfg["render"]["width"], cfg["render"]["height"] = size
        with open(os.path.join(cfg_dir, f"{name}_tiny.json"), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({
            "name": f"{name}_tiny", "source": "test size",
            "file": f"perfbench/configs/{name}_tiny.json", "reduced": [],
            "why": "test size"})
    for tdir in ("traffic",):
        for fname in os.listdir(os.path.join(dest, "perfbench", tdir)):
            path = os.path.join(dest, "perfbench", tdir, fname)
            with open(path) as f:
                mix = json.load(f)
            mix["check"]["pixels"] = 128
            mix["trace_seconds"] = 0.5
            with open(path, "w") as f:
                json.dump(mix, f)
    twin = {"bunny.accum": "tiny.accum", "bunny.preview": "tiny.preview"}
    for cell, cfg, mix in TINY:
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": mix, "chips": 1,
                                   "why": "test size"})
        shutil.copy(os.path.join(dest, "perfbench", "limits",
                                 next(k for k, v in twin.items()
                                      if v == cell) + ".json"),
                    os.path.join(dest, "perfbench", "limits",
                                 f"{cell}.json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [twin[w] for w in m["workloads"] if w in twin]
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("bench")))


def run_tiny(root, cell, seed=12345678901, seconds=0.5, trace=False):
    """One CPU run of a test-size cell: (result line, stderr lines)."""
    import time

    import torch

    from perfbench import cell as cell_mod

    return cell_mod.run(root, cell, seed, seconds, trace,
                        torch.device("cpu"), 0.0, time.perf_counter())
