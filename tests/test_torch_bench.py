"""The port's benchmark entry (``python -m tpurt_torch.bench``) on the
CPU: the root ``bench.py``'s flags and defaults, one JSON line from the
parent and its child with ``--cpu`` whose ray count is the reference's
for the same config, and the failure line (``value`` 0.0, exit code 1)
for a child that fails — among them a run without ``--cpu`` where torch
finds no CUDA device, which has no fallback to the CPU.

Ray counts are exact: both packages count the rays their waves trace
from the same counter-based samples.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from tpurt.render import render_scene as ref_render_scene
from tpurt.utils.config import get_config as ref_config
from tpurt_torch.bench import make_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--scene", "cornell", "--width", "32", "--height", "32", "--spp",
        "2", "--spp-per-batch", "2", "--max-bounces", "1", "--intersector",
        "bvh_tile"]
DETAIL_KEYS = {"scene", "resolution", "spp", "rays_traced", "elapsed_s",
               "warmup_s", "warmup_build_s", "warmup_scene_s",
               "warmup_other_s", "mrays_min", "mrays_max", "runs_mrays",
               "device", "platform"}


def _bench(*args):
    """``python -m tpurt_torch.bench ARGS`` from the repository's root:
    (exit code, the JSON lines of its standard output, its errors)."""
    r = subprocess.run(
        [sys.executable, "-m", "tpurt_torch.bench", *args], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    return r.returncode, lines, r.stderr


def _actions(parser):
    return sorted((tuple(a.option_strings), a.dest, a.default, a.type,
                   a.nargs, a.const, type(a).__name__)
                  for a in parser._actions)


def test_parser_matches_root_bench():
    """The same flags and defaults as the root bench.py (loaded by path;
    it imports no jax at module level)."""
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    assert _actions(make_parser()) == _actions(root.make_parser())


def test_cpu_run_prints_one_line_with_the_reference_ray_count():
    rc, lines, err = _bench(*TINY, "--cpu")
    assert rc == 0, err
    assert len(lines) == 1
    line = lines[0]
    assert set(line) == {"metric", "value", "unit", "detail"}
    assert line["metric"] == "Mrays/sec/chip (cornell)"
    assert line["unit"] == "Mrays/s" and line["value"] > 0
    detail = line["detail"]
    assert set(detail) == DETAIL_KEYS  # no "gpu" line off the card
    assert detail["platform"] == "cpu" and detail["device"] == "cpu"
    assert detail["resolution"] == "32x32" and detail["spp"] == 2
    assert len(detail["runs_mrays"]) == 5
    assert (detail["mrays_min"] <= line["value"] <= detail["mrays_max"])
    assert detail["warmup_build_s"] == 0.0
    assert detail["warmup_s"] >= detail["warmup_scene_s"] > 0

    # the reference's count for the same config, its tile intersector in
    # interpret mode as tests/golden/test_tile_e2e.py runs it
    _, stats = ref_render_scene(ref_config(
        "cornell", width=32, height=32, spp=2, spp_per_batch=2,
        max_bounces=1, intersector="bvh_tile"))
    assert detail["rays_traced"] == stats["rays_traced"]


def test_failing_child_gives_the_failure_line():
    rc, lines, err = _bench("--scene", "no_such_scene", "--width", "16",
                            "--height", "16", "--spp", "1",
                            "--spp-per-batch", "1", "--cpu",
                            "--retries", "1")
    assert rc == 1
    assert lines == [{"metric": "Mrays/sec/chip (no_such_scene)",
                      "value": 0.0, "unit": "Mrays/s",
                      "detail": {"error": lines[0]["detail"]["error"]}}]
    assert lines[0]["detail"]["error"]
    assert "attempt 1 failed" in err


def test_without_cpu_flag_needs_the_card():
    """No --cpu and no CUDA device: the failure line and exit code 1,
    no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure it")
    rc, lines, _ = _bench(*TINY, "--retries", "1")
    assert rc == 1 and len(lines) == 1
    assert lines[0]["value"] == 0.0
    assert "no CUDA device" in lines[0]["detail"]["error"]
