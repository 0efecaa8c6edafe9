"""The small helpers of the reference's surface, against the reference:
``render.estimate_rays``, ``render.framebuffer.reset`` and
``utils.profiling``'s ``trace``, ``timed`` and ``frame_log``. Integers
and strings are compared exactly."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import estimate_rays as ref_estimate
from tpurt.render import framebuffer as ref_fb
from tpurt.utils import profiling as ref_prof
from tpurt.utils.config import PRESETS as REF_PRESETS
from tpurt.utils.config import get_config as ref_config
from tpurt_torch.render import estimate_rays
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.utils import profiling
from tpurt_torch.utils.config import PRESETS, get_config


@pytest.mark.parametrize("name", sorted(REF_PRESETS))
@pytest.mark.parametrize("over", [{}, dict(use_nee=False),
                                  dict(max_bounces=5, width=33, height=17)],
                         ids=["preset", "no_nee", "resized"])
def test_estimate_rays_matches_reference(name, over):
    assert name in PRESETS
    want = ref_estimate(ref_config(name, **over))
    got = estimate_rays(get_config(name, **over))
    assert type(got) is int and got == want > 0


def test_reset_clears_the_accumulation():
    state = fb.new_frame_state(5, 3, seed=9, device="cpu")
    state = fb.accumulate(state, torch.ones((3, 5, 3)), 4)
    state = fb.accumulate(state, torch.ones((3, 5, 3)), 4)
    got = fb.reset(state)
    ref = ref_fb.reset(ref_fb.accumulate(
        ref_fb.new_frame_state(5, 3, seed=9), jnp.ones((3, 5, 3)), 8))
    assert (got.n_samples, got.seed, got.batch_index) == (
        ref.n_samples, ref.seed, ref.batch_index) == (0, 9, 0)
    assert got.accum.device == state.accum.device
    assert got.accum.dtype == torch.float32
    np.testing.assert_array_equal(got.accum.numpy(), np.asarray(ref.accum))
    assert float(state.accum.sum()) == 2 * 45  # the old state is untouched


@pytest.mark.parametrize("args", [
    (0, 8, 7680000.0, 0.0731, 1),
    (3, 16, 1.5e9 + 0.7, 12.5, 4),
    (11, 1, 0.0, 0.0, 1),
    (2, 2, 123456.0, 1e-12, 1),
])
def test_frame_log_matches_reference(tmp_path, args):
    want = ref_prof.frame_log(*args)
    got = profiling.frame_log(*args)
    assert got == want
    assert set(json.loads(got)) == {"frame", "samples", "rays",
                                    "mrays_per_s", "frame_ms", "chips"}
    path = str(tmp_path / "frames.jsonl")
    profiling.frame_log(*args, jsonl_path=path)
    profiling.frame_log(*args, jsonl_path=path)
    with open(path) as f:
        assert f.read() == (want + "\n") * 2


def test_timed_adds_to_its_sink(capsys):
    sink = {}
    for _ in range(2):
        with profiling.timed("stage", sink):
            torch.ones(1000).sum()
    with profiling.timed("other", sink, verbose=True):
        pass
    assert set(sink) == {"stage", "other"}
    assert sink["stage"] > 0.0 and sink["other"] >= 0.0
    out = capsys.readouterr().out.strip()
    assert out.startswith("[tpurt] other: ") and out.endswith(" ms")
    with pytest.raises(KeyError):  # the bracket closes on an error too
        with profiling.timed("failed", sink):
            raise KeyError("x")
    assert "failed" in sink


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "prof")
    with profiling.trace(log_dir, cuda=False) as path:
        torch.arange(64.0).sum()
    assert path == os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
