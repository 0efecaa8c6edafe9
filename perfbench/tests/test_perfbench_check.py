"""The correctness check fails what it must: the bfloat16 control, and a
run whose timed path is broken underneath (a render that returns its
state unchanged, half of a batch left out with the mean over the rest, a
value altered where it is produced). One process renders, so no exchange
between chips can be left out."""

import dataclasses

import pytest
import torch

from conftest import TINY, run_tiny

CELLS = [c for c, _, _ in TINY]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny_root, cell):
    from perfbench.control import control_share

    for seed in (1, 2**31 + 7, 4000000000):
        off, n_ch, limit = control_share(tiny_root, cell, seed,
                                         torch.device("cpu"),
                                         torch.bfloat16)
        assert n_ch > 0 and off > limit


def _faulty(kind):
    from tpurt_torch import render as port

    real = port.render_scene

    def render_scene(config, scene=None, camera=None, state=None, **kw):
        before = 0 if state is None else int(state.n_samples)
        if kind == "unchanged":
            out, stats = real(config, scene, camera, state, **kw)
            if state is None:
                state = port.fb.new_frame_state(config.width, config.height,
                                                config.seed,
                                                device=out.accum.device)
            return out._replace(accum=state.accum), stats
        if kind == "half":
            k = config.spp - before
            sppb = config.spp_per_batch
            if sppb >= 2:  # half the samples of each batch
                config = dataclasses.replace(config, spp=before + k // 2,
                                             spp_per_batch=sppb // 2)
                return real(config, scene, camera, state, **kw)
            out, stats = real(config, scene, camera, state, **kw)
            if state is not None and int(state.batch_index) % 2:
                return state, stats  # this batch left out
            return out, stats
        out, stats = real(config, scene, camera, state, **kw)  # "altered"
        return out._replace(accum=out.accum * 1.01), stats

    return render_scene


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(tiny_root, cell, kind,
                                          monkeypatch):
    from tpurt_torch import render as port

    monkeypatch.setattr(port, "render_scene", _faulty(kind))
    r = run_tiny(tiny_root, cell, seed=2**31 + 99)
    assert r["correct"] is False, r["checks"]
