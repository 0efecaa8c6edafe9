"""The port's render_scene end to end on the CPU (plain kernel versions):
against the reference's staged bvh_tile render of the same scene and
seed, against the committed bunny golden, for determinism, and for the
uncapped re-render when a live-wave cap cuts alive rays.

Image tolerances: RMSE ≤ 1e-3 (tests/golden/test_golden.py) and, against
the reference render, under 2% of pixels off by more than 1e-3 — a
decision at the last ulp (shadow contrib > 0, a mirror path) can reroute
a whole path at a few pixels (tests/unit/test_staged.py).
"""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from tests.golden.configs import GOLDENS
from tpurt.render import framebuffer as ref_fb
from tpurt.render import render_scene as ref_render
from tpurt.scene.procedural import bunny_standin as ref_bunny
from tpurt.utils.config import get_config as ref_config
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render import render_scene
from tpurt_torch.scene.procedural import bunny_standin, cornell_box
from tpurt_torch.utils.config import get_config

RMSE_TOL = 1e-3
SMALL = dict(width=64, height=48, spp=2, spp_per_batch=2, max_bounces=2,
             intersector="bvh_tile")


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


@pytest.fixture(scope="module")
def port_small():
    state, stats = render_scene(get_config("bunny", **SMALL), device="cpu",
                                scene=bunny_standin(subdivisions=3))
    return fb.resolve(state).numpy(), stats


def test_matches_reference_staged_render(port_small):
    img, stats = port_small
    ref_state, ref_stats = ref_render(
        ref_config("bunny", pipeline="staged", **SMALL),
        scene=ref_bunny(subdivisions=3))
    want = np.asarray(ref_fb.resolve(ref_state))
    assert img.shape == want.shape == (48, 64, 3)
    assert _rmse(img, want) <= RMSE_TOL
    assert float((np.abs(img - want) > 1e-3).mean()) < 0.02
    # same counter layout, same ray counts (up to a rerouted path)
    for key in ("rays_closest", "rays_shadow"):
        np.testing.assert_allclose(stats[key], ref_stats[key], rtol=1e-3)
    for key in ("live_counts", "want_counts"):
        assert len(stats[key]) == len(ref_stats[key]) == 3
        np.testing.assert_allclose(stats[key], ref_stats[key], rtol=1e-3,
                                   atol=1.0)
    assert not stats["live_overflow"] and not stats["pair_overflow"]


def test_bunny_golden():
    """The golden fixture (full 82k-tri bunny) against bunny.npz."""
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                  "data", "bunny.npz"))["image"]
    state, stats = render_scene(get_config("bunny", **GOLDENS["bunny"]),
                                device="cpu")
    img = fb.resolve(state).numpy()
    assert img.shape == golden.shape
    assert _rmse(img, golden) <= RMSE_TOL
    assert stats["spp"] == GOLDENS["bunny"]["spp"]


def test_same_seed_bit_equal(port_small):
    img, _ = port_small
    state, _ = render_scene(get_config("bunny", **SMALL), device="cpu",
                            scene=bunny_standin(subdivisions=3))
    assert np.array_equal(fb.resolve(state).numpy(), img)


def test_adequate_caps_bit_identical(port_small):
    img, stats = port_small
    n = SMALL["width"] * SMALL["height"] * SMALL["spp_per_batch"]
    caps = tuple(min(n, int(v) + 1024) for v in stats["live_counts"][:2])
    scaps = tuple(min(n, int(v) + 1024) for v in stats["want_counts"])
    cfg = get_config("bunny", live_caps=caps, shadow_caps=scaps, **SMALL)
    state, st = render_scene(cfg, device="cpu",
                             scene=bunny_standin(subdivisions=3))
    assert not st["live_overflow"]
    assert np.array_equal(fb.resolve(state).numpy(), img)


def test_tight_caps_rerender_uncapped(port_small):
    """Caps that cut alive rays warn and re-render uncapped — the image
    equals the uncapped render (mirrors tests/unit/test_live_trunc.py)."""
    img, _ = port_small
    cfg = get_config("bunny", live_caps=(1024, 1024),
                     shadow_caps=(1024, 1024, 1024), **SMALL)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, st = render_scene(cfg, device="cpu",
                                 scene=bunny_standin(subdivisions=3))
    assert any("re-rendering uncapped" in str(w.message) for w in caught)
    assert not st["live_overflow"]
    assert np.array_equal(fb.resolve(state).numpy(), img)


def test_progressive_resume_matches_straight_through():
    """Two batches in one call equal one batch plus a resumed batch."""
    cfg = get_config("bunny", **dict(SMALL, spp=2, spp_per_batch=1))
    scene = bunny_standin(subdivisions=3)
    full, _ = render_scene(cfg, device="cpu", scene=scene)
    half, _ = render_scene(dataclasses.replace(cfg, spp=1), device="cpu",
                           scene=scene)
    resumed, _ = render_scene(cfg, device="cpu", scene=scene, state=half)
    assert resumed.n_samples == full.n_samples == 2
    assert torch.equal(resumed.accum, full.accum)


def test_unported_paths_raise():
    scene = bunny_standin(subdivisions=3)
    for kw in (dict(pipeline="mega"), dict(pipeline="wavefront"),
               dict(intersector="brute"), dict(n_tile_shards=2),
               dict(n_sample_shards=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            render_scene(get_config("bunny", **dict(SMALL, **kw)),
                         device="cpu", scene=scene)
    # ≤ 8 clusters: the all-pairs mode is not ported
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render_scene(get_config("cornell", width=32, height=32, spp=1,
                                spp_per_batch=1), device="cpu",
                     scene=cornell_box())


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        render_scene(get_config("bunny", **SMALL), device="cuda",
                     scene=bunny_standin(subdivisions=3))
