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

# One intra-op thread: the suite runs in several worker processes on a few
# cores, where torch's default pool (one thread per core, spinning at each
# barrier) slows these small-tensor tests by two orders of magnitude.
torch.set_num_threads(1)

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
    """The paths once unported: multi-device sharding in a single process
    (a world of one rank) raises ValueError naming the world it needs
    (tests/test_torch_multihost.py renders in such worlds); the mega and
    wavefront pipelines and the brute force render the bunny subset
    within RMSE 1e-3 of the staged loop's image."""
    scene = bunny_standin(subdivisions=3)
    for kw in (dict(n_tile_shards=2), dict(n_sample_shards=2)):
        with pytest.raises(ValueError, match="needs a world of 2 ranks"):
            render_scene(get_config("bunny", **dict(SMALL, **kw)),
                         device="cpu", scene=scene)
    staged, _ = render_scene(get_config("bunny", **SMALL), device="cpu",
                             scene=scene)
    want = fb.resolve(staged).numpy()
    for kw in (dict(pipeline="mega"), dict(pipeline="wavefront"),
               dict(intersector="brute")):
        state, stats = render_scene(get_config("bunny", **dict(SMALL, **kw)),
                                    device="cpu", scene=scene)
        img = fb.resolve(state).numpy()
        assert img.shape == want.shape and np.isfinite(img).all()
        assert _rmse(img, want) <= RMSE_TOL, kw
        assert stats["rays_shadow"] > 0
    # ≤ 8 clusters take the all-pairs mode, which renders now
    state, stats = render_scene(get_config("cornell", width=32, height=32,
                                           spp=1, spp_per_batch=1),
                                device="cpu", scene=cornell_box())
    img = fb.resolve(state).numpy()
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01 and stats["rays_shadow"] > 0


@pytest.mark.parametrize("name", ["hello_triangle", "cornell", "bunny",
                                  "cornell_pt", "sponza"])
def test_every_ladder_preset_renders(name):
    """Every preset of the ladder renders through render_scene (its own
    scene at full geometry, a small frame), in the reference's mode:
    flat shading for hello_triangle, the two-level accel for sponza."""
    cfg = get_config(name, width=32, height=24, spp=1, spp_per_batch=1)
    state, stats = render_scene(cfg, device="cpu")
    img = fb.resolve(state).numpy()
    assert img.shape == (24, 32, 3) and np.isfinite(img).all()
    assert stats["rays_closest"] >= 32 * 24
    if name == "hello_triangle":  # primary rays only, no light sampling
        assert stats["rays_closest"] == 32 * 24 and stats["rays_shadow"] == 0


@pytest.mark.parametrize("name,over", [
    ("cornell", dict(width=32, height=32, spp=2, spp_per_batch=2,
                     max_bounces=1, intersector="bvh_tile")),
])
def test_rays_traced_equal_the_reference(name, over):
    """The rays the port counts on its waves equal the reference's for
    the same config, exactly: both trace from the same counter-based
    samples (the reference's tile intersector in interpret mode)."""
    _, stats = render_scene(get_config(name, **over), device="cpu")
    _, ref_stats = ref_render(ref_config(name, **over))
    assert stats["rays_traced"] == ref_stats["rays_traced"] > 0


def test_flat_shading_matches_reference():
    """hello_triangle's flat shading (albedo at a hit, background on a
    miss) equals the reference's staged render bit for bit."""
    over = dict(width=40, height=30, spp=2, spp_per_batch=2,
                intersector="bvh_tile")
    state, _ = render_scene(get_config("hello_triangle", **over),
                            device="cpu")
    ref_state, _ = ref_render(ref_config("hello_triangle", pipeline="staged",
                                         **over))
    want = np.asarray(ref_fb.resolve(ref_state))
    np.testing.assert_array_equal(fb.resolve(state).numpy(), want)
    assert len(np.unique(want.reshape(-1, 3), axis=0)) >= 2


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        render_scene(get_config("bunny", **SMALL), device="cuda",
                     scene=bunny_standin(subdivisions=3))


def test_entry_points_default_to_the_card():
    """to_device, build_accel, make_staged_renderer, new_frame_state,
    render_scene and render_to_png run on the card unless the caller asks
    for the CPU: without one, each raises rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from tpurt_torch.render import build_accel, render_to_png
    from tpurt_torch.render.intersectors import scene_meta
    from tpurt_torch.render.staged import make_staged_renderer
    from tpurt_torch.scene.device import to_device

    scene = bunny_standin(subdivisions=3)
    cfg = get_config("bunny", **SMALL)
    meta = scene_meta(scene)
    ds = to_device(scene, device="cpu")
    calls = (lambda: to_device(scene),
             lambda: build_accel(cfg, ds, meta, scene=scene),
             lambda: make_staged_renderer(ds, None, meta=meta, config=cfg),
             lambda: fb.new_frame_state(8, 6),
             lambda: render_scene(cfg, scene=scene),
             lambda: render_to_png(cfg, os.devnull))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert fb.new_frame_state(8, 6, device="cpu").accum.device.type == "cpu"


def test_make_staged_renderer_is_the_staged_loop():
    """The reference's factory, called as the reference calls it, gives
    the batch of StagedRenderer with the same arguments, bit for bit."""
    from tpurt_torch.render import build_accel
    from tpurt_torch.render.intersectors import scene_meta
    from tpurt_torch.render.staged import (StagedRenderer,
                                           make_staged_renderer)
    from tpurt_torch.scene.device import to_device

    scene = bunny_standin(subdivisions=3)
    cfg = get_config("bunny", **SMALL)
    meta = scene_meta(scene)
    ds = to_device(scene, device="cpu")
    accel = build_accel(cfg, ds, meta, scene=scene, device="cpu")
    made = make_staged_renderer(ds, accel, meta=meta, config=cfg,
                                mesh=None, device="cpu")
    assert isinstance(made, StagedRenderer)
    got = made(scene.camera, cfg.seed, 0)
    want = StagedRenderer(ds, accel, meta=meta, config=cfg,
                          device="cpu")(scene.camera, cfg.seed, 0)
    assert got[0].shape == (cfg.height, cfg.width, 3)
    assert float(got[1][0]) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
