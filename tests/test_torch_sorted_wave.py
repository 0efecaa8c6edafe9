"""The staged loop's sorted-wave variant (``sorted_wave`` /
``TPURT_SORTED_WAVE``) and the tile intersector's Morton ray sort,
mirroring tests/unit/test_sorted_wave.py, on the CPU.

The sorted loop permutes the wave once a bounce and carries each ray's
pixel and sample ids; live-wave truncation (dead rays sort to the back,
the wave is cut at a cap) must never change the image: a cap that would
cut alive rays trips live_overflow and render_scene re-renders uncapped.

Tolerances: the sorted loop against the port's default staged loop
bit-equal (same streams, same events, the same per-pixel sum order);
against the reference's sorted loop (its tile intersector in interpret
mode) RMSE ≤ 1e-3 with under 2% of pixels off by more than 1e-3, and the
ray counts within 1e-3 (tests/test_torch_render.py). The Morton-sorted
intersector against the reference's per ray after the restore: hit flags,
slots and occlusion equal, t within 1e-6 relative plus 1e-6 of the scene
diagonal, barycentrics within 1e-4 (tests/test_torch_tilewave.py).
"""

import dataclasses
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh.paircluster import build_pair_accel as ref_build
from tpurt.kernels import tilewave as ref_tw
from tpurt.render import framebuffer as ref_fb
from tpurt.render import render_scene as ref_render
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene.device import to_device as ref_to_device
from tpurt.scene.procedural import bunny_standin as ref_bunny
from tpurt.utils.config import get_config as ref_config
from tpurt_torch.bvh.paircluster import build_pair_accel
from tpurt_torch.kernels import tilewave as tw
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render import render_scene
from tpurt_torch.render.intersectors import scene_meta
from tpurt_torch.render.staged import StagedRenderer
from tpurt_torch.scene.device import to_device
from tpurt_torch.scene.procedural import bunny_standin
from tpurt_torch.utils.config import get_config

torch.set_num_threads(1)

SMALL = dict(width=48, height=32, spp=2, spp_per_batch=2, max_bounces=2,
             pipeline="staged", intersector="bvh_tile")


def _render(cfg, monkeypatch, sorted_wave, scene=None, **env):
    monkeypatch.setenv("TPURT_SORTED_WAVE", "1" if sorted_wave else "0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    state, stats = render_scene(cfg, device="cpu", scene=scene)
    return fb.resolve(state).numpy(), stats


@pytest.mark.parametrize("preset,over", [
    ("cornell_pt", {}),
    ("cornell_pt", {"use_nee": False}),
    ("sponza", {}),  # the two-level accel, supercluster entries
])
def test_sorted_matches_default(preset, over, monkeypatch):
    cfg = get_config(preset, **dict(SMALL, **over))
    a, sa = _render(cfg, monkeypatch, sorted_wave=False)
    b, sb = _render(cfg, monkeypatch, sorted_wave=True)
    # the permutation is invisible: same streams, events and sum order
    np.testing.assert_array_equal(a, b)
    assert not sb["live_overflow"]
    assert len(sb["live_counts"]) == cfg.max_bounces + 1
    assert sb["live_counts"] == sa["live_counts"]
    assert sb["rays_closest"] == sa["rays_closest"]
    assert sb["rays_shadow"] == sa["rays_shadow"]


def test_config_switch_matches_environment(monkeypatch):
    """``sorted_wave=True`` in the config takes the sorted loop, and
    TPURT_SORTED_WAVE=0 overrides it."""
    monkeypatch.delenv("TPURT_SORTED_WAVE", raising=False)
    cfg = get_config("bunny", sorted_wave=True, **SMALL)
    scene = bunny_standin(subdivisions=3)
    meta = scene_meta(scene)
    ds = to_device(scene, device="cpu")
    accel = build_pair_accel(ds, meta, scene=scene).to("cpu")
    assert StagedRenderer(ds, accel, meta=meta, config=cfg,
                          device="cpu").sorted
    monkeypatch.setenv("TPURT_SORTED_WAVE", "0")
    assert not StagedRenderer(ds, accel, meta=meta, config=cfg,
                              device="cpu").sorted
    # flat shading and accels without cluster boxes keep the default loop
    monkeypatch.delenv("TPURT_SORTED_WAVE")
    flat = dataclasses.replace(cfg, shading_mode="flat")
    assert not StagedRenderer(ds, accel, meta=meta, config=flat,
                              device="cpu").sorted
    assert not StagedRenderer(ds, None, meta=meta, config=cfg,
                              device="cpu").sorted


def test_sorted_matches_reference(monkeypatch):
    cfg = dict(SMALL, spp=1, spp_per_batch=1, max_bounces=1)
    monkeypatch.setenv("TPURT_SORTED_WAVE", "1")
    ref_state, ref_stats = ref_render(ref_config("bunny", **cfg),
                                      scene=ref_bunny(subdivisions=3))
    want = np.asarray(ref_fb.resolve(ref_state))
    img, stats = _render(get_config("bunny", **cfg), monkeypatch,
                         sorted_wave=True, scene=bunny_standin(subdivisions=3))
    assert img.shape == want.shape == (32, 48, 3)
    assert float(np.sqrt(np.mean((img - want) ** 2))) <= 1e-3
    assert float((np.abs(img - want) > 1e-3).mean()) < 0.02
    for key in ("rays_closest", "rays_shadow"):
        np.testing.assert_allclose(stats[key], ref_stats[key], rtol=1e-3)
    np.testing.assert_allclose(stats["live_counts"], ref_stats["live_counts"],
                               rtol=1e-3, atol=1.0)
    assert not stats["live_overflow"] and not ref_stats["live_overflow"]


def test_truncation_roundtrip(tmp_path, monkeypatch):
    """An uncapped render records its live counts; the capped re-render
    from them is bit-identical (the caps only drop dead rays)."""
    at = tmp_path / "autotune.json"
    cfg = get_config("cornell_pt", **SMALL)
    monkeypatch.setenv("TPURT_AUTOTUNE_PATH", str(at))
    a, sa = _render(cfg, monkeypatch, sorted_wave=True,
                    TPURT_AUTOTUNE_WRITE="1")
    table = json.loads(at.read_text())
    assert len(table) == 1
    monkeypatch.setenv("TPURT_AUTOTUNE_WRITE", "0")
    b, sb = _render(cfg, monkeypatch, sorted_wave=True)
    np.testing.assert_array_equal(a, b)
    assert not sb["live_overflow"]


def test_adequate_caps_cut_the_wave_bit_identical(monkeypatch):
    """Caps just above the live counts cut the bunny's thinning waves
    (to whole tiles below the wave's size), and the image is the
    uncapped one."""
    scene = bunny_standin(subdivisions=3)
    cfg = get_config("bunny", **SMALL)
    a, sa = _render(cfg, monkeypatch, sorted_wave=True, scene=scene)
    caps = tuple(int(v) + 1 for v in sa["live_counts"][:2])
    capped = dataclasses.replace(cfg, live_caps=caps)
    monkeypatch.setenv("TPURT_SORTED_WAVE", "1")
    meta = scene_meta(scene)
    ds = to_device(scene, device="cpu")
    r = StagedRenderer(ds, build_pair_accel(ds, meta, scene=scene).to("cpu"),
                       meta=meta, config=capped, device="cpu")
    assert r.sorted and any(0 < c < r.n for c in r.sorted_caps)
    b, sb = _render(capped, monkeypatch, sorted_wave=True, scene=scene)
    np.testing.assert_array_equal(a, b)
    assert not sb["live_overflow"]


def test_truncation_overflow_is_loud_and_corrected(monkeypatch):
    """Caps that cut alive rays warn, re-render uncapped and end with
    the uncapped image."""
    cfg = get_config("cornell_pt", **SMALL)
    a, _ = _render(cfg, monkeypatch, sorted_wave=True)
    tight = dataclasses.replace(cfg, live_caps=(1024, 1024))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        b, stats = _render(tight, monkeypatch, sorted_wave=True)
    assert any("live-wave cap" in str(w.message) for w in rec)
    np.testing.assert_array_equal(a, b)
    assert not stats["live_overflow"]


def _close(got, want, diag, name):
    tol = 1e-6 * np.abs(want) + 1e-6 * diag if name == "t" else 1e-4
    assert np.all(np.abs(got - want) <= tol), name


def test_morton_sort_matches_reference_on_a_bounce_wave(monkeypatch):
    """The tile intersector with ray_sort and shadow_ray_sort "morton"
    on the first bounce wave and shadow wave of a bunny batch, against
    the reference's (interpret mode) per ray after the restore."""
    cfg = get_config("bunny", width=32, height=32, spp=1, spp_per_batch=1,
                     max_bounces=1)
    scene = bunny_standin(subdivisions=3)
    meta = scene_meta(scene)
    ds = to_device(scene, device="cpu")
    accel = build_pair_accel(ds, meta, scene=scene).to("cpu")
    r = StagedRenderer(ds, accel, meta=meta, config=cfg, device="cpu")
    state = r.raygen(scene.camera, cfg.seed, 0)
    hit, state = r.trace(state, 0)
    state, shadow = r.shade(state, hit, r.sampler(cfg.seed, 0), 0)
    org, d = state.org.numpy(), state.dirn.numpy()
    tmax = np.where(state.alive.numpy(), np.inf, -1.0).astype(np.float32)
    s_org, s_dir, s_tmax = (x.numpy() for x in shadow[:3])
    assert 0 < (tmax > 0).sum() < tmax.size

    rs = ref_bunny(subdivisions=3)
    r_ds = ref_to_device(rs)
    r_accel = ref_build(r_ds, ref_meta(rs), scene=rs)
    r_closest, r_any = ref_tw.make_tile_intersector(
        r_ds, r_accel, interpret=True, ray_sort="morton",
        shadow_ray_sort="morton")
    p_closest, p_any = tw.make_tile_intersector(
        ds, accel, ray_sort="morton", shadow_ray_sort="morton")
    t = torch.from_numpy
    want = r_closest(jnp.asarray(org), jnp.asarray(d), 0.0,
                     jnp.asarray(tmax))
    got = p_closest(t(org), t(d), 0.0, t(tmax))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 100
    np.testing.assert_array_equal(got.slot.numpy(), np.asarray(want.slot))
    lo, hi = r_accel.cluster_lo, r_accel.cluster_hi
    diag = float(np.linalg.norm(hi.max(0) - lo.min(0)))
    for name in ("t", "u", "v"):
        _close(getattr(got, name).numpy()[valid],
               np.asarray(getattr(want, name))[valid], diag, name)
    occ_want = np.asarray(r_any(jnp.asarray(s_org), jnp.asarray(s_dir), 0.0,
                                jnp.asarray(s_tmax)))
    occ = p_any(t(s_org), t(s_dir), 0.0, t(s_tmax)).numpy()
    np.testing.assert_array_equal(occ, occ_want)
    assert (s_tmax > 0).sum() > 100
