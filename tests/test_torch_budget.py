"""The budget path of tpurt_torch against tpurt: the exact mask (K3's
plain version against the Pallas kernel in interpret mode), the tile
intersector under a per-tile clamp (flat and two-level), and
render_scene's budget-doubling retries with their terminal error.

Tolerances: masks, entry words, slots, instances, stats (pair counts,
overflow flags) and retry counts exact; the exact mask's tn bit-equal
((lo − o)·iv and min/max leave XLA nothing to contract); hit distances
within 1e-6 relative plus 1e-6 of the scene diagonal and barycentrics
within 1e-4 (2.5e-4 two-level) absolute, because XLA:CPU contracts
Möller–Trumbore's multiply-adds (tests/test_torch_tilewave.py,
tests/test_torch_twolevel.py); images against the reference's render at
RMSE ≤ 1e-3 with under 2% of pixels off by more than 1e-3
(tests/test_torch_render.py), and bit-equal between two port renders
whose traversal is the same.
"""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh import paircluster as ref_pc
from tpurt.kernels import tilewave as ref_tw
from tpurt.render import BudgetOverflowError as RefBudgetOverflowError
from tpurt.render import framebuffer as ref_fb
from tpurt.render import render_scene as ref_render
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import procedural as ref_proc
from tpurt.scene.device import to_device as ref_to_device
from tpurt.utils.config import get_config as ref_config
from tpurt_torch.bvh import paircluster as port_pc
from tpurt_torch.kernels import tilewave as tw
from tpurt_torch.render import BudgetOverflowError
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render import render_scene
from tpurt_torch.render.intersectors import make_brute_force as port_brute
from tpurt_torch.render.intersectors import scene_meta as port_meta
from tpurt_torch.scene import procedural as port_proc
from tpurt_torch.scene.device import to_device as port_to_device
from tpurt_torch.utils.config import get_config

# One intra-op thread: the suite runs in several worker processes on a few
# cores (tests/test_torch_render.py).
torch.set_num_threads(1)

RMSE_TOL = 1e-3
SMALL = dict(width=32, height=24, spp=1, spp_per_batch=1, max_bounces=1,
             intersector="bvh_tile")


@functools.lru_cache(maxsize=None)
def _setup(name):
    """bunny_standin(3) (14 clusters, flat) or sponza_standin(8, 3) (126
    instance-clusters, two-level), built by both packages."""
    if name == "bunny":
        rs, ps = ref_proc.bunny_standin(3), port_proc.bunny_standin(3)
        r_build, p_build = ref_pc.build_pair_accel, port_pc.build_pair_accel
    else:
        rs = ref_proc.sponza_standin(column_segments=8, column_rings=3)
        ps = port_proc.sponza_standin(column_segments=8, column_rings=3)
        r_build = ref_pc.build_pair_accel_two_level
        p_build = port_pc.build_pair_accel_two_level
    r_ds, p_ds = ref_to_device(rs), port_to_device(ps, device="cpu")
    r_acc = r_build(r_ds, ref_meta(rs), scene=rs)
    p_acc = p_build(p_ds, port_meta(ps), scene=ps).to("cpu")
    lo, hi = r_acc.cluster_lo, r_acc.cluster_hi
    return dict(r_ds=r_ds, r_acc=r_acc, p_ds=p_ds, p_acc=p_acc,
                p_meta=port_meta(ps), lo=lo, hi=hi,
                diag=float(np.linalg.norm(hi.max(0) - lo.min(0))),
                center=(lo.min(0) + hi.max(0)) / 2)


def _rays(rng, n, center, radius):
    org = center + rng.normal(size=(n, 3)) * radius * 1.5
    target = center + rng.normal(size=(n, 3)) * radius * 0.4
    d = target - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def _sorted_wave(n_tiles):
    """Tiles of short rays around the bunny stand-in, prepared as the
    intersector prepares a shadow wave: scene-exit tmax cap, then the
    octant sort (some rays dead)."""
    s = _setup("bunny")
    n = n_tiles * tw.TILE
    rng = np.random.default_rng(21)
    org, d = _rays(rng, n, s["center"], 3.0)
    tmax = np.where(np.arange(n) % 11 == 0, -1.0,
                    rng.uniform(0.2, 2.0, n)).astype(np.float32)
    t = torch.from_numpy
    lo_all, hi_all = t(s["lo"].min(0)), t(s["hi"].max(0))
    ext = hi_all - lo_all
    diag = torch.sqrt(ext[0] * ext[0] + ext[1] * ext[1] + ext[2] * ext[2])
    tmv = torch.where(torch.isfinite(t(tmax)), t(tmax), tw.BIG)
    tmv = tw._scene_exit_cap(t(org), t(d), tmv, lo_all, hi_all, diag)
    keys = tw._octant_sort_keys(t(org), t(d), tmv, lo_all, hi_all)
    perm = torch.sort(keys, stable=True).indices
    return (t(org)[perm].numpy(), t(d)[perm].numpy(), tmv[perm].numpy(),
            s["lo"], s["hi"])


def _random_boxes(n_c, n_tiles):
    rng = np.random.default_rng(n_c)
    n = n_tiles * tw.TILE
    org = (rng.normal(size=(n, 3)) * 5.0).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.where(np.arange(n) % 7 == 0, -1.0,
                  np.where(np.arange(n) % 3 == 0, 4.0, 30.0)
                  ).astype(np.float32)
    lo = rng.uniform(-8, 6, size=(n_c, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.1, 2.0, size=(n_c, 3))).astype(np.float32)
    return org, d, tm, lo, hi


WAVES = {
    "bunny_sorted": lambda: _sorted_wave(3),
    "random_37": lambda: _random_boxes(37, 3),
    "random_200": lambda: _random_boxes(200, 2),
}


@pytest.mark.parametrize("wave", sorted(WAVES))
def test_exact_mask_plain_matches_pallas(wave):
    """K3's plain version against the reference kernel: the mask equal,
    tn_min bit-equal where the mask is set and BIG on both sides where it
    is not (octant-sorted bunny wave; random boxes that pad to 128 and
    256 lanes)."""
    org, d, tm, lo, hi = WAVES[wave]()
    n_tiles = org.shape[0] // tw.TILE
    w_mask, w_tn = ref_tw._exact_any_mask_pallas(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(tm), jnp.asarray(lo),
        jnp.asarray(hi), n_tiles, interpret=True)
    w_mask, w_tn = np.asarray(w_mask), np.asarray(w_tn)
    t = torch.from_numpy
    mask, tn = tw.exact_mask_plain(t(org), tw._safe_inv(t(d)), t(tm), t(lo),
                                   t(hi))
    mask, tn = mask.numpy(), tn.numpy()
    assert mask.shape == tn.shape == (n_tiles, lo.shape[0])
    np.testing.assert_array_equal(mask, w_mask)
    assert tn[mask].tobytes() == w_tn[w_mask].tobytes()
    assert (tn[~mask] == np.float32(tw.BIG)).all()
    assert (w_tn[~w_mask] == np.float32(tw.BIG)).all()
    assert mask.any() and not mask.all()


@pytest.mark.parametrize("wave", sorted(WAVES))
def test_entries_plain_packs_the_exact_mask(wave):
    """K2's plain version is K3's packed: bit-equal."""
    org, d, tm, lo, hi = WAVES[wave]()
    t = torch.from_numpy
    args = (t(org), tw._safe_inv(t(d)), t(tm), t(lo), t(hi))
    scale = tw.tn_scale_of(lo, hi)
    want = tw._pack_entries(*tw.exact_mask_plain(*args), scale)
    got = tw.entries_plain(*args, scale)
    assert torch.equal(got, want)
    assert got.shape[1] % tw.LANES == 0


def test_clamp_rows_keeps_the_first_clusters():
    """The clamp keeps each tile's first min(k − 1, C) hit clusters in
    cluster order, counts what it kept and flags a tile that had more."""
    mask = torch.tensor([[1, 0, 1, 1, 0, 1], [0, 1, 0, 0, 0, 0]], dtype=bool)
    kept, counts, over = tw._clamp_rows(mask, 3)
    assert kept.tolist() == [[1, 0, 1, 0, 0, 0], [0, 1, 0, 0, 0, 0]]
    assert counts.tolist() == [2, 1] and bool(over)
    kept, counts, over = tw._clamp_rows(mask, 8)  # keep = C: no clamp
    assert torch.equal(kept, mask) and counts.tolist() == [4, 1]
    assert not bool(over)
    kept, counts, over = tw._clamp_rows(mask, 1)  # keep 0: every hit goes
    assert not kept.any() and counts.tolist() == [0, 0] and bool(over)


@pytest.fixture(scope="module")
def wave():
    s = _setup("bunny")
    rng = np.random.default_rng(11)
    n = 2500  # not a tile multiple: exercises the padding
    org, d = _rays(rng, n, s["center"], 3.0)
    tmax = np.where(np.arange(n) % 7 == 0, -1.0, np.inf).astype(np.float32)
    shadow_tmax = np.where(np.arange(n) % 5 == 0, -1.0,
                           rng.uniform(0.5, 6.0, n)).astype(np.float32)
    return org, d, tmax, shadow_tmax


def _close(got, want, diag, name, uv_atol=1e-4):
    atol = 1e-6 * diag if name == "t" else uv_atol
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol,
                               err_msg=name)


def _same_hits(got, want, diag, uv_atol=1e-4):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for f in ("slot", "inst"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    for name in ("t", "u", "v"):
        _close(getattr(got, name).numpy()[valid],
               np.asarray(getattr(want, name))[valid], diag, name, uv_atol)
    return valid


@pytest.mark.parametrize("k", [1, 6, 0], ids=["k1", "k6", "k0"])
@pytest.mark.parametrize("sort", ["none", "octant"])
def test_clamped_intersector_matches_reference(wave, monkeypatch, k, sort):
    """make_tile_intersector(pairs_per_tile=k) per ray against the
    reference's, closest (primary interval mask or sorted K3 mask) and,
    sorted, any-hit: stats (pairs, overflow, live overflow) equal, hits
    per ray. k = 1 keeps no cluster (every hit a miss, overflow set),
    k = 6 overflows some tiles of the 14-cluster stand-in, k = 0 is the
    unclamped path (against the oracle too)."""
    monkeypatch.setenv("TPURT_SMEM_TRI", "1")
    s = _setup("bunny")
    org, d, tmax, shadow_tmax = wave
    r_closest, r_any = ref_tw.make_tile_intersector(
        s["r_ds"], s["r_acc"], interpret=True, pairs_per_tile=k,
        ray_sort=sort)
    p_closest, p_any = tw.make_tile_intersector(
        s["p_ds"], s["p_acc"], pairs_per_tile=k, ray_sort=sort)
    t = torch.from_numpy
    want, w_stats = r_closest.with_stats(jnp.asarray(org), jnp.asarray(d),
                                         0.0, jnp.asarray(tmax))
    got, g_stats = p_closest.with_stats(t(org), t(d), 0.0, t(tmax))
    np.testing.assert_array_equal(g_stats.numpy(), np.asarray(w_stats))
    valid = _same_hits(got, want, s["diag"])
    if k == 1:
        assert g_stats[1] == 1.0 and g_stats[0] == 0.0 and not valid.any()
    elif k == 6:
        assert g_stats[1] == 1.0 and valid.sum() > 300
    else:
        assert g_stats[1] == 0.0
        oracle = port_brute(s["p_ds"], s["p_meta"])[0](t(org), t(d), 0.0,
                                                        t(tmax))
        np.testing.assert_array_equal(valid, oracle.valid.numpy())
    if sort == "octant":  # any-hit waves are always octant-sorted
        occ_w, wa_stats = r_any.with_stats(jnp.asarray(org), jnp.asarray(d),
                                           0.0, jnp.asarray(shadow_tmax))
        occ, ga_stats = p_any.with_stats(t(org), t(d), 0.0, t(shadow_tmax))
        np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_w))
        np.testing.assert_array_equal(ga_stats.numpy(), np.asarray(wa_stats))
        assert (int(occ.sum()) == 0) == (k == 1)


def test_clamped_two_level_matches_reference(monkeypatch):
    """A clamp on the two-level accel of sponza_standin(8, 3): per-cluster
    entries through K3, clamped, against the reference intersector; one
    coherent tile of rays along the nave so the reference's interpret
    body stays cheap."""
    monkeypatch.setenv("TPURT_SMEM_TRI", "1")
    s = _setup("sponza_small")
    n = tw.TILE
    rng = np.random.default_rng(5)
    org = (np.asarray((-12.0, 3.0, -1.0)) + rng.normal(size=(n, 3)) * 0.05)
    d = np.asarray((8.0, -1.5, 3.5)) / np.linalg.norm((8.0, -1.5, 3.5))
    d = d + rng.normal(size=(n, 3)) * 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org, d = org.astype(np.float32), d.astype(np.float32)
    tmax = np.where(np.arange(n) % 7 == 0, -1.0, np.inf).astype(np.float32)
    r_closest, _ = ref_tw.make_tile_intersector(
        s["r_ds"], s["r_acc"], interpret=True, pairs_per_tile=8,
        ray_sort="octant", lean=True)
    p_closest, _ = tw.make_tile_intersector(
        s["p_ds"], s["p_acc"], pairs_per_tile=8, ray_sort="octant",
        lean=True)
    t = torch.from_numpy
    want, w_stats = r_closest.with_stats(jnp.asarray(org), jnp.asarray(d),
                                         0.0, jnp.asarray(tmax))
    got, g_stats = p_closest.with_stats(t(org), t(d), 0.0, t(tmax))
    np.testing.assert_array_equal(g_stats.numpy(), np.asarray(w_stats))
    assert g_stats[1] == 1.0 and g_stats[0] == 7.0  # one tile, keep 7
    valid = _same_hits(got, want, s["diag"], uv_atol=2.5e-4)
    assert valid.sum() > 100
    assert len(np.unique(got.inst.numpy()[valid])) > 1


def test_clamp_switches_superclusters_off(monkeypatch):
    """With a clamp the full sponza stand-in (2430 instance-clusters,
    superclusters without one) takes per-cluster entries, as the
    reference's gate does; the all-pairs row of the Cornell box ignores
    the clamp. The traversal is recorded, not run."""
    calls = []

    def record(org, dirn, inv_d, tmax, tri_rows, entries, counts, scale,
               any_hit, pair_meta=None, inv_xform=None, sc_meta=None):
        calls.append(dict(sc=sc_meta is not None, cp=entries.shape[1],
                          counts=counts.clone(), scale=scale))
        z = torch.zeros(org.shape[0])
        return (z - 1.0, z, z, z - 1.0, z - 1.0)

    monkeypatch.setattr(tw, "tileloop", record)
    ps = port_proc.sponza_standin()
    acc = port_pc.build_pair_accel_two_level(None, port_meta(ps),
                                             scene=ps).to("cpu")
    n_c = acc.cluster_lo.shape[0]
    org = torch.tensor([[-12.0, 3.0, -1.0]]).repeat(tw.TILE, 1)
    d = torch.nn.functional.normalize(
        torch.tensor([[8.0, -1.5, 3.5]]) + 0.1 * torch.from_numpy(
            np.random.default_rng(2).normal(size=(tw.TILE, 3))
            .astype(np.float32)), dim=1)
    for ppt in (0, 4):
        closest, _ = tw.make_tile_intersector(None, acc, pairs_per_tile=ppt)
        _, stats = closest.with_stats(org, d, 0.0, torch.full((tw.TILE,),
                                                              1e30))
        assert calls[-1]["sc"] == (ppt == 0), ppt
        assert stats[1] == float(ppt > 0)
    assert calls[-1]["cp"] == tw._padded_lanes(n_c)
    assert int(calls[-1]["counts"].max()) == 3

    cb = port_proc.cornell_box()
    cacc = port_pc.build_pair_accel(None, port_meta(cb), scene=cb).to("cpu")
    closest, _ = tw.make_tile_intersector(None, cacc, pairs_per_tile=1)
    _, stats = closest.with_stats(org, d, 0.0, torch.full((tw.TILE,), 1e30))
    assert calls[-1]["scale"] == 0.0 and stats[1] == 0.0
    assert int(calls[-1]["counts"][0]) == cacc.cluster_lo.shape[0]


@pytest.fixture(scope="module")
def unclamped():
    scene = port_proc.bunny_standin(subdivisions=3)
    state, stats = render_scene(get_config("bunny", **SMALL), device="cpu",
                                scene=scene)
    return state, stats


def test_budget_retries_match_reference(unclamped):
    """pairs_per_tile=4 on the 14-cluster stand-in overflows and doubles
    (4 → 8 → 16) until the clamp keeps every cluster: the retry count
    equals the reference's, the final image equals the port's unclamped
    render bit for bit and the reference's within the image bars."""
    cfg = dict(SMALL, pairs_per_tile=4)
    state, stats = render_scene(get_config("bunny", **cfg), device="cpu",
                                scene=port_proc.bunny_standin(3))
    ref_state, ref_stats = ref_render(
        ref_config("bunny", pipeline="staged", **cfg),
        scene=ref_proc.bunny_standin(3))
    assert stats["budget_retries"] == ref_stats["budget_retries"] == 2
    assert not stats["pair_overflow"] and not ref_stats["pair_overflow"]
    assert torch.equal(state.accum, unclamped[0].accum)
    img = fb.resolve(state).numpy()
    want = np.asarray(ref_fb.resolve(ref_state))
    assert float(np.sqrt(np.mean((img - want) ** 2))) <= RMSE_TOL
    assert float((np.abs(img - want) > 1e-3).mean()) < 0.02
    for key in ("rays_closest", "rays_shadow"):
        np.testing.assert_allclose(stats[key], ref_stats[key], rtol=1e-3)


def test_terminal_overflow_raises_as_reference():
    """With no retries left the overflow raises BudgetOverflowError with
    the reference's message (mirrors tests/unit/test_overflow.py)."""
    cfg = dict(SMALL, pairs_per_tile=2)
    with pytest.raises(BudgetOverflowError, match="truncated") as got:
        render_scene(get_config("bunny", **cfg), device="cpu",
                     scene=port_proc.bunny_standin(3), max_budget_retries=0)
    with pytest.raises(RefBudgetOverflowError) as want:
        ref_render(ref_config("bunny", pipeline="staged", **cfg),
                   scene=ref_proc.bunny_standin(3), max_budget_retries=0)
    assert str(got.value) == str(want.value)


def test_terminal_overflow_env_optout(monkeypatch, unclamped):
    """TPURT_ALLOW_OVERFLOW=1 turns the error into a RuntimeWarning and
    returns the truncated image, its overflow recorded; one retry of two
    doublings short still overflows."""
    monkeypatch.setenv("TPURT_ALLOW_OVERFLOW", "1")
    cfg = get_config("bunny", **dict(SMALL, pairs_per_tile=2))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, stats = render_scene(cfg, device="cpu",
                                    scene=port_proc.bunny_standin(3),
                                    max_budget_retries=1)
    assert stats["pair_overflow"] and stats["budget_retries"] == 1
    assert any(issubclass(w.category, RuntimeWarning)
               and "truncated" in str(w.message) for w in caught)
    assert not torch.equal(state.accum, unclamped[0].accum)
