"""tpurt_torch.kernels.tilewave against tpurt.kernels.tilewave (Pallas in
interpret mode, SMEM-path semantics) and against the brute-force oracle.

Tolerances: entry words, octant keys, slots and the live-overflow count
are exact. XLA:CPU contracts a*b+c into FMA where torch rounds every op,
so floats differ in the last bits, amplified by Möller–Trumbore's
cancellations: hit distances agree within 1e-6 relative plus 1e-6 of the
scene diagonal absolute (t is a difference of products of coordinates of
the scene's magnitude), barycentrics within 1e-4 absolute (they are ratios
over det, which is small at grazing incidence; on the worst ray of these
waves the reference is 5e-5 off the float64 value and the port 1e-5).
Results are compared per ray after the restore: lax.sort and torch.sort
may order tied sort keys differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh.paircluster import build_pair_accel as ref_build
from tpurt.kernels import tilewave as ref_tw
from tpurt.render.intersectors import make_brute_force as ref_brute
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene.device import to_device as ref_to_device
from tpurt.scene.procedural import bunny_standin as ref_bunny
from tpurt_torch import kernels
from tpurt_torch.bvh.paircluster import build_pair_accel as port_build
from tpurt_torch.kernels import packet
from tpurt_torch.kernels import tilewave as tw
from tpurt_torch.render.intersectors import make_brute_force as port_brute
from tpurt_torch.render.intersectors import scene_meta as port_meta
from tpurt_torch.scene.device import to_device as port_to_device
from tpurt_torch.scene.procedural import bunny_standin as port_bunny

INT32_MAX = 2 ** 31 - 1


@pytest.fixture(scope="module")
def bunny():
    """bunny_standin(3): 1286 tris, 14 clusters (above the all-pairs
    limit of 8), built by both packages."""
    rs, ps = ref_bunny(subdivisions=3), port_bunny(subdivisions=3)
    r_ds = ref_to_device(rs)
    r_accel = ref_build(r_ds, ref_meta(rs), scene=rs)
    p_ds = port_to_device(ps, device="cpu")
    p_accel = port_build(p_ds, port_meta(ps), scene=ps).to("cpu")
    lo, hi = r_accel.cluster_lo, r_accel.cluster_hi
    diag = float(np.linalg.norm(hi.max(0) - lo.min(0)))
    return dict(r_ds=r_ds, r_accel=r_accel, r_meta=ref_meta(rs), p_ds=p_ds,
                p_accel=p_accel, p_meta=port_meta(ps), diag=diag,
                center=(lo.min(0) + hi.max(0)) / 2)


def _rays(rng, n, center, radius):
    org = center + rng.normal(size=(n, 3)) * radius * 1.5
    target = center + rng.normal(size=(n, 3)) * radius * 0.4
    d = target - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def _close(got, want, diag, name):
    atol = 1e-6 * diag if name in ("t", "bt") else 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol,
                               err_msg=name)


def _random_boxes(rng, n_tiles, n_c):
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


@pytest.mark.parametrize("n_c,n_tiles", [(37, 3), (200, 2)])
def test_entries_plain_matches_pallas(rng, n_c, n_tiles):
    """K2's plain version emits the reference kernel's entry words bit for
    bit (lane padding and dead rays included)."""
    org, d, tm, lo, hi = _random_boxes(rng, n_tiles, n_c)
    scale = tw.tn_scale_of(lo, hi)
    want = np.asarray(ref_tw._exact_entries_pallas(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(tm), jnp.asarray(lo),
        jnp.asarray(hi), n_tiles, jnp.float32(scale), interpret=True))
    t = torch.from_numpy
    got = tw.entries_plain(t(org), tw._safe_inv(t(d)), t(tm), t(lo), t(hi),
                           scale).numpy()
    assert got.shape == (n_tiles, want.shape[1])
    np.testing.assert_array_equal(got, want[:n_tiles])
    assert (got != INT32_MAX).any() and (got == INT32_MAX).any()


@pytest.fixture(scope="module")
def loop_inputs(bunny):
    """Three tiles of random rays with capped tmax (some dead) and the
    reference's sorted entry rows for them."""
    rng = np.random.default_rng(7)
    n_tiles = 3
    n = n_tiles * tw.TILE
    org, d = _rays(rng, n, bunny["center"], 3.0)
    tmax = np.where(np.arange(n) % 9 == 0, -1.0,
                    rng.uniform(2.0, 12.0, n)).astype(np.float32)
    acc = bunny["r_accel"]
    lo, hi = acc.cluster_lo, acc.cluster_hi
    scale = tw.tn_scale_of(lo, hi)
    entry = ref_tw._exact_entries_pallas(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmax), jnp.asarray(lo),
        jnp.asarray(hi), n_tiles, jnp.float32(scale), interpret=True)
    counts = (entry != INT32_MAX).sum(axis=1, dtype=jnp.int32)[:n_tiles]
    entry = jax.lax.sort(entry)
    return dict(org=org, d=d, tmax=tmax, scale=scale, entry=entry,
                counts=counts, n_tiles=n_tiles,
                entry_np=np.array(entry)[:n_tiles],
                counts_np=np.array(counts))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "lean_any"])
def test_tileloop_plain_matches_pallas(bunny, loop_inputs, monkeypatch,
                                       any_hit):
    """K1's plain version against the reference kernel on the same sorted
    entry rows: slots equal, t/u/v within the stated tolerance."""
    monkeypatch.setenv("TPURT_SMEM_TRI", "1")
    li = loop_inputs
    n_tiles = li["n_tiles"]
    rows = bunny["r_accel"].tri_rows
    want = ref_tw._launch_tiles_loop(
        None, None, jnp.asarray(li["org"]), jnp.asarray(li["d"]),
        jnp.asarray(li["tmax"]), jnp.asarray(rows), n_tiles=n_tiles,
        interpret=True, any_hit=any_hit, n_pairs=jnp.int32(0),
        overflow=jnp.zeros((), bool), tn_scale=jnp.float32(li["scale"]),
        entries=li["entry"], counts=li["counts"])
    want = [np.asarray(x) for x in want[:4]]
    t = torch.from_numpy
    d = t(li["d"])
    got = tw.tileloop_plain(
        t(li["org"]), d, tw._safe_inv(d), t(li["tmax"]),
        bunny["p_accel"].tri_rows,
        t(li["entry_np"]), t(li["counts_np"]), li["scale"], any_hit)
    got = [x.numpy() for x in got]
    np.testing.assert_array_equal(got[3], want[3])  # slot (bs)
    assert (want[3] >= 0).sum() > 100  # the rays do hit the bunny
    for k, name in ((0, "bt"), (1, "bu"), (2, "bv")):
        _close(got[k], want[k], bunny["diag"], name)


@pytest.fixture(scope="module")
def wave(bunny):
    rng = np.random.default_rng(11)
    n = 2500  # not a tile multiple: exercises the padding
    org, d = _rays(rng, n, bunny["center"], 3.0)
    tmax = np.where(np.arange(n) % 7 == 0, -1.0, np.inf).astype(np.float32)
    shadow_tmax = np.where(np.arange(n) % 5 == 0, -1.0,
                           rng.uniform(0.5, 6.0, n)).astype(np.float32)
    return org, d, tmax, shadow_tmax


@pytest.mark.parametrize("sort", ["none", "octant"])
def test_tile_intersector_matches_reference_and_oracle(bunny, wave,
                                                       monkeypatch, sort):
    """make_tile_intersector per ray after the restore: primary path
    (interval-frustum entries) and sorted path (K2 entries), closest and
    any-hit, against the reference intersector and the brute oracle."""
    monkeypatch.setenv("TPURT_SMEM_TRI", "1")
    org, d, tmax, shadow_tmax = wave
    r_closest, r_any = ref_tw.make_tile_intersector(
        bunny["r_ds"], bunny["r_accel"], interpret=True, ray_sort=sort)
    p_closest, p_any = tw.make_tile_intersector(
        bunny["p_ds"], bunny["p_accel"], ray_sort=sort)
    b_closest, b_any = port_brute(bunny["p_ds"], bunny["p_meta"])
    t = torch.from_numpy
    want = r_closest(jnp.asarray(org), jnp.asarray(d), 0.0,
                     jnp.asarray(tmax))
    got = p_closest(t(org), t(d), 0.0, t(tmax))
    oracle = b_closest(t(org), t(d), 0.0, t(tmax))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.valid.numpy(), oracle.valid.numpy())
    assert valid.sum() > 500
    np.testing.assert_array_equal(got.slot.numpy(), np.asarray(want.slot))
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_array_equal(got.inst.numpy(), np.asarray(want.inst))
    np.testing.assert_array_equal(got.tri.numpy()[valid],
                                  oracle.tri.numpy()[valid])
    for name in ("t", "u", "v"):
        _close(getattr(got, name).numpy()[valid],
               np.asarray(getattr(want, name))[valid], bunny["diag"], name)
    np.testing.assert_allclose(got.t.numpy()[valid],
                               oracle.t.numpy()[valid], rtol=1e-4,
                               atol=1e-4)
    if sort == "octant":  # any-hit waves are always octant-sorted
        occ_want = np.asarray(r_any(jnp.asarray(org), jnp.asarray(d), 0.0,
                                    jnp.asarray(shadow_tmax)))
        occ = p_any(t(org), t(d), 0.0, t(shadow_tmax)).numpy()
        np.testing.assert_array_equal(occ, occ_want)
        np.testing.assert_array_equal(
            occ, b_any(t(org), t(d), 0.0, t(shadow_tmax)).numpy())
        assert 0 < occ.sum() < occ.shape[0]


def test_octant_keys_and_tmax_cap_match(bunny, wave):
    """The coherence sort keys are exact; the scene-exit tmax cap
    (reference lines tilewave.py:2154-2165, reproduced in jnp here) agrees
    within 1e-6 relative."""
    org, d, tmax, _ = wave
    lo, hi = bunny["r_accel"].cluster_lo, bunny["r_accel"].cluster_hi
    lo_all, hi_all = jnp.asarray(lo.min(0)), jnp.asarray(hi.max(0))
    tmv = jnp.where(jnp.isfinite(tmax), tmax, ref_tw.BIG)
    inv_c = 1.0 / jnp.where(jnp.abs(d) < 1e-12,
                            jnp.where(d >= 0.0, 1e-12, -1e-12), d)
    texit = jnp.min(jnp.maximum((lo_all[None] - org) * inv_c,
                                (hi_all[None] - org) * inv_c), axis=1)
    cap = texit * (1.0 + 1e-4) + 1e-4 * jnp.linalg.norm(hi_all - lo_all)
    want_tmv = np.array(jnp.where(tmv >= 0.0, jnp.minimum(tmv, cap), tmv))
    want_keys = np.asarray(ref_tw._octant_sort_keys(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(want_tmv),
        lo_all, hi_all))

    t = torch.from_numpy
    lo_t, hi_t = t(lo.min(0)), t(hi.max(0))
    ext = hi_t - lo_t
    diag = torch.sqrt(ext[0] * ext[0] + ext[1] * ext[1] + ext[2] * ext[2])
    tmv_t = torch.where(torch.isfinite(t(tmax)), t(tmax), tw.BIG)
    got_tmv = tw._scene_exit_cap(t(org), t(d), tmv_t, lo_t, hi_t, diag)
    np.testing.assert_allclose(got_tmv.numpy(), want_tmv, rtol=1e-6)
    assert ((want_tmv >= 0) == (got_tmv.numpy() >= 0)).all()
    got_keys = tw._octant_sort_keys(t(org), t(d), t(want_tmv), lo_t, hi_t)
    np.testing.assert_array_equal(got_keys.numpy().astype(np.uint32),
                                  want_keys)
    assert (want_keys == 0xFFFFFFFF).any()  # dead rays sort last


def test_live_truncation_overflow_count(bunny, wave, monkeypatch):
    """A live cap below the wave's alive count truncates the sorted wave
    and counts the alive rays it cut, exactly as the reference does."""
    monkeypatch.setenv("TPURT_SMEM_TRI", "1")
    org, d, _, shadow_tmax = wave
    _, r_any = ref_tw.make_tile_intersector(
        bunny["r_ds"], bunny["r_accel"], interpret=True,
        shadow_live_cap=1024)
    _, p_any = tw.make_tile_intersector(
        bunny["p_ds"], bunny["p_accel"], shadow_live_cap=1024)
    occ_w, st_w = r_any.with_stats(jnp.asarray(org), jnp.asarray(d), 0.0,
                                   jnp.asarray(shadow_tmax))
    t = torch.from_numpy
    occ, st = p_any.with_stats(t(org), t(d), 0.0, t(shadow_tmax))
    st_w, st = np.asarray(st_w), st.numpy()
    assert st[2] == st_w[2] > 0  # alive rays past the first tile
    # only the first tile was traced: everything past it comes back
    # unoccluded (which rays fill that tile depends on how each sort
    # orders tied keys, so the sets are not compared ray by ray)
    assert 0 < int(occ.sum()) <= tw.TILE
    assert 0 < int(np.asarray(occ_w).sum()) <= tw.TILE


def test_ray_sort_keys_match(bunny, wave):
    """The origin-Morton ray keys ported with the packet module."""
    from tpurt.kernels.packet import _ray_sort_keys as ref_keys

    org, d, _, shadow_tmax = wave
    lo, hi = bunny["r_accel"].cluster_lo, bunny["r_accel"].cluster_hi
    want = np.asarray(ref_keys(jnp.asarray(org), jnp.asarray(d),
                               jnp.asarray(shadow_tmax),
                               jnp.asarray(lo.min(0)),
                               jnp.asarray(hi.max(0))))
    t = torch.from_numpy
    got = packet._ray_sort_keys(t(org), t(d), t(shadow_tmax), t(lo.min(0)),
                            t(hi.max(0)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_launchers_reject_cpu_tensors(bunny, loop_inputs):
    """The CUDA launchers never fall back: CPU tensors are refused (the
    dispatching wrappers route CPU tensors to the plain versions)."""
    li = loop_inputs
    t = torch.from_numpy
    org, d, tm = t(li["org"]), t(li["d"]), t(li["tmax"])
    acc = bunny["p_accel"]
    # from here on (a CPU render earlier in the process counts its
    # PyTorch shade's waves beside the launches, as shade.plain)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        tw.entries_cuda(org, tw._safe_inv(d), tm, acc.cluster_lo,
                        acc.cluster_hi, li["scale"])
    with pytest.raises(ValueError, match="CUDA"):
        tw.tileloop_cuda(org, d, tw._safe_inv(d), tm, acc.tri_rows,
                         t(li["entry_np"]), t(li["counts_np"]), li["scale"],
                         False)
    assert not any(kernels.launch_counts().values())

