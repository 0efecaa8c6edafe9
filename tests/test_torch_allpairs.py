"""The all-pairs mode of tpurt_torch (scenes of at most 8 clusters: the
hello_triangle, cornell and cornell_pt presets) against tpurt: K1 fed the
row [0, 1, …, C−1] with scale 0 against the reference's segment mode, the
intersector against the reference's (Pallas in interpret mode, SMEM-path
semantics) and the brute-force oracle, the first bounce of a cornell_pt
batch per ray, and the three golden fixtures.

Tolerances: slots, validity, occlusion and stats exact; t within 1e-6
relative plus 1e-6 of the scene diagonal and barycentrics within 1e-4
absolute (tests/test_torch_tilewave.py); the hello and cornell goldens at
RMSE ≤ 1e-3 (tests/golden/test_golden.py). cornell_pt is held to its
energy bias ≤ 1e-3: a 4-bounce render through a glass and a glossy box is
chaos-dominated once the two sides' arithmetic differs at all (torch and
XLA:CPU round cos/sin/pow differently in the last bit), and its RMSE sits
at the decorrelated-noise floor (measured 1.16e-2, ROADMAP §3) while the
traversal and the first bounce agree per ray (held here).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden.configs import GOLDENS
from tpurt.bvh.paircluster import build_pair_accel as ref_build
from tpurt.kernels import tilewave as ref_tw
from tpurt.render import render_scene as ref_render
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import procedural as ref_proc
from tpurt.scene.device import to_device as ref_to_device
from tpurt.utils.config import get_config as ref_config
from tpurt_torch.bvh.paircluster import build_pair_accel as port_build
from tpurt_torch.kernels import tilewave as tw
from tpurt_torch.render import build_accel
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render import render_scene
from tpurt_torch.render.intersectors import make_brute_force as port_brute
from tpurt_torch.render.intersectors import scene_meta as port_meta
from tpurt_torch.render.staged import StagedRenderer
from tpurt_torch.scene import procedural as port_proc
from tpurt_torch.scene.device import to_device as port_to_device
from tpurt_torch.utils.config import get_config

# One intra-op thread: the suite runs in several worker processes on a few
# cores, where torch's default pool (one thread per core, spinning at each
# barrier) slows these small-tensor tests by two orders of magnitude.
torch.set_num_threads(1)

SCENES = {
    "hello_triangle": lambda m: m.hello_triangle(),
    "cornell": lambda m: m.cornell_box(path_tracer=False),
    "cornell_pt": lambda m: m.cornell_box(path_tracer=True),
}


def _setup(name):
    rs, ps = SCENES[name](ref_proc), SCENES[name](port_proc)
    r_ds, p_ds = ref_to_device(rs), port_to_device(ps, device="cpu")
    r_acc = ref_build(r_ds, ref_meta(rs), scene=rs)
    p_acc = port_build(p_ds, port_meta(ps), scene=ps).to("cpu")
    assert p_acc.n_clusters <= tw.ALLPAIRS_MAX_CLUSTERS
    lo, hi = r_acc.cluster_lo, r_acc.cluster_hi
    return dict(r_ds=r_ds, r_acc=r_acc, p_ds=p_ds, p_acc=p_acc,
                p_meta=port_meta(ps),
                diag=float(np.linalg.norm(hi.max(0) - lo.min(0))),
                lo=lo.min(0), hi=hi.max(0))


def _rays(seed, n, lo, hi):
    """Origins anywhere in the scene box grown by a quarter (inside and
    outside; a flat box is thickened), directions toward random points of
    the box."""
    rng = np.random.default_rng(seed)
    ext = np.maximum(hi - lo, 0.5 * (hi - lo).max())
    org = lo - 0.25 * ext + rng.uniform(size=(n, 3)) * 1.5 * ext
    d = lo + rng.uniform(size=(n, 3)) * ext - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def _same_hits(got_s, want_s, got_t, want_t, diag):
    """Slots equal, except where two coplanar faces (the boxes stand on
    the floor) give a ray the same t up to the last bits, and the two
    sides' rounding picks the other face: there t must agree, on at most
    1% of the hits."""
    other = (got_s != want_s) & (want_s >= 0)
    np.testing.assert_allclose(got_t[other], want_t[other], rtol=1e-6,
                               atol=1e-6 * diag)
    assert ((got_s >= 0) == (want_s >= 0)).all()
    assert other.sum() <= 1e-2 * (want_s >= 0).sum()


def _close(got, want, diag, name):
    atol = 1e-6 * diag if name in ("t", "bt") else 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "lean_any"])
def test_tileloop_plain_all_pairs_row_matches_segment_mode(monkeypatch,
                                                           any_hit):
    """The synthesized entry row [0, …, C−1] with scale 0 through K1's
    plain version computes what the reference's segment mode (offsets +
    pair list, no distance bits) computes."""
    monkeypatch.setenv("TPURT_SMEM_TRI", "1")
    s = _setup("cornell_pt")
    n_tiles, n_c = 2, s["p_acc"].n_clusters
    n = n_tiles * tw.TILE
    org, d = _rays(3, n, s["lo"], s["hi"])
    tmax = np.where(np.arange(n) % 9 == 0, -1.0,
                    np.random.default_rng(4).uniform(50.0, 900.0, n)
                    ).astype(np.float32)
    off = jnp.asarray(np.arange(n_tiles + 1, dtype=np.int32) * n_c)
    pair_cl = jnp.asarray(np.tile(np.arange(n_c, dtype=np.int32), n_tiles))
    want = ref_tw._launch_tiles_loop(
        off, pair_cl, jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmax),
        jnp.asarray(s["r_acc"].tri_rows), n_tiles=n_tiles, interpret=True,
        any_hit=any_hit, n_pairs=jnp.int32(n_tiles * n_c),
        overflow=jnp.zeros((), bool), tn_scale=None)
    want = [np.asarray(x) for x in want[:4]]
    t = torch.from_numpy
    dt = t(d)
    entry = torch.arange(n_c, dtype=torch.int32)[None].repeat(n_tiles, 1)
    got = tw.tileloop_plain(t(org), dt, tw._safe_inv(dt), t(tmax),
                            s["p_acc"].tri_rows, entry,
                            torch.full((n_tiles,), n_c, dtype=torch.int32),
                            0.0, any_hit)
    got = [x.numpy() for x in got]
    if any_hit:
        np.testing.assert_array_equal(got[3], want[3])
    else:
        _same_hits(got[3], want[3], got[0], want[0], s["diag"])
        same = got[3] == want[3]
        for k, name in ((0, "bt"), (1, "bu"), (2, "bv")):
            _close(got[k][same], want[k][same], s["diag"], name)
    assert (want[3] >= 0).sum() > 500


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_all_pairs_intersector_matches_reference_and_oracle(monkeypatch,
                                                            scene):
    """Closest (full Hit) and any-hit per ray, and the stats: every tile
    pairs with every cluster, no pair or live overflow — the octant sort
    and a live cap are ignored in this mode, as in the reference."""
    monkeypatch.setenv("TPURT_SMEM_TRI", "1")
    s = _setup(scene)
    n = 2 * tw.TILE + 300
    org, d = _rays(5, n, s["lo"], s["hi"])
    tmax = np.where(np.arange(n) % 7 == 0, -1.0, np.inf).astype(np.float32)
    shadow_tmax = np.where(np.arange(n) % 5 == 0, -1.0,
                           np.random.default_rng(6).uniform(
                               0.05, 1.0, n) * s["diag"]).astype(np.float32)
    kw = dict(ray_sort="octant", live_cap=tw.TILE, shadow_live_cap=tw.TILE)
    r_closest, r_any = ref_tw.make_tile_intersector(
        s["r_ds"], s["r_acc"], interpret=True, **kw)
    p_closest, p_any = tw.make_tile_intersector(s["p_ds"], s["p_acc"], **kw)
    b_closest, b_any = port_brute(s["p_ds"], s["p_meta"])
    t = torch.from_numpy
    want, w_stats = r_closest.with_stats(jnp.asarray(org), jnp.asarray(d),
                                         0.0, jnp.asarray(tmax))
    got, g_stats = p_closest.with_stats(t(org), t(d), 0.0, t(tmax))
    np.testing.assert_array_equal(g_stats.numpy(), np.asarray(w_stats))
    assert g_stats[0] == 3 * s["p_acc"].n_clusters and g_stats[2] == 0
    oracle = b_closest(t(org), t(d), 0.0, t(tmax))
    valid = np.asarray(want.valid)
    assert valid.sum() > 100
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    _same_hits(got.slot.numpy(), np.asarray(want.slot), got.t.numpy(),
               np.asarray(want.t), s["diag"])
    same = got.slot.numpy() == np.asarray(want.slot)
    for f in ("tri", "inst"):  # the slot's triangle and instance
        np.testing.assert_array_equal(getattr(got, f).numpy()[same],
                                      np.asarray(getattr(want, f))[same], f)
    np.testing.assert_array_equal(got.valid.numpy(), oracle.valid.numpy())
    # the oracle walks triangles in another order, so it may break an
    # exact-t tie differently (the boxes stand on the floor)
    assert (valid & (got.tri.numpy() != oracle.tri.numpy())).sum() <= \
        1e-2 * valid.sum()
    for name in ("t", "u", "v"):
        _close(getattr(got, name).numpy()[valid & same],
               np.asarray(getattr(want, name))[valid & same], s["diag"],
               name)
    np.testing.assert_allclose(got.t.numpy()[valid], oracle.t.numpy()[valid],
                               rtol=1e-5, atol=1e-5 * s["diag"])
    occ_want, wa_stats = r_any.with_stats(jnp.asarray(org), jnp.asarray(d),
                                          0.0, jnp.asarray(shadow_tmax))
    occ, ga_stats = p_any.with_stats(t(org), t(d), 0.0, t(shadow_tmax))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_want))
    np.testing.assert_array_equal(ga_stats.numpy(), np.asarray(wa_stats))
    np.testing.assert_array_equal(
        occ.numpy(), b_any(t(org), t(d), 0.0, t(shadow_tmax)).numpy())
    assert 0 < int(occ.sum()) < n


def test_presets_take_the_all_pairs_mode():
    for name in SCENES:
        cfg = get_config(name)
        scene = SCENES[name](port_proc)
        meta = port_meta(scene)
        acc = build_accel(cfg, port_to_device(scene, device="cpu"), meta,
                          scene=scene, device="cpu")
        assert acc.n_clusters <= tw.ALLPAIRS_MAX_CLUSTERS, name
        assert getattr(acc, "pair_meta", None) is None


def test_cornell_pt_first_bounce_per_ray(monkeypatch, tmp_path):
    """The first bounce of one cornell_pt batch (32×32 × 4 spp, glass and
    glossy boxes) per ray against the reference's staged render of the
    same seed, read from its captured waves: the NEE shadow wave of
    bounce 0 and the bounce-1 wave."""
    monkeypatch.setenv("TPURT_SMEM_TRI", "1")
    monkeypatch.setenv("TPURT_CAPTURE_WAVES", str(tmp_path))
    over = dict(GOLDENS["cornell_pt"], width=32, height=32, spp=4,
                spp_per_batch=4, max_bounces=1)
    ref_render(ref_config("cornell_pt", pipeline="staged", **over))
    cfg = get_config("cornell_pt", **over)
    scene = port_proc.cornell_box(path_tracer=True)
    meta = port_meta(scene)
    ds = port_to_device(scene, device="cpu")
    r = StagedRenderer(ds, build_accel(cfg, ds, meta, scene=scene,
                                       device="cpu"),
                       meta=meta, config=cfg, device="cpu")
    sampler = r.sampler(cfg.seed, 0)
    state = r.raygen(scene.camera, cfg.seed, 0)
    hit, state = r.trace(state, 0)
    state, shadow = r.shade(state, hit, sampler, 0)
    sh = np.load(tmp_path / "shadow0_wave.npz")
    b1 = np.load(tmp_path / "bounce1_wave.npz")
    np.testing.assert_array_equal(shadow[4].numpy(), sh["want"])
    np.testing.assert_array_equal(state.alive.numpy(), b1["alive"])
    assert sh["want"].sum() > 1000 and b1["alive"].sum() > 1000
    # positions on a 555-unit box: a few ulps of 555 (6e-5 each)
    for got, want in ((shadow[0], sh["org"]), (shadow[1], sh["dirn"]),
                      (shadow[2], sh["tmax"]), (state.org, b1["org"]),
                      (state.dirn, b1["dirn"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-3)


def _golden(name):
    return np.load(os.path.join(os.path.dirname(__file__), "golden", "data",
                                f"{name}.npz"))["image"]


@pytest.mark.parametrize("name", ["hello_triangle", "cornell", "cornell_pt"])
def test_golden(name):
    golden = _golden(name)
    state, stats = render_scene(get_config(name, **GOLDENS[name]),
                                device="cpu")
    img = fb.resolve(state).numpy()
    assert img.shape == golden.shape
    assert stats["spp"] == GOLDENS[name]["spp"]
    assert np.isfinite(img).all()
    if name == "cornell_pt":
        assert abs(float(img.mean()) - float(golden.mean())) <= 1e-3
    else:
        assert float(np.sqrt(np.mean((img - golden) ** 2))) <= 1e-3
