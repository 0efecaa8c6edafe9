"""tpurt_torch.kernels.pairwave (the bvh_pair intersector) against
tpurt.kernels.pairwave: the cull/expand phase, the pair test (K6's plain
version against the Pallas kernel in interpret mode, slot by slot), the
intersector against the reference and the brute-force oracle, and a
staged render.

Tolerances: pair lists, block ranges, pair counts, overflow flags, slots,
validity, occlusion, triangle and instance ids exact; hit distances
within 1e-6 relative plus 1e-6 of the scene diagonal and barycentrics
within 1e-4 absolute, because XLA:CPU contracts Möller–Trumbore's
multiply-adds where torch rounds every op (tests/test_torch_tilewave.py);
against the oracle, which sums in another order, t within 1e-4 relative
plus 1e-3 absolute as in tests/unit/test_pairwave.py; images against the
reference's render at RMSE ≤ 1e-3 with under 2% of pixels off by more
than 1e-3 (tests/test_torch_render.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpurt.bvh.paircluster import build_pair_accel as ref_build
from tpurt.kernels import pairwave as ref_pw
from tpurt.render import framebuffer as ref_fb
from tpurt.render import render_scene as ref_render
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import procedural as ref_proc
from tpurt.scene.device import to_device as ref_to_device
from tpurt.utils.config import get_config as ref_config
from tpurt_torch import kernels
from tpurt_torch.bvh.paircluster import build_pair_accel as port_build
from tpurt_torch.kernels import pairwave as pw
from tpurt_torch.kernels import tilewave as tw
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
SCENES = {
    "bunny": lambda m: m.bunny_standin(subdivisions=3),
    "cornell": lambda m: m.cornell_box(path_tracer=True),
}


@functools.lru_cache(maxsize=None)
def _setup(name):
    """bunny_standin(3) (14 clusters) or the Cornell box with glass and
    glossy boxes (1 cluster), flat accel, in both packages."""
    rs, ps = SCENES[name](ref_proc), SCENES[name](port_proc)
    r_ds, p_ds = ref_to_device(rs), port_to_device(ps, device="cpu")
    r_acc = ref_build(r_ds, ref_meta(rs), scene=rs)
    p_acc = port_build(p_ds, port_meta(ps), scene=ps).to("cpu")
    lo, hi = r_acc.cluster_lo, r_acc.cluster_hi
    return dict(r_ds=r_ds, r_acc=r_acc, p_ds=p_ds, p_acc=p_acc,
                p_meta=port_meta(ps),
                diag=float(np.linalg.norm(hi.max(0) - lo.min(0))),
                center=(lo.min(0) + hi.max(0)) / 2)


def _rays(seed, n, center, radius):
    rng = np.random.default_rng(seed)
    org = center + rng.normal(size=(n, 3)) * radius * 1.5
    target = center + rng.normal(size=(n, 3)) * radius * 0.4
    d = target - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def _bunny_wave(n=2500):
    """Rays around the bunny stand-in (some dead, finite and infinite
    tmax) in the intersector's form: tmax BIG where infinite."""
    s = _setup("bunny")
    org, d = _rays(9, n, s["center"], 3.0)
    tmax = np.where(np.arange(n) % 7 == 0, -1.0,
                    np.where(np.arange(n) % 3 == 0, 4.0, tw.BIG)
                    ).astype(np.float32)
    return s, org, d, tmax


@pytest.mark.parametrize("per_ray", [8, 1], ids=["ample", "overflow"])
def test_cull_expand_matches_reference(monkeypatch, per_ray):
    """_cull_expand with RAY_CHUNK patched to 1024 on both sides (three
    ray chunks of 834/834/832 rays): pair lists, block ranges, pair count
    and overflow equal; one pair per ray overflows every chunk."""
    monkeypatch.setattr(ref_pw, "RAY_CHUNK", 1024)
    monkeypatch.setattr(pw, "RAY_CHUNK", 1024)
    s, org, d, tmax = _bunny_wave()
    n = org.shape[0]
    cap = -(-(n * per_ray) // pw.BLOCK) * pw.BLOCK
    lo, hi = s["r_acc"].cluster_lo, s["r_acc"].cluster_hi
    n_c = lo.shape[0]
    want = ref_pw._cull_expand(jnp.asarray(org), jnp.asarray(d),
                               jnp.asarray(tmax), jnp.asarray(lo),
                               jnp.asarray(hi), n_clusters=n_c,
                               pair_cap=cap)
    t = torch.from_numpy
    got = pw._cull_expand(t(org), t(d), t(tmax), t(lo), t(hi),
                          n_clusters=n_c, pair_cap=cap)
    for name, g, w in zip(("pair_ray", "pair_cluster", "block_cmin",
                           "block_cmax"), got[:4], want[:4]):
        w = np.asarray(w)
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got[4]) == int(want[4]) > n
    assert bool(got[5]) == bool(want[5]) == (per_ray == 1)
    assert (got[2] >= 0).any()
    if per_ray == 8:  # ample capacity leaves padding blocks
        assert (got[2] < 0).any()
    assert int((got[3] - got[2]).max()) <= pw.MAX_SPAN - 1


def _pallas_pair_test(pair_ray, pair_cluster, cmin, cmax, org, d, tm,
                      tri_rows):
    """The reference's pair-test launch (tpurt/kernels/pairwave.py
    :_trace_pairs, its field gathers and pallas_call) in interpret mode,
    returning the per-slot bt, bu, bv, bs."""
    n = org.shape[0]
    p = pair_ray.shape[0]
    n_blocks = p // ref_pw.BLOCK
    safe = jnp.clip(pair_ray, 0, n - 1)
    dead = pair_ray < 0

    def field(a, fill):
        return jnp.where(dead, fill, a[safe]).reshape(n_blocks * 8, 128)

    args = (field(org[:, 0], 0.0), field(org[:, 1], 0.0),
            field(org[:, 2], 0.0), field(d[:, 0], 1.0), field(d[:, 1], 1.0),
            field(d[:, 2], 1.0), field(tm, -1.0),
            jnp.where(dead, -1.0, pair_cluster.astype(jnp.float32)
                      ).reshape(n_blocks * 8, 128))
    tile = lambda: pl.BlockSpec((8, 128), lambda i, *_: (i, 0),
                                memory_space=pltpu.VMEM)
    out_shape = jax.ShapeDtypeStruct((n_blocks * 8, 128), jnp.float32)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(n_blocks,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] + [tile()] * 8,
        out_specs=[tile()] * 4)
    out = pl.pallas_call(ref_pw._pair_kernel, grid_spec=grid_spec,
                         out_shape=[out_shape] * 4, interpret=True)(
        cmin, cmax, tri_rows, *args)
    return [np.asarray(x).reshape(p) for x in out]


def test_pair_test_plain_matches_pallas():
    """K6's plain version against the reference kernel on the same pair
    list, slot by slot: slots equal, dead slots (−1, 0, 0, −1) on both
    sides, t/u/v within the stated tolerance."""
    s, org, d, tmax = _bunny_wave(1200)
    n = org.shape[0]
    acc = s["r_acc"]
    lo, hi = acc.cluster_lo, acc.cluster_hi
    cap = -(-(n * 8) // pw.BLOCK) * pw.BLOCK
    pr, pc, cmin, cmax, _, _ = ref_pw._cull_expand(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmax),
        jnp.asarray(lo), jnp.asarray(hi), n_clusters=lo.shape[0],
        pair_cap=cap)
    want = _pallas_pair_test(pr, pc, cmin, cmax, jnp.asarray(org),
                             jnp.asarray(d), jnp.asarray(tmax),
                             jnp.asarray(acc.tri_rows))
    t = torch.from_numpy
    got = pw.pair_test_plain(t(np.array(pr)), t(np.array(pc)),
                             t(np.array(cmin)), t(org), t(d), t(tmax),
                             s["p_acc"].tri_rows)
    got = [x.numpy() for x in got]
    np.testing.assert_array_equal(got[3], want[3])  # slot (bs)
    hit = want[3] >= 0
    dead = np.array(pr) < 0
    assert hit.sum() > 200 and dead.sum() > 0
    for k in range(4):
        np.testing.assert_array_equal(got[k][dead], want[k][dead])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6,
                               atol=1e-6 * s["diag"])
    for k in (1, 2):
        np.testing.assert_allclose(got[k][hit], want[k][hit], atol=1e-4)
        np.testing.assert_array_equal(got[k][~hit], 0.0)


def _intersectors(name, **kw):
    s = _setup(name)
    ref = ref_pw.make_pair_intersector(s["r_ds"], s["r_acc"],
                                       interpret=True, **kw)
    port = pw.make_pair_intersector(s["p_ds"], s["p_acc"], **kw)
    oracle = port_brute(s["p_ds"], s["p_meta"])
    return s, ref, port, oracle


def _check_closest(s, want, got, oracle):
    """Per ray: validity exact; slot, triangle and instance exact except
    at exact-t ties of coplanar faces (the Cornell boxes stand on the
    floor), where an ulp of XLA's contraction lets the reference's
    min-slot tie-break see two equal t that the port sees one ulp apart:
    there t agrees and such rays stay under 1%."""
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.valid.numpy(), oracle.valid.numpy())
    same = got.slot.numpy() == np.asarray(want.slot)
    assert (~same).sum() <= 0.01 * valid.sum()
    for f in ("slot", "tri", "inst"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[same],
                                      np.asarray(getattr(want, f))[same], f)
    np.testing.assert_allclose(got.t.numpy()[valid],
                               np.asarray(want.t)[valid], rtol=1e-6,
                               atol=1e-6 * s["diag"])
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[valid & same],
                                   np.asarray(getattr(want, f))[valid & same],
                                   atol=1e-4)
    np.testing.assert_allclose(got.t.numpy()[valid],
                               oracle.t.numpy()[valid], rtol=1e-4, atol=1e-3)
    return valid


def test_closest_matches_reference_and_oracle():
    """Closest hits in the Cornell box (mirrors
    tests/unit/test_pairwave.py::test_closest_matches_oracle)."""
    s, (r_closest, _), (p_closest, _), (b_closest, _) = _intersectors(
        "cornell")
    org, d = _rays(1, 512, np.array([278, 278, 278.0]), 400.0)
    t = torch.from_numpy
    want, w_stats = r_closest.with_stats(jnp.asarray(org), jnp.asarray(d),
                                         0.0, jnp.inf)
    got, g_stats = p_closest.with_stats(t(org), t(d), 0.0, np.inf)
    np.testing.assert_array_equal(g_stats.numpy(), np.asarray(w_stats))
    valid = _check_closest(s, want, got, b_closest(t(org), t(d), 0.0,
                                                   np.inf))
    assert valid.sum() > 100


def test_any_hit_matches_reference_and_oracle():
    """Occlusion under random tmax in the Cornell box; the any-hit
    closure has no with_stats, as in the reference."""
    s, (_, r_any), (_, p_any), (_, b_any) = _intersectors("cornell")
    org, d = _rays(2, 512, np.array([278, 278, 278.0]), 400.0)
    tmax = np.random.default_rng(3).uniform(10.0, 900.0, 512
                                            ).astype(np.float32)
    t = torch.from_numpy
    occ = p_any(t(org), t(d), 0.0, t(tmax)).numpy()
    np.testing.assert_array_equal(occ, np.asarray(
        r_any(jnp.asarray(org), jnp.asarray(d), 0.0, jnp.asarray(tmax))))
    np.testing.assert_array_equal(occ, b_any(t(org), t(d), 0.0,
                                             t(tmax)).numpy())
    assert 0 < occ.sum() < occ.shape[0]
    assert not hasattr(p_any, "with_stats")
    assert not hasattr(r_any, "with_stats")


def test_dead_lanes():
    """Rays with tmax < 0 neither hit nor occlude."""
    s, (r_closest, _), (p_closest, p_any), _ = _intersectors("cornell")
    org, d = _rays(4, 256, np.array([278, 278, 278.0]), 400.0)
    tmax = np.where(np.arange(256) % 2 == 0, np.inf, -1.0).astype(np.float32)
    t = torch.from_numpy
    h = p_closest(t(org), t(d), 0.0, t(tmax))
    assert not h.valid.numpy()[1::2].any() and h.valid.numpy()[0::2].any()
    assert (h.slot.numpy()[1::2] == -1).all()
    assert not p_any(t(org), t(d), 0.0, t(tmax)).numpy()[1::2].any()
    want = r_closest(jnp.asarray(org), jnp.asarray(d), 0.0,
                     jnp.asarray(tmax))
    np.testing.assert_array_equal(h.slot.numpy(), np.asarray(want.slot))


def test_instanced_mesh_slots():
    """The bunny stand-in's slots, triangle and instance ids per ray
    against the reference and the oracle (mirrors
    tests/unit/test_pairwave.py::test_instanced_mesh_slots)."""
    s, (r_closest, _), (p_closest, _), (b_closest, _) = _intersectors(
        "bunny")
    org, d = _rays(5, 1024, s["center"], 3.0)
    t = torch.from_numpy
    want = r_closest(jnp.asarray(org), jnp.asarray(d), 0.0, jnp.inf)
    got = p_closest(t(org), t(d), 0.0, np.inf)
    oracle = b_closest(t(org), t(d), 0.0, np.inf)
    valid = _check_closest(s, want, got, oracle)
    assert valid.sum() > 200
    np.testing.assert_array_equal(got.tri.numpy()[valid],
                                  oracle.tri.numpy()[valid])
    np.testing.assert_array_equal(got.inst.numpy()[valid],
                                  oracle.inst.numpy()[valid])


def test_overflow_flag():
    """One pair per ray on the 14-cluster stand-in overflows: the stats
    (pair count, flag) equal the reference's and the hits stay well
    formed and equal to the reference's (mirrors
    tests/unit/test_pairwave.py::test_overflow_flag)."""
    s, (r_closest, _), (p_closest, _), _ = _intersectors("bunny",
                                                         pairs_per_ray=1)
    org, d = _rays(6, 2048, s["center"], 3.0)
    t = torch.from_numpy
    want, w_stats = r_closest.with_stats(jnp.asarray(org), jnp.asarray(d),
                                         0.0, jnp.inf)
    got, g_stats = p_closest.with_stats(t(org), t(d), 0.0, np.inf)
    np.testing.assert_array_equal(g_stats.numpy(), np.asarray(w_stats))
    assert g_stats[0] > 2048 and g_stats[1] == 1.0
    np.testing.assert_array_equal(got.slot.numpy(), np.asarray(want.slot))
    assert ((got.slot.numpy() >= 0) == got.valid.numpy()).all()


def test_launcher_rejects_cpu_tensors():
    """The CUDA launcher never falls back: CPU tensors are refused."""
    s = _setup("bunny")
    z = torch.zeros(pw.BLOCK, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pw.pair_test_cuda(z, z, z[:1], torch.zeros(4, 3), torch.ones(4, 3),
                          torch.ones(4), s["p_acc"].tri_rows)
    assert kernels.launch_counts()["pair"] == 0


SMALL = dict(width=32, height=24, spp=1, spp_per_batch=1, max_bounces=2,
             intersector="bvh_pair")


def test_staged_render_matches_reference():
    """A staged render of the bunny stand-in through bvh_pair against the
    reference's staged bvh_pair render of the same seed: within the image
    bars, the same ray counts, no overflow, no retry."""
    state, stats = render_scene(get_config("bunny", **SMALL), device="cpu",
                                scene=port_proc.bunny_standin(3))
    ref_state, ref_stats = ref_render(
        ref_config("bunny", pipeline="staged", **SMALL),
        scene=ref_proc.bunny_standin(3))
    img = fb.resolve(state).numpy()
    want = np.asarray(ref_fb.resolve(ref_state))
    assert img.shape == want.shape == (24, 32, 3)
    assert float(np.sqrt(np.mean((img - want) ** 2))) <= RMSE_TOL
    assert float((np.abs(img - want) > 1e-3).mean()) < 0.02
    for key in ("rays_closest", "rays_shadow"):
        np.testing.assert_allclose(stats[key], ref_stats[key], rtol=1e-3)
    assert not stats["pair_overflow"] and not ref_stats["pair_overflow"]
    assert stats["budget_retries"] == ref_stats["budget_retries"] == 0


def test_pairs_per_ray_retries_to_the_ample_render():
    """pairs_per_ray=1 overflows the closest waves and doubles until they
    fit: at least one retry, no overflow left, and the image of the
    default budget bit for bit (the bvh_tile render of the same seed too:
    both intersectors return the same closest hits)."""
    scene = port_proc.bunny_standin(3)
    ample, _ = render_scene(get_config("bunny", **SMALL), device="cpu",
                            scene=scene)
    state, stats = render_scene(
        get_config("bunny", **dict(SMALL, pairs_per_ray=1)), device="cpu",
        scene=scene)
    assert stats["budget_retries"] >= 1 and not stats["pair_overflow"]
    assert torch.equal(state.accum, ample.accum)
    tile, _ = render_scene(
        get_config("bunny", **dict(SMALL, intersector="bvh_tile")),
        device="cpu", scene=scene)
    assert torch.equal(tile.accum, ample.accum)
