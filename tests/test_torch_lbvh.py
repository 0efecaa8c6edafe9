"""The port's LBVH builds and two-level walk against the reference's
(``tpurt.bvh.lbvh``, ``tpurt.bvh.two_level``), mirroring
tests/property/test_bvh.py, on the CPU.

Tolerances: Morton codes and every LBVH table (perm, first, count, skip,
n_active) bit-equal, the f32 boxes equal (the TLAS boxes too: the port
rounds the instance transform as XLA:CPU's fused chain does). The walk,
run on the reference's own accel arrays: hit flags, triangles and
instances equal, t within 1e-6 relative, barycentrics within 1e-4 (2.5e-4
through an instance transform: XLA:CPU contracts the Möller–Trumbore
multiply-adds, ROADMAP §3). Against the port's brute force, as the
reference holds its walk to its own: hit flags equal, t within 1e-4, the
same triangle unless the two t tie (coplanar Cornell faces).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh import lbvh as ref_lbvh
from tpurt.bvh import two_level as ref_tl
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import procedural as ref_proc
from tpurt.scene.device import to_device as ref_to_device
from tpurt_torch.bvh import lbvh, two_level
from tpurt_torch.render.intersectors import make_brute_force, scene_meta
from tpurt_torch.scene import procedural
from tpurt_torch.scene.device import to_device

torch.set_num_threads(1)

_ref_build = jax.jit(ref_lbvh.build_lbvh, static_argnames="leaf_size")


def _random_boxes(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10.0, 10.0, (n, 3)).astype(np.float32)
    v = [c + rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
         for _ in range(3)]
    return v


def _assert_tables_equal(ref, port):
    for f in ref._fields:
        want = np.asarray(getattr(ref, f))
        got = getattr(port, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_morton_codes_bit_equal():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-5.0, 7.0, (4096, 3)).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    want = np.asarray(ref_lbvh.morton_codes(jnp.asarray(pts),
                                            jnp.asarray(lo),
                                            jnp.asarray(hi)))
    got = lbvh.morton_codes(torch.from_numpy(pts), torch.from_numpy(lo),
                            torch.from_numpy(hi)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert len(np.unique(got)) > 1000


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 257])
@pytest.mark.parametrize("leaf_size", [1, 4])
def test_build_lbvh_bit_equal(n, leaf_size):
    v0, v1, v2 = _random_boxes(n, seed=n)
    ref = _ref_build(*ref_lbvh.tri_aabbs(*map(jnp.asarray, (v0, v1, v2))),
                     leaf_size=leaf_size)
    port = lbvh.build_lbvh(*lbvh.tri_aabbs(*map(torch.from_numpy,
                                                (v0, v1, v2))),
                           leaf_size=leaf_size)
    _assert_tables_equal(ref, port)
    assert int(port.n_active) <= 2 * n - 1
    assert port.num_prims == ref.num_prims == n
    assert port.capacity == ref.capacity


@pytest.mark.parametrize("leaf_size", [1, 4])
def test_build_lbvh_duplicate_centroids(leaf_size):
    """33 identical triangles: equal Morton codes, told apart by index."""
    tri = [np.tile(np.asarray([p], np.float32), (33, 1))
           for p in ([0, 0, 0], [1, 0, 0], [0, 1, 0])]
    ref = _ref_build(*ref_lbvh.tri_aabbs(*map(jnp.asarray, tri)),
                     leaf_size=leaf_size)
    port = lbvh.build_lbvh(*lbvh.tri_aabbs(*map(torch.from_numpy, tri)),
                           leaf_size=leaf_size)
    _assert_tables_equal(ref, port)


SCENES = {
    "cornell": lambda p: p.cornell_box(),
    "bunny_subset": lambda p: p.bunny_standin(subdivisions=3),
    "instanced": lambda p: p.sponza_standin(8, 3),
}


@functools.lru_cache(maxsize=None)
def _scenes(name):
    """(reference ds, reference accel, port ds, port meta) of a scene."""
    rs = SCENES[name](ref_proc)
    rmeta = ref_meta(rs)
    rds = ref_to_device(rs)
    build = jax.jit(functools.partial(ref_tl.build_scene_accel, meta=rmeta,
                                      leaf_size=4))
    ps = SCENES[name](procedural)
    return rds, build(rds), to_device(ps, device="cpu"), scene_meta(ps)


@pytest.mark.parametrize("name", list(SCENES))
def test_build_scene_accel_equal(name):
    _, ref, ds, meta = _scenes(name)
    port = two_level.build_scene_accel(ds, meta, leaf_size=4)
    _assert_tables_equal(ref, port)


def _random_rays(ref_accel, n, seed):
    """Rays from around the scene box in every direction (as
    tests/property/test_bvh.py draws them)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(ref_accel.node_bmin[0])
    hi = np.asarray(ref_accel.node_bmax[0])
    span = hi - lo
    org = (rng.uniform(size=(n, 3)) * span * 1.6 + lo
           - 0.3 * span).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.float32(0.5 * np.linalg.norm(span))
    return org, d, tmax


@pytest.mark.parametrize("name", list(SCENES))
def test_walk_matches_reference_walk(name):
    rds, ref, ds, _ = _scenes(name)
    accel = two_level.scene_accel_from_arrays(
        [np.asarray(a) for a in ref], "cpu")
    org, d, tmax = _random_rays(ref, 1024, seed=11)
    r_closest, r_any = ref_tl.make_two_level_intersector(rds, ref, 4)
    p_closest, p_any = two_level.make_two_level_intersector(ds, accel, 4)
    to = torch.from_numpy
    want = r_closest(jnp.asarray(org), jnp.asarray(d), 0.0, jnp.inf)
    got = p_closest(to(org), to(d), 0.0, torch.inf)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.mean() > 0.1
    for f in ("tri", "inst"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[valid],
                                      np.asarray(getattr(want, f))[valid])
    np.testing.assert_allclose(got.t.numpy()[valid],
                               np.asarray(want.t)[valid], rtol=1e-6)
    bary_tol = 2.5e-4 if name != "bunny_subset" else 1e-4
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy()[valid],
                                   np.asarray(getattr(want, f))[valid],
                                   atol=bary_tol)
    occ_want = np.asarray(r_any(jnp.asarray(org), jnp.asarray(d), 0.0,
                                jnp.float32(tmax)))
    occ = p_any(to(org), to(d), 0.0, float(tmax)).numpy()
    np.testing.assert_array_equal(occ, occ_want)
    assert 0 < occ.sum() < occ.size


@pytest.mark.parametrize("name", list(SCENES))
def test_walk_matches_brute_force(name):
    _, _, ds, meta = _scenes(name)
    accel = two_level.build_scene_accel(ds, meta, leaf_size=4)
    org, d, tmax = _random_rays(_scenes(name)[1], 512, seed=5)
    to = torch.from_numpy
    bf_closest, bf_any = make_brute_force(ds, meta)
    tl_closest, tl_any = two_level.make_two_level_intersector(ds, accel, 4)
    hb = bf_closest(to(org), to(d), 0.0, torch.inf)
    hv = tl_closest(to(org), to(d), 0.0, torch.inf)
    assert torch.equal(hb.valid, hv.valid)
    m = hb.valid
    np.testing.assert_allclose(hv.t[m].numpy(), hb.t[m].numpy(), rtol=1e-4,
                               atol=1e-4)
    same = (hb.tri[m] == hv.tri[m]) & (hb.inst[m] == hv.inst[m])
    tie = torch.isclose(hb.t[m], hv.t[m], rtol=1e-4, atol=1e-4)
    assert bool((same | tie).all())
    assert torch.equal(bf_any(to(org), to(d), 0.0, float(tmax)),
                       tl_any(to(org), to(d), 0.0, float(tmax)))
