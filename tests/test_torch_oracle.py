"""The tile loop's exact plain walk (``tileloop_plain(...,
exact_boxes=True)``), the oracle K1 and K4 are held to on the card,
against the reference kernel's SMEM body (``TPURT_SMEM_TRI=1``, the TPU
default body, in interpret mode), which prunes as K1 does: unpadded box
tests far-limited by the running best t.

The padded plain walk (``exact_boxes=False``) tests every box 1e-5 wider
and so takes a triangle that lies on a box face which the kernels' walk
passes over once an earlier entry lowered the best t: ray 4855 of the
seeded ``sponza_standin(8, 3)`` two-level closest wave below.

Tolerances: slots and instances exact; t within 1e-6 relative plus 1e-6
of the scene diagonal, barycentrics within 2.5e-4 absolute, because
XLA:CPU contracts the object-space transform's and Möller–Trumbore's
multiply-adds where torch rounds every op (tests/test_torch_twolevel.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh import paircluster as ref_pc
from tpurt.kernels import tilewave as ref_tw
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import procedural as ref_proc
from tpurt_torch.bvh import paircluster as port_pc
from tpurt_torch.kernels import tilewave as tw
from tpurt_torch.render.intersectors import scene_meta as port_meta
from tpurt_torch.scene import procedural as port_proc

# One intra-op thread: the suite runs in several worker processes on a few
# cores (tests/test_torch_render.py).
torch.set_num_threads(1)

INT32_MAX = 2 ** 31 - 1
SCENES = {
    "bunny": lambda m: m.bunny_standin(3),
    "sponza_small": lambda m: m.sponza_standin(column_segments=8,
                                               column_rings=3),
    "sponza": lambda m: m.sponza_standin(),
}


@functools.lru_cache(maxsize=None)
def _setup(name):
    """The scene's pair-cluster accel (two-level for the sponza stand-ins)
    in both packages."""
    rs, ps = SCENES[name](ref_proc), SCENES[name](port_proc)
    if name == "bunny":
        r_acc = ref_pc.build_pair_accel(None, ref_meta(rs), scene=rs)
        p_acc = port_pc.build_pair_accel(None, port_meta(ps), scene=ps)
    else:
        r_acc = ref_pc.build_pair_accel_two_level(None, ref_meta(rs),
                                                  scene=rs)
        p_acc = port_pc.build_pair_accel_two_level(None, port_meta(ps),
                                                   scene=ps)
    lo, hi = r_acc.cluster_lo, r_acc.cluster_hi
    return r_acc, p_acc.to("cpu"), float(np.linalg.norm(hi.max(0)
                                                         - lo.min(0)))


def _sponza_small_wave(n_tiles=8):
    """The seeded two-level wave of the card tests
    (tests/test_torch_cuda.py::_k1_modes_case, mode "tl"): rays between
    random points of the scene box, tmax 5–50% of its diagonal, every
    ninth ray dead."""
    _, acc, _ = _setup("sponza_small")
    rng = np.random.default_rng(11)
    n = n_tiles * tw.TILE
    lo = acc.cluster_lo.amin(0).numpy()
    hi = acc.cluster_hi.amax(0).numpy()
    org = lo + rng.uniform(size=(n, 3)) * (hi - lo)
    d = lo + rng.uniform(size=(n, 3)) * (hi - lo) - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    diag = float(np.linalg.norm(hi - lo))
    tmax = np.where(np.arange(n) % 9 == 0, -1.0,
                    rng.uniform(0.05, 0.5, n) * diag)
    f32 = lambda x: np.asarray(x, np.float32)
    return f32(org), f32(d), f32(tmax)


def _reference(name, org, d, tmax, entries_of, sc=False):
    """The reference's K1 (SMEM body, interpret mode) on one wave with
    its own sorted entry rows (over the superboxes with ``sc``). Returns
    (entry rows, counts, scale, [bt, bu, bv, bs(, bi)])."""
    r_acc = _setup(name)[0]
    two_level = name != "bunny"
    lo, hi = ((r_acc.sc_lo, r_acc.sc_hi) if sc
              else (r_acc.cluster_lo, r_acc.cluster_hi))
    n_tiles = org.shape[0] // tw.TILE
    scale = tw.tn_scale_of(lo, hi)
    entry = entries_of(org, d, tmax, lo, hi, n_tiles, scale)
    counts = (entry != INT32_MAX).sum(axis=1, dtype=jnp.int32)[:n_tiles]
    entry = jax.lax.sort(entry)
    tl = {}
    if two_level:
        tl = dict(pair_meta=jnp.asarray(r_acc.pair_meta),
                  inv_xform=jnp.asarray(r_acc.inv_xform),
                  sc_meta=jnp.asarray(r_acc.sc_meta) if sc else None)
    want = ref_tw._launch_tiles_loop(
        None, None, jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmax),
        jnp.asarray(r_acc.tri_rows), n_tiles=n_tiles, interpret=True,
        any_hit=False, n_pairs=jnp.int32(0), overflow=jnp.zeros((), bool),
        tn_scale=jnp.float32(scale), entries=entry, counts=counts, **tl)
    return (np.array(entry)[:n_tiles], np.array(counts), scale,
            [np.asarray(x) for x in want[:5 if two_level else 4]])


def _pallas_entries(org, d, tmax, lo, hi, n_tiles, scale):
    return ref_tw._exact_entries_pallas(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmax),
        jnp.asarray(lo), jnp.asarray(hi), n_tiles, jnp.float32(scale),
        interpret=True)


def _port(name, org, d, tmax, entry, counts, scale, sc=False,
          exact_boxes=True):
    p_acc = _setup(name)[1]
    tl = {}
    if name != "bunny":
        tl = dict(pair_meta=p_acc.pair_meta, inv_xform=p_acc.inv_xform,
                  sc_meta=p_acc.sc_meta if sc else None)
    t = torch.from_numpy
    dt = t(d)
    got = tw.tileloop_plain(t(org), dt, tw._safe_inv(dt), t(tmax),
                            p_acc.tri_rows, t(entry), t(counts), scale,
                            False, exact_boxes=exact_boxes, **tl)
    return [x.numpy() for x in got]


def test_exact_walk_pins_the_face_ray(monkeypatch):
    """Ray 4855 of the seeded sponza_standin(8, 3) two-level closest
    wave, alone in a tile (the other lanes dead): its first entry's hit
    sets bt to 7.4703722, and in cluster 68's object space the slab entry
    of the cluster box and of row 2's sub-box (7.4703727) lies beyond it,
    though a triangle of row 2 lies on the face at t 7.4703717. The
    reference's SMEM body and the exact walk pass over the cluster; the
    padded walk takes that triangle."""
    monkeypatch.setenv("TPURT_SMEM_TRI", "1")
    org8, d8, tmax8 = _sponza_small_wave()
    ray = 4855
    org = np.repeat(org8[ray:ray + 1], tw.TILE, axis=0)
    d = np.repeat(d8[ray:ray + 1], tw.TILE, axis=0)
    tmax = np.full(tw.TILE, -1.0, np.float32)
    tmax[0] = tmax8[ray]
    entry, counts, scale, want = _reference("sponza_small", org, d, tmax,
                                            _pallas_entries)
    exact = _port("sponza_small", org, d, tmax, entry, counts, scale)
    padded = _port("sponza_small", org, d, tmax, entry, counts, scale,
                   exact_boxes=False)
    assert (want[3][0], want[4][0]) == (77.0, 100.0)
    assert (exact[3][0], exact[4][0]) == (77.0, 100.0)
    assert (padded[3][0], padded[4][0]) == (31.0, 68.0)
    np.testing.assert_allclose(exact[0][0], 7.4703722, rtol=1e-7)
    np.testing.assert_allclose(want[0][0], 7.4703722, rtol=1e-6)
    np.testing.assert_allclose(padded[0][0], 7.4703717, rtol=1e-7)
    assert padded[0][0] < exact[0][0]
    # the dead lanes keep their start values
    assert (exact[3][1:] == -1).all() and (exact[0][1:] == -1).all()


def _coherent(seed, n, eye, look, spread, far):
    """Rays from around ``eye`` toward ``look`` in a cone of ``spread``
    radians, tmax uniform in ``far``, every ninth ray dead: one coherent
    tile keeps the reference's interpret-mode walk short."""
    rng = np.random.default_rng(seed)
    org = np.asarray(eye) + rng.normal(size=(n, 3)) * 0.05
    d = np.asarray(look, np.float64) - eye
    d = d / np.linalg.norm(d) + rng.normal(size=(n, 3)) * spread
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(n) % 9 == 0, -1.0,
                    np.random.default_rng(seed + 1).uniform(*far, n))
    f32 = lambda x: np.asarray(x, np.float32)
    return f32(org), f32(d), f32(tmax)


@pytest.mark.parametrize("name,sc", [("bunny", False),
                                     ("sponza_small", False),
                                     ("sponza", True)],
                         ids=["flat", "two_level", "supercluster"])
def test_exact_walk_matches_smem_body(monkeypatch, name, sc):
    """The exact walk against the reference's SMEM body on one seeded
    tile: a tile of rays around the bunny stand-in, and short rays aimed
    at a column of the sponza stand-ins, on per-cluster and (the full
    stand-in, 414 superclusters) supercluster entries. Slots and
    instances equal, floats within the stated tolerance."""
    monkeypatch.setenv("TPURT_SMEM_TRI", "1")
    r_acc, _, diag = _setup(name)
    n = tw.TILE
    if name == "bunny":
        lo, hi = r_acc.cluster_lo.min(0), r_acc.cluster_hi.max(0)
        center = (lo + hi) / 2
        rng = np.random.default_rng(7)
        org = center + rng.normal(size=(n, 3)) * 4.5
        d = center + rng.normal(size=(n, 3)) * 1.2 - org
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tmax = np.where(np.arange(n) % 9 == 0, -1.0,
                        rng.uniform(2.0, 12.0, n))
        org, d, tmax = (np.asarray(x, np.float32) for x in (org, d, tmax))
    else:
        eye, far = (((-15.2, 2.0, 1.8), (0.5, 2.0)) if sc
                    else ((-14.5, 2.0, 1.0), (0.5, 3.5)))
        org, d, tmax = _coherent(3, n, eye, (-16.36, 2.0, 3.0), 0.1, far)
    entry, counts, scale, want = _reference(name, org, d, tmax,
                                            _pallas_entries, sc=sc)
    got = _port(name, org, d, tmax, entry, counts, scale, sc=sc)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[3], want[3])  # slot (bs)
    hits = want[3] >= 0
    assert hits.sum() > 100
    if len(got) == 5:
        np.testing.assert_array_equal(got[4], want[4])  # instance (bi)
    if name == "sponza_small":
        assert len(np.unique(want[4][hits])) > 1
    if sc:  # the entries expand into several children each
        assert (r_acc.sc_meta[entry[0, :int(counts[0])] & 0xFFFF]
                >> 16).max() == 8
    for k, what in ((0, "t"), (1, "u"), (2, "v")):
        atol = 1e-6 * diag if what == "t" else 2.5e-4
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=atol,
                                   err_msg=what)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "lean"])
def test_exact_walk_differs_from_padded_only_on_faces(any_hit):
    """The exact and padded walks over the whole seeded 8-tile wave of
    the card tests: the lean walks agree on every ray (a best t that only
    falls at the first occluder makes the walk's order irrelevant), the
    closest walks on all but ray 4855."""
    _, acc, _ = _setup("sponza_small")
    org, d, tmax = (torch.from_numpy(x) for x in _sponza_small_wave())
    inv_d = tw._safe_inv(d)
    scale = tw.tn_scale_of(acc.cluster_lo.numpy(), acc.cluster_hi.numpy())
    entry = tw.entries_plain(org, inv_d, tmax, acc.cluster_lo,
                             acc.cluster_hi, scale)
    counts = (entry != INT32_MAX).sum(dim=1, dtype=torch.int32)
    entry = torch.sort(entry, dim=1).values
    args = (org, d, inv_d, tmax, acc.tri_rows, entry, counts, scale, any_hit)
    tl = dict(pair_meta=acc.pair_meta, inv_xform=acc.inv_xform)
    exact = tw.tileloop_plain(*args, exact_boxes=True, **tl)
    padded = tw.tileloop_plain(*args, **tl)
    live = tmax >= 0
    differ = torch.nonzero(live & (exact[3] != padded[3]))[:, 0].tolist()
    assert differ == ([] if any_hit else [4855])
    assert int((exact[3][live] >= 0).sum()) > 1000
