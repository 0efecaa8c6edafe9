"""The bvh_packet path of tpurt_torch against tpurt: the packet-BVH build,
the walk's plain version (K5) against the reference's Pallas kernel in
interpret mode, the intersector's closures, and a whole render.

Tolerances: the accel tables byte-equal to the reference's, tree build
for tree build (both packages build natively by default and in Python
under ``TPURT_NO_NATIVE=1``; the two builds order leaves differently);
the walks below use the Python trees; occlusion exact; slots equal on ≥ 99.9% of hit rays, and
where they differ the two hits sit at an equal t (the reference's packet
enters every leaf the packet's union reaches, the port's walk only the
ray's own: a grazing box or an exact-t tie can pick the other triangle);
t within 1e-6 relative; barycentrics within 1e-4 absolute, because
XLA:CPU contracts Möller–Trumbore's multiply-adds
(tests/test_torch_tilewave.py). The render against the reference's
staged render at RMSE ≤ 1e-3 with under 2% of pixels off by more than
1e-3 (tests/test_torch_render.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.kernels.packet as ref_packet_mod
from tpurt.bvh.cluster import build_packet_accel as ref_build
from tpurt.render import framebuffer as ref_fb
from tpurt.render import render_scene as ref_render
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import procedural as ref_proc
from tpurt.scene.device import to_device as ref_to_device
from tpurt.utils import native as ref_native
from tpurt.utils.config import get_config as ref_config
from tpurt_torch.bvh.cluster import PacketAccel, build_packet_accel
from tpurt_torch.kernels import packet as pk
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render import render_scene
from tpurt_torch.render.intersectors import make_brute_force
from tpurt_torch.render.intersectors import scene_meta as port_meta
from tpurt_torch.scene import procedural as port_proc
from tpurt_torch.scene.device import to_device as port_to_device
from tpurt_torch.utils.config import get_config

# One intra-op thread: the suite runs in several worker processes on a few
# cores (tests/test_torch_render.py).
torch.set_num_threads(1)

RMSE_TOL = 1e-3
SCENES = {"bunny": lambda p: p.bunny_standin(subdivisions=3),
          "cornell": lambda p: p.cornell_box(path_tracer=True)}


def _ref_accel(name, native: bool):
    rs = SCENES[name](ref_proc)
    if native:
        return ref_build(ref_to_device(rs), ref_meta(rs), scene=rs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPURT_NO_NATIVE", "1")
        mp.setattr(ref_native, "_tried", False)
        return ref_build(ref_to_device(rs), ref_meta(rs), scene=rs)


@functools.lru_cache(maxsize=None)
def _port_accel(name, native: bool = False):
    ps = SCENES[name](port_proc)
    if native:
        return build_packet_accel(None, port_meta(ps), scene=ps)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPURT_NO_NATIVE", "1")
        return build_packet_accel(None, port_meta(ps), scene=ps)


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_packet_accel_matches_reference(name, native):
    """The port's build against the reference's, tree build for tree
    build: every table byte-equal."""
    want = _ref_accel(name, native)
    got = _port_accel(name, native)
    assert isinstance(got, PacketAccel) and got.n_nodes > 1
    for f in got._fields:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    # a valid preorder tree: the root spans every node, leaves cover rows
    assert got.node_skip[0] == got.n_nodes
    leaves = got.node_count > 0
    assert got.node_count[leaves].sum() == got.n_rows


@pytest.fixture(scope="module")
def bunny_walk():
    """bunny_standin(3) (215 nodes over 108 one-row leaves) in both
    packages, and 2500 rays around it (two 2048-ray groups, so the sorts
    engage; every seventh ray dead)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPURT_NO_NATIVE", "1")
        mp.setattr(ref_native, "_tried", False)
        rs = SCENES["bunny"](ref_proc)
        r_acc = ref_build(ref_to_device(rs), ref_meta(rs), scene=rs)
    p_acc = _port_accel("bunny").to("cpu")
    lo = np.stack([r_acc.node_bminx[0], r_acc.node_bminy[0],
                   r_acc.node_bminz[0]])
    hi = np.stack([r_acc.node_bmaxx[0], r_acc.node_bmaxy[0],
                   r_acc.node_bmaxz[0]])
    rng = np.random.default_rng(3)
    n = 2500
    center = (lo + hi) / 2
    org = center + rng.normal(size=(n, 3)) * 4.5
    d = center + rng.normal(size=(n, 3)) * 1.2 - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(n) % 7 == 0, -1.0, 3.4e38)
    shadow_tmax = np.where(np.arange(n) % 7 == 0, -1.0,
                           rng.uniform(2.0, 6.0, n))
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(r_acc=r_acc, p_acc=p_acc, org=f32(org), d=f32(d),
                tmax=f32(tmax), shadow_tmax=f32(shadow_tmax),
                diag=float(np.linalg.norm(hi - lo)))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("sort", ["none", "octant", "morton"])
def test_packet_walk_matches_pallas(bunny_walk, sort, any_hit):
    """The port's _trace (sort, padding, the walk's plain version, restore)
    against the reference's _trace in interpret mode, per ray."""
    w = bunny_walk
    r_acc, p_acc = w["r_acc"], w["p_acc"]
    tmax = w["shadow_tmax"] if any_hit else w["tmax"]
    tables = tuple(jnp.asarray(getattr(r_acc, f))
                   for f in r_acc._fields[:10])
    want = ref_packet_mod._trace(
        jnp.asarray(w["org"]), jnp.asarray(w["d"]), jnp.asarray(tmax),
        tables, n_nodes=r_acc.n_nodes, any_hit=any_hit, interpret=True,
        ray_sort=sort)
    want = [np.asarray(x) for x in want]
    t = torch.from_numpy
    got = pk._trace(t(w["org"]), t(w["d"]), t(tmax), tuple(p_acc[:10]),
                    any_hit=any_hit, ray_sort=sort)
    got = [x.numpy() for x in got]
    n_groups = -(-w["org"].shape[0] // pk.PACKET)
    assert got[4].shape == want[4].shape == (n_groups, 2)
    assert (got[4] > 0).all()
    hit = want[3] >= 0
    np.testing.assert_array_equal(got[3] >= 0, hit)
    assert 300 < hit.sum() < hit.shape[0]
    if any_hit:
        np.testing.assert_array_equal(got[0], want[0])  # 0 / BIG
        return
    same = got[3] == want[3]
    assert same[hit].mean() >= 0.999
    np.testing.assert_array_equal(got[0][hit & ~same], want[0][hit & ~same])
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-6)
    for k in (1, 2):
        np.testing.assert_allclose(got[k][hit & same], want[k][hit & same],
                                   rtol=0, atol=1e-4)


def test_packet_closures(bunny_walk):
    """The closures carry no with_stats (the walk has no budget to
    overflow); closest.traversal_stats returns the hit and the (G, 2)
    counters; hits agree with the brute-force oracle; the CUDA launcher
    refuses CPU tensors."""
    w = bunny_walk
    ps = SCENES["bunny"](port_proc)
    ds = port_to_device(ps, "cpu")
    closest, any_hit = pk.make_packet_intersector(ds, w["p_acc"],
                                                  ray_sort="octant")
    assert not hasattr(closest, "with_stats")
    assert not hasattr(any_hit, "with_stats")
    t = torch.from_numpy
    org, d = t(w["org"]), t(w["d"])
    hit, stats = closest.traversal_stats(org, d, 0.0, t(w["tmax"]))
    assert stats.shape == (2, 2) and stats.dtype == torch.float32
    assert torch.equal(closest(org, d, 0.0, t(w["tmax"])).slot, hit.slot)
    b_closest, b_any = make_brute_force(ds, port_meta(ps))
    oracle = b_closest(org, d, 0.0, t(w["tmax"]))
    assert torch.equal(hit.valid, oracle.valid)
    valid = hit.valid
    np.testing.assert_allclose(hit.t[valid].numpy(), oracle.t[valid].numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(hit.inst[valid], oracle.inst[valid])
    assert float((hit.tri[valid] == oracle.tri[valid]).float().mean()) > 0.99
    occ = any_hit(org, d, 0.0, t(w["shadow_tmax"]))
    assert torch.equal(occ, b_any(org, d, 0.0, t(w["shadow_tmax"])))
    with pytest.raises(ValueError, match="CUDA"):
        pk.packet_cuda(tuple(w["p_acc"][:10]), org[:2048], d[:2048],
                       t(w["tmax"])[:2048], False)
    assert pk.packet_cuda.launches == 0


def test_packet_render_matches_reference(monkeypatch):
    """render_scene with bvh_packet (bunny_standin(3), 32×24, 1 spp)
    against the reference's staged render of the same config. The
    reference's closest closure carries with_stats, whose (G, 2) counters
    its render loops add into the pair-overflow slot and fail on; the test
    hides it (ROADMAP §3), as the port's closures do by design."""
    make = ref_packet_mod.make_packet_intersector

    def without_stats(*args, **kwargs):
        closest, any_hit = make(*args, **kwargs)
        del closest.with_stats
        return closest, any_hit

    monkeypatch.setattr(ref_packet_mod, "make_packet_intersector",
                        without_stats)
    monkeypatch.setenv("TPURT_NO_NATIVE", "1")
    monkeypatch.setattr(ref_native, "_tried", False)
    over = dict(width=32, height=24, spp=1, spp_per_batch=1,
                intersector="bvh_packet")
    state, stats = render_scene(get_config("bunny", **over), device="cpu",
                                scene=port_proc.bunny_standin(3))
    ref_state, ref_stats = ref_render(
        ref_config("bunny", pipeline="staged", **over),
        scene=ref_proc.bunny_standin(3))
    img = fb.resolve(state).numpy()
    want = np.asarray(ref_fb.resolve(ref_state))
    assert img.shape == want.shape == (24, 32, 3) and np.isfinite(img).all()
    assert float(np.sqrt(np.mean((img - want) ** 2))) <= RMSE_TOL
    assert float((np.abs(img - want) > 1e-3).mean()) < 0.02
    assert not stats["pair_overflow"] and not ref_stats["pair_overflow"]
    for key in ("rays_closest", "rays_shadow"):
        np.testing.assert_allclose(stats[key], ref_stats[key], rtol=1e-3)
    # the same frame through bvh_tile: the same hits, shaded per field
    tile, _ = render_scene(get_config("bunny", **dict(
        over, intersector="bvh_tile")), device="cpu",
        scene=port_proc.bunny_standin(3))
    tile_img = fb.resolve(tile).numpy()
    assert float(np.sqrt(np.mean((img - tile_img) ** 2))) <= RMSE_TOL


@pytest.mark.parametrize("preset", ["bunny", "sponza"])
def test_packed_nodes_decode(preset):
    """K5's packed node words (two 16-byte words a node, first << 8 |
    count in the last) decode to the node tables they came from, for the
    packet BVHs of the bunny and the sponza stand-in (the presets'
    scenes), whose leaves' row counts and first rows fit the packing;
    a count past the bits raises."""
    from tpurt_torch.scene.loader import load_scene

    scene = load_scene(get_config(preset).scene)
    acc = build_packet_accel(None, port_meta(scene), scene=scene).to("cpu")
    tables = pk.packet_tables(acc)
    nodes = tables[10]
    assert nodes.shape == (tables[0].shape[0], 8)
    assert nodes.dtype == torch.float32 and nodes.is_contiguous()
    ints = lambda k: nodes[:, k].contiguous().view(torch.int32)
    fc = ints(7)
    decoded = (nodes[:, 0], nodes[:, 1], nodes[:, 2], nodes[:, 4],
               nodes[:, 5], nodes[:, 6], fc >> pk.COUNT_BITS,
               fc & ((1 << pk.COUNT_BITS) - 1), ints(3))
    for got, want in zip(decoded, tables[:9]):
        assert torch.equal(got, want.to(got.dtype))
    assert int(tables[7].max()) >= 1  # leaves with rows
    bad = list(tables[:10])
    bad[7] = bad[7].clone()
    bad[7][int(torch.nonzero(bad[7])[0, 0])] = 1 << pk.COUNT_BITS
    with pytest.raises(ValueError, match="packed word"):
        pk.pack_nodes(bad)


def _shared_fold(tc, lanes=4):
    """The kernel's shared row fold (csrc/packet.cu, leaf_rows): lane s of
    a group keeps the first minimum of its triangles s, s + lanes, …, then
    the group combines by (t, triangle) in the kernel's xor order.
    Returns the winning triangle of each row."""
    best = []
    for s in range(lanes):
        t, j = tc[:, s].copy(), np.full(tc.shape[0], s)
        for k in range(s + lanes, tc.shape[1], lanes):
            take = tc[:, k] < t
            t, j = np.where(take, tc[:, k], t), np.where(take, k, j)
        best.append((t, j))
    off = 1
    while off < lanes:
        nxt = []
        for s in range(lanes):
            (t, j), (ot, oj) = best[s], best[s ^ off]
            take = (ot < t) | ((ot == t) & (oj < j))
            nxt.append((np.where(take, ot, t), np.where(take, oj, j)))
        best, off = nxt, off * 2
    assert all((b[1] == best[0][1]).all() for b in best)
    return best[0][1]


def test_shared_row_fold_is_the_sequential_fold():
    """K5's 4-lane row fold picks the triangle of the sequential
    12-triangle fold (the first at the minimal t; failed tests at BIG) on
    seeded rows whose candidates tie at equal t all the time."""
    rng = np.random.default_rng(17)
    tc = rng.choice(np.float32([0.5, 1.25, 2.0, 3.0, pk.BIG]),
                    size=(20000, 12)).astype(np.float32)
    tc[:50] = np.float32(pk.BIG)  # every test failed: triangle 0
    tc[50:100] = np.float32(1.25)  # all twelve tied
    want = np.argmin(tc, axis=1)  # numpy: the first minimum
    seq = np.zeros(tc.shape[0], np.int64)
    for j in range(1, 12):  # the kernel's own-row fold, strict '<'
        seq = np.where(tc[:, j] < tc[np.arange(tc.shape[0]), seq], j, seq)
    np.testing.assert_array_equal(seq, want)
    np.testing.assert_array_equal(_shared_fold(tc), want)
    assert (want[:50] == 0).all() and (want[50:100] == 0).all()
    ties = (tc == tc.min(axis=1, keepdims=True)).sum(axis=1) > 1
    assert ties.mean() > 0.3
