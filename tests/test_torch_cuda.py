"""tpurt_torch's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA GPU and skips without one.

This file imports neither jax nor tpurt, so it also runs where only the
port's dependencies are installed (a GPU machine without jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances (as chip_smoke.py): the entry build and the exact mask
bit-equal; the pair test and the packet walk bit-equal (the plain
version's op order, no contraction, IEEE division; the walk's group
counters too); the traversal loop (every mode) against the plain
version's exact walk (``exact_boxes=True``: unpadded boxes far-limited by
the running best t, as the kernel prunes) with the slot equal on ≥
99.99% of live rays and bt within 1e-6 relative on those; the grid over
pairs bit-equal to that walk (any-hit: the occlusion flag equal); a
render on the card within RMSE 1e-3 of the same render on the CPU (the
plain versions, and torch's CPU and CUDA elementwise kernels round
transcendentals differently).
"""

import numpy as np
import pytest
import torch

from tpurt_torch.bvh.paircluster import build_pair_accel, \
    build_pair_accel_two_level
from tpurt_torch import kernels
from tpurt_torch.kernels import pairwave as pw
from tpurt_torch.kernels import tilewave as tw
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render import render_scene
from tpurt_torch.render.intersectors import scene_meta
from tpurt_torch.scene.procedural import bunny_standin, cornell_box, \
    sponza_standin
from tpurt_torch.utils.config import get_config


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch finds none)")
    return torch.device("cuda", 0)


@pytest.fixture
def wave(cuda_device):
    """Three tiles of seeded random rays around bunny_standin(3) (14
    clusters), with capped tmax and some dead lanes, on the card."""
    return _standin_wave(cuda_device, 3)


def _standin_wave(cuda_device, n_tiles):
    scene = bunny_standin(subdivisions=3)
    accel = build_pair_accel(None, scene_meta(scene), scene=scene)
    rng = np.random.default_rng(7)
    n = n_tiles * tw.TILE
    center = (accel.cluster_lo.min(0) + accel.cluster_hi.max(0)) / 2
    org = center + rng.normal(size=(n, 3)) * 4.5
    d = center + rng.normal(size=(n, 3)) * 1.2 - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(n) % 9 == 0, -1.0, rng.uniform(2.0, 12.0, n))
    t = lambda x: torch.from_numpy(
        np.asarray(x, np.float32)).to(cuda_device)
    acc = accel.to(cuda_device)
    dirn = t(d)
    return dict(org=t(org), dirn=dirn, inv_d=tw._safe_inv(dirn),
                tmax=t(tmax), accel=acc,
                scale=tw.tn_scale_of(accel.cluster_lo, accel.cluster_hi))


@pytest.mark.cuda
def test_entries_cuda_matches_plain(cuda_device):
    rng = np.random.default_rng(3)
    n_tiles, n_c = 3, 200  # 200 clusters pad to 256 lanes
    n = n_tiles * tw.TILE
    org = rng.normal(size=(n, 3)) * 5.0
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.where(np.arange(n) % 7 == 0, -1.0, 30.0)
    lo = rng.uniform(-8, 6, size=(n_c, 3))
    hi = lo + rng.uniform(0.1, 2.0, size=(n_c, 3))
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda_device)
    scale = tw.tn_scale_of(lo, hi)
    args = (t(org), tw._safe_inv(t(d)), t(tm), t(lo), t(hi), scale)
    before = tw.entries_cuda.launches
    got = tw.entries_cuda(*args)
    assert tw.entries_cuda.launches == before + 1
    want = tw.entries_plain(*args)
    assert got.shape == (n_tiles, 256)
    assert torch.equal(got, want)
    assert bool((got != tw.INT32_MAX).any())


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "lean_any"])
def test_tileloop_cuda_matches_plain(wave, any_hit):
    w = wave
    acc = w["accel"]
    entry = tw.entries_cuda(w["org"], w["inv_d"], w["tmax"], acc.cluster_lo,
                            acc.cluster_hi, w["scale"])
    counts = (entry != tw.INT32_MAX).sum(dim=1, dtype=torch.int32)
    entry = torch.sort(entry, dim=1).values
    args = (w["org"], w["dirn"], w["inv_d"], w["tmax"], acc.tri_rows, entry,
            counts, w["scale"], any_hit)
    kt, ku, kv, ks = tw.tileloop_cuda(*args)
    pt, pu, pv, ps = tw.tileloop_plain(*args, exact_boxes=True)
    live = w["tmax"] >= 0
    same = live & (ks == ps)
    assert int(same.sum()) >= 0.9999 * int(live.sum())
    assert int((ps[live] >= 0).sum()) > 100  # the rays do hit the bunny
    rel = ((kt - pt).abs() / pt.abs().clamp_min(1e-30))[same]
    assert float(rel.max()) <= 1e-6


@pytest.mark.cuda
def test_render_on_cuda_matches_cpu(cuda_device):
    """The main path on the card launches both kernels, repeats bit for
    bit, and matches the CPU render (plain versions) of the same seed."""
    cfg = get_config("bunny", width=64, height=48, spp=2, spp_per_batch=2,
                     max_bounces=2)
    scene = bunny_standin(subdivisions=3)
    cpu, _ = render_scene(cfg, device="cpu", scene=scene)
    tw.reset_launch_counts()
    gpu, stats = render_scene(cfg, device=cuda_device, scene=scene)
    assert tw.entries_cuda.launches > 0 and tw.tileloop_cuda.launches > 0
    again, _ = render_scene(cfg, device=cuda_device, scene=scene)
    assert torch.equal(gpu.accum, again.accum)
    a = fb.resolve(gpu).cpu().numpy()
    b = fb.resolve(cpu).numpy()
    assert np.isfinite(a).all()
    assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-3
    assert stats["rays_traced"] > 0


def _k1_modes_accel(mode, device):
    """The accel of one tile-kernel mode on ``device``: the Cornell box
    (all-pairs), bunny_standin(5) flat with superclusters (214 clusters
    under 27 superclusters), sponza_standin(8, 3) two-level, or the full
    sponza_standin() two-level with superclusters."""
    if mode in ("allpairs", "sc"):
        scene = (cornell_box(path_tracer=True) if mode == "allpairs"
                 else bunny_standin(subdivisions=5))
        accel = build_pair_accel(None, scene_meta(scene), scene=scene)
    else:
        scene = sponza_standin() if mode == "tl_sc" else sponza_standin(8, 3)
        accel = build_pair_accel_two_level(None, scene_meta(scene),
                                           scene=scene)
    return accel.to(device)


def _k1_modes_case(mode, device, n_tiles=3):
    """Seeded rays, tables and sorted entries for one K1 mode: all-pairs
    on the Cornell box, flat with supercluster entries on
    bunny_standin(5), two-level on sponza_standin(8, 3), two-level with
    supercluster entries on the full sponza_standin()."""
    rng = np.random.default_rng(11)
    n = n_tiles * tw.TILE
    acc = _k1_modes_accel(mode, device)
    lo = acc.cluster_lo.amin(0).cpu().numpy()
    hi = acc.cluster_hi.amax(0).cpu().numpy()
    org = lo + rng.uniform(size=(n, 3)) * (hi - lo)
    d = lo + rng.uniform(size=(n, 3)) * (hi - lo) - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    diag = float(np.linalg.norm(hi - lo))
    tmax = np.where(np.arange(n) % 9 == 0, -1.0,
                    rng.uniform(0.05, 0.5, n) * diag)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
    org, dirn, tmax = t(org), t(d), t(tmax)
    inv_d = tw._safe_inv(dirn)
    tl = {}
    if mode == "allpairs":
        n_c = acc.cluster_lo.shape[0]
        entry = torch.arange(n_c, dtype=torch.int32, device=device)
        entry = entry[None].expand(n_tiles, n_c).contiguous()
        counts = torch.full((n_tiles,), n_c, dtype=torch.int32,
                            device=device)
        return (org, dirn, inv_d, tmax, acc.tri_rows, entry, counts, 0.0), tl
    tl = ({} if mode == "sc"
          else dict(pair_meta=acc.pair_meta, inv_xform=acc.inv_xform))
    lo_e, hi_e = acc.cluster_lo, acc.cluster_hi
    if mode in ("sc", "tl_sc"):
        lo_e, hi_e = acc.sc_lo, acc.sc_hi
        tl["sc_meta"] = acc.sc_meta
    scale = tw.tn_scale_of(lo_e.cpu().numpy(), hi_e.cpu().numpy())
    entry = tw.entries_cuda(org, inv_d, tmax, lo_e, hi_e, scale)
    counts = (entry != tw.INT32_MAX).sum(dim=1, dtype=torch.int32)
    entry = torch.sort(entry, dim=1).values
    return (org, dirn, inv_d, tmax, acc.tri_rows, entry, counts, scale), tl


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["allpairs", "sc", "tl", "tl_sc"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "lean_any"])
def test_tileloop_cuda_modes_match_plain(cuda_device, mode, any_hit):
    """K1's all-pairs, flat + supercluster, two-level and two-level +
    supercluster modes against the plain version's exact walk: slots,
    and instances where the slot agrees; each mode counts under its own
    launch name."""
    args, tl = _k1_modes_case(mode, cuda_device)
    tw.reset_launch_counts()
    k = tw.tileloop_cuda(*args, any_hit, **tl)
    assert tw.launch_counts()[f"tileloop_{mode}"] == 1
    p = tw.tileloop_plain(*args, any_hit, exact_boxes=True, **tl)
    assert len(k) == len(p) == (5 if "pair_meta" in tl else 4)
    live = args[3] >= 0
    same = live & (k[3] == p[3])
    assert int(same.sum()) >= 0.9999 * int(live.sum())
    assert int((p[3][live] >= 0).sum()) > 100
    rel = ((k[0] - p[0]).abs() / p[0].abs().clamp_min(1e-30))[same]
    assert float(rel.max()) <= 1e-6
    if len(k) == 5:
        assert torch.equal(k[4][same], p[4][same])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["flat", "seg", "sc", "tl", "tl_sc"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "lean_any"])
def test_tileloop_cuda_edge_lists_match_plain(cuda_device, mode, any_hit):
    """K1 on entry lists at the edges of its ring (chip_smoke.edge_case:
    none, one, an odd count, a full row, a far break at a group start
    right after its rows were fetched ahead), cut from 8-tile waves, flat,
    as pair segments, flat with superclusters, two-level and two-level
    with superclusters: held to the plain
    version's exact walk and K1's bars by chip_smoke.check_k1_edges, which
    raises on a miss; the tile without entries keeps its start values,
    and the last tile's rays all end below the entry their break is cut
    at."""
    import chip_smoke

    if mode in ("flat", "seg"):
        w = _standin_wave(cuda_device, 8)
        acc = w["accel"]
        entry = tw.entries_cuda(w["org"], w["inv_d"], w["tmax"],
                                acc.cluster_lo, acc.cluster_hi, w["scale"])
        counts = (entry != tw.INT32_MAX).sum(dim=1, dtype=torch.int32)
        entry = torch.sort(entry, dim=1).values
        args = (w["org"], w["dirn"], w["inv_d"], w["tmax"], acc.tri_rows,
                entry, counts, w["scale"])
        tl = {}
    else:
        args, tl = _k1_modes_case(mode, cuda_device, n_tiles=8)
    org, dirn, inv_d, tmax, rows, entry, counts, scale = args
    chip_smoke.check_k1_edges(mode, (org, dirn, inv_d, tmax), rows, entry,
                              counts, scale, any_hit, seg=mode == "seg", **tl)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hello_triangle", "cornell"])
def test_all_pairs_render_on_cuda_matches_cpu(cuda_device, name):
    """The all-pairs presets at a small size: the card launches K1's
    all-pairs mode and matches the CPU render within RMSE 1e-3."""
    cfg = get_config(name, width=64, height=48, spp=4, spp_per_batch=4)
    cpu, _ = render_scene(cfg, device="cpu")
    tw.reset_launch_counts()
    gpu, _ = render_scene(cfg, device=cuda_device)
    assert tw.launch_counts()["tileloop_allpairs"] > 0
    a = fb.resolve(gpu).cpu().numpy()
    b = fb.resolve(cpu).numpy()
    assert np.isfinite(a).all()
    assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-3


@pytest.mark.cuda
def test_exact_mask_cuda_matches_plain(wave):
    """K3 against its plain version: mask and tn_min bit-equal."""
    w = wave
    acc = w["accel"]
    args = (w["org"], w["inv_d"], w["tmax"], acc.cluster_lo, acc.cluster_hi)
    before = tw.exact_mask_cuda.launches
    mask, tn = tw.exact_mask_cuda(*args)
    assert tw.exact_mask_cuda.launches == before + 1
    p_mask, p_tn = tw.exact_mask_plain(*args)
    assert mask.dtype == torch.bool and mask.shape == (3, 14)
    assert torch.equal(mask, p_mask) and torch.equal(tn, p_tn)
    assert bool(mask.any())


def _dead_ray_wave(kind, n_c, device):
    """Four tiles of seeded rays through ``n_c`` boxes with dead rays (tmax
    < 0) laid out as ``kind``: "sorted" (octant-sorted, so the dead rays
    form a tail from inside tile 1 on), "interleaved" (about half dead at
    random, a few tmax of -0.0, 0.0 and NaN among them), "tiles" (tiles 0
    and 3 dead, tile 2 with a live chunk, a third of a chunk dead, a dead
    chunk and a live one) or "all" (every ray dead)."""
    rng = np.random.default_rng(11)
    n = 4 * tw.TILE
    org = rng.normal(size=(n, 3)) * 5.0
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(5.0, 40.0, n)
    lo = rng.uniform(-8, 6, size=(n_c, 3))
    hi = lo + rng.uniform(0.1, 2.0, size=(n_c, 3))
    if kind == "sorted":
        tm[rng.permutation(n)[:int(n * 0.6)]] = -1.0
    elif kind == "interleaved":
        tm[rng.random(n) < 0.5] = -1.0
        tm[rng.permutation(n)[:9]] = [-0.0, -0.0, 0.0, 0.0, np.nan, np.nan,
                                      np.nan, -0.0, 0.0]
    elif kind == "tiles":
        tile = tm.reshape(4, 4, 256)  # (tile, chunk, ray)
        tile[0] = tile[3] = -1.0
        tile[2, 1, ::3] = -1.0
        tile[2, 2] = -1.0
    else:
        tm[:] = -1.0
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(device)
    org, dirn, tmax, lo, hi = t(org), t(d), t(tm), t(lo), t(hi)
    if kind == "sorted":
        keys = tw._octant_sort_keys(org, dirn, tmax, lo.amin(0), hi.amax(0))
        perm = torch.sort(keys, stable=True).indices
        org, dirn, tmax = (x[perm].contiguous() for x in (org, dirn, tmax))
    return org, tw._safe_inv(dirn), tmax, lo, hi


@pytest.mark.cuda
@pytest.mark.parametrize("n_c", [256, 107], ids=["lanes256", "padded107"])
@pytest.mark.parametrize("kind", ["sorted", "interleaved", "tiles", "all"])
def test_slab_kernels_test_live_rays_only(cuda_device, kind, n_c):
    """K2 and K3 compact each chunk to its live rays: their outputs stay
    equal to the plain versions, which test every ray, on waves with a
    dead tail, dead rays interleaved, dead tiles and chunks, and no live
    ray at all, over a multiple of 128 boxes and a padded count."""
    org, inv_d, tmax, lo, hi = _dead_ray_wave(kind, n_c, cuda_device)
    scale = tw.tn_scale_of(lo.cpu().numpy(), hi.cpu().numpy())
    live = tmax >= 0
    if kind == "sorted":  # the dead tail starts inside tile 1
        assert bool(live[:tw.TILE].all()) and not bool(live[-tw.TILE:].any())
    got = tw.entries_cuda(org, inv_d, tmax, lo, hi, scale)
    assert torch.equal(got, tw.entries_plain(org, inv_d, tmax, lo, hi,
                                             scale))
    mask, tn = tw.exact_mask_cuda(org, inv_d, tmax, lo, hi)
    p_mask, p_tn = tw.exact_mask_plain(org, inv_d, tmax, lo, hi)
    assert torch.equal(mask, p_mask) and torch.equal(tn, p_tn)
    # a tile with no live ray has no entry; every other wave has some
    dead_tile = ~live.reshape(4, tw.TILE).any(dim=1)
    assert not bool(mask[dead_tile].any())
    assert bool((got[dead_tile] == tw.INT32_MAX).all())
    assert bool(mask.any()) == (kind != "all")


@pytest.mark.cuda
def test_slab_ray_counts_count_live_rays_and_graph_replays(cuda_device):
    """K2 and K3 count each tile's 1024 slots and its live rays on the
    card: one launch counts the wave once, and a captured graph adds its
    wave on every replay (the capture itself counts nothing)."""
    org, inv_d, tmax, lo, hi = _dead_ray_wave("interleaved", 200,
                                              cuda_device)
    scale = tw.tn_scale_of(lo.cpu().numpy(), hi.cpu().numpy())
    one = (4 * tw.TILE, int((tmax >= 0).sum()))
    tw.reset_launch_counts()
    tw.entries_cuda(org, inv_d, tmax, lo, hi, scale)
    assert tw.slab_ray_counts() == {"entries": one, "exact_mask": (0, 0)}
    tw.exact_mask_cuda(org, inv_d, tmax, lo, hi)
    assert tw.slab_ray_counts() == {"entries": one, "exact_mask": one}
    tw.reset_launch_counts()
    assert tw.slab_ray_counts() == {"entries": (0, 0),
                                    "exact_mask": (0, 0)}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tw.entries_cuda(org, inv_d, tmax, lo, hi, scale)
    assert tw.slab_ray_counts()["entries"] == (0, 0)
    graph.replay()
    assert tw.slab_ray_counts()["entries"] == one
    graph.replay()
    assert tw.slab_ray_counts()["entries"] == (2 * one[0], 2 * one[1])
    assert torch.equal(out, tw.entries_plain(org, inv_d, tmax, lo, hi,
                                             scale))


@pytest.mark.cuda
def test_pair_test_cuda_matches_plain(cuda_device):
    """K6 against its plain version on a pair list of the bunny stand-in:
    all four outputs bit-equal, dead slots included."""
    scene = bunny_standin(subdivisions=3)
    acc = build_pair_accel(None, scene_meta(scene),
                           scene=scene).to(cuda_device)
    rng = np.random.default_rng(5)
    n = 3000
    center = ((acc.cluster_lo.amin(0) + acc.cluster_hi.amax(0)) / 2).cpu()
    org = center.numpy() + rng.normal(size=(n, 3)) * 4.5
    d = center.numpy() + rng.normal(size=(n, 3)) * 1.2 - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(n) % 9 == 0, -1.0, 3.4e38)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda_device)
    org, d, tmax = t(org), t(d), t(tmax)
    pr, pc, cmin, _, n_pairs, over = pw._cull_expand(
        org, d, tmax, acc.cluster_lo, acc.cluster_hi,
        n_clusters=acc.cluster_lo.shape[0], pair_cap=8 * 3072)
    assert int(n_pairs) > n and not bool(over)
    args = (pr, pc, cmin, org, d, tmax, acc.tri_rows)
    got = pw.pair_test_cuda(*args)
    want = pw.pair_test_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[3] >= 0).sum()) > 500 and bool((pr < 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("over", [dict(pairs_per_tile=4),
                                  dict(intersector="bvh_pair")],
                         ids=["budget", "pair"])
def test_budget_and_pair_renders_on_cuda_match_cpu(cuda_device, over):
    """The two budget paths on the card: the clamped bvh_tile render
    retries as on the CPU and launches K3; the bvh_pair render launches
    K6; both within RMSE 1e-3 of the CPU render."""
    cfg = get_config("bunny", width=64, height=48, spp=2, spp_per_batch=2,
                     max_bounces=2, **over)
    scene = bunny_standin(subdivisions=3)
    cpu, cpu_stats = render_scene(cfg, device="cpu", scene=scene)
    kernels.reset_launch_counts()
    gpu, stats = render_scene(cfg, device=cuda_device, scene=scene)
    counts = kernels.launch_counts()
    assert stats["budget_retries"] == cpu_stats["budget_retries"]
    assert not stats["pair_overflow"]
    if "pairs_per_tile" in over:
        assert stats["budget_retries"] > 0
        assert counts["exact_mask"] > 0 and counts["tileloop"] > 0
    else:
        assert counts["pair"] > 0
    a = fb.resolve(gpu).cpu().numpy()
    b = fb.resolve(cpu).numpy()
    assert np.isfinite(a).all()
    assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_packet_cuda_matches_plain(cuda_device, any_hit):
    """K5 against its plain version on the bunny stand-in's packet BVH
    (its nodes packed by packet_tables): all four outputs and the group
    counters bit-equal (each ray's own walk, the plain version's descent
    rule and op order, the warp's shared row tests folding as the plain
    version's first minimum)."""
    from tpurt_torch.bvh.cluster import build_packet_accel
    from tpurt_torch.kernels import packet as pk

    scene = bunny_standin(subdivisions=3)
    acc = build_packet_accel(None, scene_meta(scene),
                             scene=scene).to(cuda_device)
    rng = np.random.default_rng(13)
    n = 2 * pk.PACKET
    center = np.array([float(acc.node_bminx[0] + acc.node_bmaxx[0]),
                       float(acc.node_bminy[0] + acc.node_bmaxy[0]),
                       float(acc.node_bminz[0] + acc.node_bmaxz[0])]) / 2
    org = center + rng.normal(size=(n, 3)) * 4.5
    d = center + rng.normal(size=(n, 3)) * 1.2 - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(n) % 7 == 0, -1.0,
                    rng.uniform(2.0, 6.0, n) if any_hit else 3.4e38)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda_device)
    args = (pk.packet_tables(acc), t(org), t(d), t(tmax), any_hit)
    before = pk.packet_cuda.launches
    got = pk.packet_cuda(*args)
    assert pk.packet_cuda.launches == before + 1
    want = pk.packet_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[4].shape == (2, 2) and bool((got[4] > 0).all())
    assert int((got[3] >= 0).sum()) > 300


def _hold_to_k1_bars(k, p, tmax):
    live = tmax >= 0
    same = live & (k[3] == p[3])
    assert int(same.sum()) >= 0.9999 * int(live.sum())
    assert int((p[3][live] >= 0).sum()) > 100
    rel = ((k[0] - p[0]).abs() / p[0].abs().clamp_min(1e-30))[same]
    assert float(rel.max()) <= 1e-6
    if len(k) == 5:
        assert torch.equal(k[4][same], p[4][same])


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "lean_any"])
def test_tileloop_seg_cuda_matches_plain(wave, any_hit):
    """K1's pair-segment mode against its plain version, and against the
    entry-row launch over the same entries (bit-equal: one kernel body,
    the same entries in the same order)."""
    w = wave
    acc = w["accel"]
    rays = (w["org"], w["dirn"], w["inv_d"], w["tmax"])
    off, pair_cl, n_pairs, over = tw._segment_lists(
        *rays, acc.cluster_lo, acc.cluster_hi, w["scale"], exact=True,
        pairs_per_tile=0, pcap=3 * 14)
    assert not bool(over) and int(n_pairs) == int(off[-1]) > 0
    args = (*rays, acc.tri_rows, off, pair_cl, w["scale"], any_hit)
    tw.reset_launch_counts()
    k = tw.tileloop_seg_cuda(*args)
    assert tw.launch_counts()["tileloop_seg"] == 1
    p = tw.tileloop_seg_plain(*args, exact_boxes=True)
    _hold_to_k1_bars(k, p, w["tmax"])
    entry, counts = tw._segments_to_rows(off, pair_cl)
    rows = tw.tileloop_cuda(*rays, acc.tri_rows, entry, counts, w["scale"],
                            any_hit)
    for a, b in zip(k, rows):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["flat", "tl", "allpairs"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_tilegrid_cuda_matches_plain(cuda_device, wave, mode, any_hit):
    """K4 against its plain version's exact walk on the pair lists the
    grid path builds (interval mask, sentinels; every pair for
    all-pairs): closest bit-equal in every output (K1's walk over the
    tile's real pairs at distance 0, which prunes as the exact walk
    does), the occlusion flag equal on any-hit waves; each mode counts
    under its own launch name."""
    if mode == "flat":
        w = wave
        rays = (w["org"], w["dirn"], w["inv_d"], w["tmax"])
        acc, tl = w["accel"], {}
    else:
        args, tl = _k1_modes_case(mode, cuda_device)
        rays = args[:4]
        acc = _k1_modes_accel(mode, cuda_device)
    n_c = acc.cluster_lo.shape[0]
    all_pairs = mode == "allpairs"
    packed, n_pairs, over = tw._grid_list(
        rays[0], rays[1], rays[3], acc.cluster_lo, acc.cluster_hi,
        n_clusters=n_c, pair_cap=3 * (n_c + 1), per_tile_clamp=n_c + 1,
        all_pairs=all_pairs)
    assert not bool(over)
    args = (*rays, acc.tri_rows, packed, any_hit)
    tw.reset_launch_counts()
    k = tw.tilegrid_cuda(*args, all_pairs=all_pairs, **tl)
    name = "tilegrid" + ("_tl" if tl else "") + ("_allpairs" if all_pairs
                                                 else "")
    assert tw.launch_counts()[name] == 1
    p = tw.tilegrid_plain(*args, exact_boxes=True, **tl)
    assert len(k) == len(p) == (5 if tl else 4)
    assert bool((p[3] >= 0).any())
    if any_hit:
        assert torch.equal(k[3] >= 0, p[3] >= 0)
    else:
        for a, b in zip(k, p):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("env,over,kernel", [
    ({}, dict(intersector="bvh_packet"), "packet"),
    (dict(TPURT_ENTRY_ROWS="0"), {}, "tileloop_seg"),
    (dict(TPURT_PAIR_LOOP="0"), {}, "tilegrid"),
    (dict(TPURT_SUPERCLUSTER="1"), {}, "tileloop_sc"),
    (dict(TPURT_FUSED_ENTRIES="0"), {}, "exact_mask"),
    (dict(TPURT_EXACT_MASK="0"), {}, "tileloop")],
    ids=["bvh_packet", "segments", "grid", "superclusters", "unfused",
         "interval_mask"])
def test_new_paths_render_on_cuda_match_cpu(cuda_device, monkeypatch, env,
                                            over, kernel):
    """The bvh_packet intersector and the tile intersector's switches on
    the card: each launches its kernel, ends without overflow and stays
    within RMSE 1e-3 of the CPU render."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = get_config("bunny", width=64, height=48, spp=2, spp_per_batch=2,
                     max_bounces=2, **over)
    scene = bunny_standin(subdivisions=3)
    cpu, _ = render_scene(cfg, device="cpu", scene=scene)
    kernels.reset_launch_counts()
    gpu, stats = render_scene(cfg, device=cuda_device, scene=scene)
    assert kernels.launch_counts()[kernel] > 0
    assert not stats["pair_overflow"]
    a = fb.resolve(gpu).cpu().numpy()
    b = fb.resolve(cpu).numpy()
    assert np.isfinite(a).all()
    assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["flat", "tl"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_tilegrid_cuda_edge_lists_match_plain(cuda_device, mode, any_hit):
    """K4 on pair lists at the edges of K1's ring
    (chip_smoke.grid_edge_case: no pairs, one, an odd count, the longest
    list, and a list whose slices vote themselves done right after a
    fetch ahead), cut from 8-tile grid lists, flat and two-level: held
    to the plain version's exact walk by chip_smoke.check_k4_edges, which
    raises on a miss."""
    import chip_smoke

    if mode == "flat":
        w = _standin_wave(cuda_device, 8)
        rays = (w["org"], w["dirn"], w["inv_d"], w["tmax"])
        acc, tl = w["accel"], {}
    else:
        args, tl = _k1_modes_case(mode, cuda_device, n_tiles=8)
        rays = args[:4]
        acc = _k1_modes_accel(mode, cuda_device)
    n_c = acc.cluster_lo.shape[0]
    packed, _, over = tw._grid_list(
        rays[0], rays[1], rays[3], acc.cluster_lo, acc.cluster_hi,
        n_clusters=n_c, pair_cap=8 * (n_c + 1), per_tile_clamp=n_c + 1)
    assert not bool(over)
    chip_smoke.check_k4_edges(mode, rays, acc.tri_rows, packed, any_hit,
                              **tl)


@pytest.mark.cuda
def test_cutout_twin_on_cuda(cuda_device, monkeypatch):
    """The cut-out fence over bunny_standin(3) against its geometric twin
    on the card, 160×120 × 2 spp, through bvh_tile (the shade-record
    alpha probe) and bvh_packet (the per-field probe): RMSE ≤ 1e-3, as
    chip_smoke.cutout_twin_check holds them (it raises on a miss). Its
    graphs keep their ``cudaGraph_t`` (as chip_smoke's ``keep_graphs``
    makes them), which the check's graph node count reads."""
    import chip_smoke

    made = torch.cuda.CUDAGraph
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda *a, **k: made(*a, keep_graph=True, **k))
    out = chip_smoke.cutout_twin_check(cuda_device, 160, 120, 2,
                                       subdivisions=3)
    assert out["bvh_tile"][2]["tileloop"] > 0
    assert out["bvh_packet"][2]["packet"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("over,launched", [
    (dict(pipeline="mega"), ("entries", "tileloop")),
    (dict(pipeline="wavefront"), ("entries", "tileloop")),
    (dict(sorted_wave=True), ("entries", "tileloop")),
    (dict(pipeline="mega", intersector="bvh"), ())],
    ids=["mega", "wavefront", "sorted", "bvh"])
def test_alternate_paths_render_on_cuda_match_cpu(cuda_device, over,
                                                  launched):
    """The megakernel, the wavefront loop, the sorted-wave loop and the
    two-level LBVH on the card: the tile paths launch K2 and K1, the
    LBVH walk (plain torch) launches no kernel; each repeats bit for bit
    and stays within RMSE 1e-3 of the CPU render."""
    cfg = get_config("bunny", width=64, height=48, spp=2, spp_per_batch=2,
                     max_bounces=2, **over)
    scene = bunny_standin(subdivisions=3)
    cpu, _ = render_scene(cfg, device="cpu", scene=scene)
    kernels.reset_launch_counts()
    gpu, stats = render_scene(cfg, device=cuda_device, scene=scene)
    counts = kernels.launch_counts()
    for k in launched:
        assert counts[k] > 0, k
    if not launched:
        assert not any(counts.values())
    again, _ = render_scene(cfg, device=cuda_device, scene=scene)
    assert torch.equal(gpu.accum, again.accum)
    a = fb.resolve(gpu).cpu().numpy()
    b = fb.resolve(cpu).numpy()
    assert np.isfinite(a).all()
    assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-3
    assert not stats["pair_overflow"] and not stats["live_overflow"]


@pytest.mark.cuda
def test_wave_modes_counted_on_graph_replays(cuda_device, monkeypatch):
    """A stage graph runs no Python on replay: it adds the waves its
    capture counted, by tile mode, as it adds its launches. Three
    batches replayed count three times the waves of one eager batch on
    the CPU (supercluster entry rows under TPURT_SUPERCLUSTER=1)."""
    monkeypatch.setenv("TPURT_SUPERCLUSTER", "1")
    cfg = get_config("bunny", width=160, height=120, spp=1,
                     spp_per_batch=1, max_bounces=2)
    scene = bunny_standin(subdivisions=3)
    tw.reset_wave_mode_counts()
    render_scene(cfg, device="cpu", scene=scene)
    one = tw.wave_mode_counts()
    assert set(one) == {"sc_rows"} and one["sc_rows"] >= 3
    render_scene(cfg, device=cuda_device, scene=scene)  # captures
    tw.reset_wave_mode_counts()
    cfg3 = get_config("bunny", width=160, height=120, spp=3,
                      spp_per_batch=1, max_bounces=2)
    render_scene(cfg3, device=cuda_device, scene=scene)
    assert tw.wave_mode_counts() == {"sc_rows": 3 * one["sc_rows"]}
