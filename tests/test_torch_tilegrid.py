"""The grid over (tile, cluster) pairs, K4 (``TPURT_PAIR_LOOP=0``), in
tpurt_torch against tpurt.

The host side — interval mask, per-tile clamp in cluster order, capacity
cut, the sentinel merge, fill slots, the all-pairs list — is held to the
reference's pair lists exactly (its launcher is replaced by a recorder, so
no kernel runs); the plain kernel version to the reference's kernel in
interpret mode on the same lists (flat, two-level and all-pairs; closest
and any-hit); the renders to the port's entry-row and all-pairs renders.

Tolerances (tests/pairlist_cases.py): lists, pair counts, overflow flags,
slots, instances and occlusion exact; t within 1e-6 relative plus 1e-6 of
the scene diagonal, barycentrics within 1e-4 absolute (2.5e-4 two-level),
because XLA:CPU contracts Möller–Trumbore's multiply-adds; renders within
RMSE 1e-3 (tests/test_torch_render.py), since the grid walks the interval
mask's clusters in cluster order with no far break, where an exact-t tie
may take the other triangle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.pairlist_cases import (compare, count_modes, entry_row_render,
                                  kernel_case, recorder, ref_stats, setup,
                                  tl_tables, wave)
from tpurt.kernels import tilewave as ref_tw
from tpurt_torch.kernels import tilewave as tw
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render import render_scene
from tpurt_torch.utils.config import get_config

# One intra-op thread: the suite runs in several worker processes on a few
# cores (tests/test_torch_render.py).
torch.set_num_threads(1)


@pytest.mark.parametrize("name,k,avg", [("bunny", 0, 6), ("bunny", 4, 4),
                                        ("cornell", 0, 0)],
                         ids=["cut", "clamp", "allpairs"])
def test_grid_lists_match_reference(monkeypatch, name, k, avg):
    """The grid host side: the interval mask on three tiles, the clamp in
    cluster order (k = 4: flagged), the capacity cut (6 pairs a tile with
    the sentinel, no clamp: flagged), one sentinel per tile, fill slots;
    all-pairs on the Cornell box. The packed list, the pair count and
    the flag equal the reference's."""
    s = setup(name)
    org, d, tmv = wave(name, 3, False, False)
    n_tiles, n_c = 3, s["lo"].shape[0]
    all_pairs = name == "cornell"
    clamp = n_c + 1 if k <= 0 else min(k, n_c + 1)
    cap = n_tiles * (n_c if all_pairs else avg)
    ref_calls, port_calls = [], []
    monkeypatch.setattr(ref_tw, "_launch_tiles",
                        recorder(ref_calls, 4, ref_stats))
    monkeypatch.setattr(tw, "tilegrid", recorder(port_calls, 4, None))
    ref_tw._trace_tiles(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmv),
        jnp.asarray(s["lo"]), jnp.asarray(s["hi"]),
        jnp.asarray(s["r_acc"].tri_rows), n_clusters=n_c, pair_cap=cap,
        per_tile_clamp=clamp, interpret=True, all_pairs=all_pairs)
    t = torch.from_numpy
    acc = s["p_acc"]
    _, n_pairs, overflow = tw._trace_grid(
        t(org), t(d), t(tmv), acc.cluster_lo, acc.cluster_hi, acc.tri_rows,
        n_tiles, n_clusters=n_c, pair_cap=cap, per_tile_clamp=clamp,
        any_hit=False, tl={}, all_pairs=all_pairs)
    (w_packed, *_), w_kw = ref_calls[0]
    (_, _, _, _, _, g_packed, _), g_kw = port_calls[0]
    np.testing.assert_array_equal(g_packed.numpy(), np.asarray(w_packed))
    assert g_packed.shape[0] == cap
    assert g_kw["all_pairs"] is all_pairs
    assert float(n_pairs) == float(w_kw["n_pairs"])
    assert bool(overflow) == bool(w_kw["overflow"]) == (not all_pairs)


def kernel_pair_bounds(packed, tile):
    """csrc/tileloop.cu's search for a tile's real pairs in K4's list
    (``pair_key``, ``pair_bounds``: a warp's 32 probes a round), step for
    step: (lo, hi)."""
    words = packed.tolist()

    def key(p):
        tile_p, kind = words[p] >> 16, 1
        if words[p] & 0xFFFF == 0:
            kind = 2 if p > 0 and words[p - 1] >> 16 == tile_p else 0
        return tile_p * 4 + kind

    def search(k):
        lo, hi = 0, len(words)
        while lo < hi:
            step = (hi - lo + 31) // 32
            q = [lo + (lane + 1) * step - 1 for lane in range(32)]
            ge = [p >= hi or key(p) >= k for p in q]
            if not any(ge):
                return hi
            j = ge.index(True)
            lo, hi = lo + j * step, min(hi, q[j])
        return lo

    return search(tile * 4 + 1), search(tile * 4 + 2)


@pytest.mark.parametrize("name,avg,chunk", [("bunny", 6, 3), ("bunny", 64, 2),
                                            ("cornell", 0, 3), ("edge", 0, 3)],
                         ids=["cut", "chunks", "allpairs", "edge"])
def test_kernel_pair_search_finds_the_grid_rows(name, avg, chunk):
    """The segment each K4 block finds in the pair list by binary search
    holds exactly the entries of ``grid_rows``, tile by tile: the
    sentinels and the fill slots left out, on a cut list, on lists of
    several launch chunks laid end to end (fill slots in mid-list), on
    the all-pairs list (neither) and on a list whose tiles hold no pair
    (a sentinel alone, a sentinel then fill slots)."""
    if name == "edge":
        packed = torch.tensor([0, 65536, 65536 + 3, 65536 + 5, 2 * 65536]
                              + [2 * 65536] * 3, dtype=torch.int32)
    else:
        s = setup(name)
        org, d, tmv = wave(name, 3, False, False)
        n_c = s["lo"].shape[0]
        all_pairs = name == "cornell"
        t = torch.from_numpy
        (_, _, packed), = tw._wave_grid_lists(
            t(org), t(d), t(tmv), t(s["lo"]), t(s["hi"]), chunk,
            n_clusters=n_c, pair_cap=chunk * (n_c if all_pairs else avg),
            per_tile_clamp=n_c + 1, all_pairs=all_pairs)[0]
    entries, counts = tw.grid_rows(packed, 3)
    for tile in range(3):
        lo, hi = kernel_pair_bounds(packed, tile)
        assert hi - lo == int(counts[tile])
        got = (packed[lo:hi] & 0xFFFF) - 1
        assert torch.equal(got, entries[tile, :hi - lo])
        assert bool((packed[lo:hi] >> 16 == tile).all())
    assert int(counts.sum()) > 0
    # what there was to skip: a sentinel a tile, and fill slots where the
    # chunks' pairs left room
    skipped = int(((packed & 0xFFFF) == 0).sum())
    assert skipped == (0 if name == "cornell" else 3 if avg == 6 else
                       packed.numel() - int(counts.sum()))
    if avg == 64:
        assert skipped > 3
    if name == "edge":
        assert counts.tolist() == [0, 2, 0]


@pytest.mark.parametrize("name,any_hit,smem", [("bunny", False, True),
                                               ("bunny", True, False),
                                               ("sponza_small", False, False),
                                               ("cornell", False, False)],
                         ids=["flat-closest", "flat-any", "tl-closest",
                              "allpairs-closest"])
def test_grid_kernel_matches_pallas(monkeypatch, name, any_hit, smem):
    """K4's plain version against the reference kernel on the same pair
    list of one tile (interval mask, clamp 3: a sentinel and at most 2
    clusters; every cluster on the Cornell box). The flat closest case
    runs the reference's SMEM body (``TPURT_SMEM_TRI=1``, the TPU default,
    whose row order the port's fold follows, so exact-t ties agree too);
    the others its interpret default, ~30 s of compile cheaper each, where
    ``compare`` holds an exact-t tie to the same t. Any-hit waves compare
    the occlusion flag, the only field an any-hit caller reads."""
    s, (org, d, tmv), lists, kw = kernel_case(name, 1, any_hit, 3, True,
                                              monkeypatch)
    if smem:
        monkeypatch.setenv("TPURT_SMEM_TRI", "1")
    packed = np.asarray(lists[0])
    r_acc, tl = s["r_acc"], tl_tables(s)
    want = ref_tw._launch_tiles(
        jnp.asarray(packed), jnp.asarray(org), jnp.asarray(d),
        jnp.asarray(tmv), jnp.asarray(r_acc.tri_rows), n_tiles=1,
        pair_cap=packed.shape[0], interpret=True, any_hit=any_hit,
        n_pairs=jnp.int32(0), overflow=jnp.zeros((), bool),
        pair_meta=(None if tl["pair_meta"] is None
                   else jnp.asarray(r_acc.pair_meta)),
        inv_xform=(None if tl["inv_xform"] is None
                   else jnp.asarray(r_acc.inv_xform)))
    want = want[:5] if tl["pair_meta"] is not None else want[:4]
    t = torch.from_numpy
    dd = t(d)
    got = tw.tilegrid_plain(t(org), dd, tw._safe_inv(dd), t(tmv),
                            s["p_acc"].tri_rows, t(packed.copy()), any_hit,
                            **tl)
    compare(s, got, want, tmv, any_hit,
            2.5e-4 if tl["pair_meta"] is not None else 1e-4)


@pytest.mark.parametrize("name,max_pairs", [("bunny", 96 * 1024),
                                            ("bunny", 30),
                                            ("sponza_small", 96 * 1024)],
                         ids=["bunny", "bunny-chunks", "sponza_small"])
def test_grid_render_matches_entry_rows(monkeypatch, name, max_pairs):
    """render_scene through the grid (flat and two-level) stays within
    RMSE 1e-3 of the entry-row render; every wave took the grid (one
    launch a wave, whatever the number of launch chunks: at 30 pairs a
    launch every wave's chunks hold 2 tiles, as the 14-cluster stand-in
    caps the budget at 15 a tile); no overflow, no retry at the config's
    budgets."""
    cfg, scene, want = entry_row_render(name)
    ran = count_modes(monkeypatch)
    monkeypatch.setattr(tw, "MAX_PAIRS_PER_LAUNCH", max_pairs)
    monkeypatch.setenv("TPURT_PAIR_LOOP", "0")
    state, stats = render_scene(cfg, device="cpu", scene=scene)
    assert not stats["pair_overflow"] and stats["budget_retries"] == 0
    assert ran == {"seg": 0, "grid": 6, "rows": 0}
    a, b = fb.resolve(state).numpy(), fb.resolve(want).numpy()
    assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-3


def test_cornell_grid_render(monkeypatch):
    """The Cornell box (all-pairs) through K4's all-pairs list stays
    within RMSE 1e-3 of its all-pairs K1 render."""
    cfg = get_config("cornell", width=32, height=32, spp=2, spp_per_batch=2)
    want, _ = render_scene(cfg, device="cpu")
    monkeypatch.setenv("TPURT_PAIR_LOOP", "0")
    got, stats = render_scene(cfg, device="cpu")
    assert not stats["pair_overflow"]
    a, b = fb.resolve(got).numpy(), fb.resolve(want).numpy()
    assert np.isfinite(a).all() and a.mean() > 0.01
    assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-3
