"""K1's pair-segment mode (``TPURT_ENTRY_ROWS=0``) in tpurt_torch against
tpurt: the tile intersector past its entry-row gate.

The host side — mask, per-tile clamp, capacity cut, segment offsets — is
held to the reference's lists exactly (its launcher is replaced by a
recorder, so no kernel runs); the plain kernel version to the reference's
kernel in interpret mode on the same lists (flat and two-level, closest
and lean any-hit); the renders to the port's entry-row render.

Tolerances (tests/pairlist_cases.py): offsets, lists, pair counts,
overflow flags, slots, instances and occlusion exact; t within 1e-6
relative plus 1e-6 of the scene diagonal, barycentrics within 1e-4
absolute (2.5e-4 two-level), because XLA:CPU contracts Möller–Trumbore's
multiply-adds; renders bit-equal, since the segments hold the entry rows'
entries in the same order and one kernel body walks both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.pairlist_cases import (SMALL, compare, count_modes,
                                  entry_row_render, kernel_case, recorder,
                                  ref_stats, setup, tl_tables, wave)
from tpurt.kernels import tilewave as ref_tw
from tpurt_torch.kernels import tilewave as tw
from tpurt_torch.render import render_scene
from tpurt_torch.utils.config import get_config

# One intra-op thread: the suite runs in several worker processes on a few
# cores (tests/test_torch_render.py).
torch.set_num_threads(1)


@pytest.mark.parametrize("k,pcap_per_tile", [(0, 5), (4, 14)],
                         ids=["cut", "clamp"])
@pytest.mark.parametrize("sort", [False, True], ids=["interval", "exact"])
def test_segment_lists_match_reference(monkeypatch, sort, k, pcap_per_tile):
    """The pair-segment host side on three bunny tiles: interval mask
    (primary) or K3 (sorted), the per-tile clamp (k = 4 keeps 3 clusters a
    tile, flagged), front-to-back order per tile, the list cut at pcap
    (5 a tile without a clamp: cut, flagged). Offsets, the list, the pair
    count and the overflow flag equal the reference's."""
    monkeypatch.setenv("TPURT_ENTRY_ROWS", "0")
    s = setup("bunny")
    org, d, tmv = wave("bunny", 3, sort, False)
    n_tiles, n_c = 3, s["lo"].shape[0]
    pcap = n_tiles * pcap_per_tile
    ref_calls, port_calls = [], []
    monkeypatch.setattr(ref_tw, "_launch_tiles_loop",
                        recorder(ref_calls, 4, ref_stats))
    monkeypatch.setattr(tw, "tileloop_seg", recorder(port_calls, 4, None))
    ref_tw._trace_tiles_loop(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmv),
        jnp.asarray(s["lo"]), jnp.asarray(s["hi"]),
        jnp.asarray(s["r_acc"].tri_rows), n_clusters=n_c, pcap=pcap,
        per_tile_clamp=k, interpret=True, any_hit=False, exact_ok=sort)
    t = torch.from_numpy
    acc = s["p_acc"]
    _, n_pairs, overflow = tw._trace_segments(
        t(org), t(d), t(tmv), acc.cluster_lo, acc.cluster_hi, acc.tri_rows,
        tw.tn_scale_of(s["lo"], s["hi"]), n_tiles, any_hit=False,
        exact=sort, tl={}, pairs_per_tile=k, pcap=pcap)
    (w_off, w_pcl, *_), w_kw = ref_calls[0]
    (_, _, _, _, _, g_off, g_pcl, g_scale, _), _ = port_calls[0]
    w_off, w_pcl = np.asarray(w_off), np.asarray(w_pcl)
    np.testing.assert_array_equal(g_off.numpy(), w_off)
    total = int(w_off[-1])
    assert g_pcl.shape[0] == total and 0 < total <= pcap
    np.testing.assert_array_equal(g_pcl.numpy(), w_pcl[:total])
    assert float(n_pairs) == float(w_kw["n_pairs"])
    assert bool(overflow) == bool(w_kw["overflow"]) is True
    assert g_scale == pytest.approx(float(w_kw["tn_scale"]), rel=1e-7)


@pytest.mark.parametrize("name,any_hit", [("bunny", False), ("bunny", True),
                                          ("sponza_small", False)],
                         ids=["flat-closest", "flat-lean_any", "tl-closest"])
def test_segment_kernel_matches_pallas(monkeypatch, name, any_hit):
    """K1's pair-segment plain version against the reference kernel on
    the same off/pair_cl of one tile (interval mask, clamp 3: at most 2
    entries, front to back), the reference in its interpret default body:
    ``compare`` holds an exact-t tie to the same t. The SMEM body's row
    order (``TPURT_SMEM_TRI=1``, ~30 s of interpret compile a variant) is
    pinned for K1 on entry rows (tests/test_torch_tilewave.py) and for K4
    (tests/test_torch_tilegrid.py); the segment mode runs K1's body on
    the same entries, bit-equal to the entry-row launch on the card
    (tests/test_torch_cuda.py)."""
    s, (org, d, tmv), lists, kw = kernel_case(name, 1, any_hit, 3, False,
                                              monkeypatch)
    off, pair_cl = np.asarray(lists[0]), np.asarray(lists[1])
    assert off[-1] == 2
    r_acc, tl = s["r_acc"], tl_tables(s)
    want = ref_tw._launch_tiles_loop(
        jnp.asarray(off), jnp.asarray(pair_cl), jnp.asarray(org),
        jnp.asarray(d), jnp.asarray(tmv), jnp.asarray(r_acc.tri_rows),
        n_tiles=1, interpret=True, any_hit=any_hit,
        n_pairs=jnp.int32(0), overflow=jnp.zeros((), bool),
        pair_meta=(None if tl["pair_meta"] is None
                   else jnp.asarray(r_acc.pair_meta)),
        inv_xform=(None if tl["inv_xform"] is None
                   else jnp.asarray(r_acc.inv_xform)),
        tn_scale=kw["tn_scale"])
    want = want[:5] if tl["pair_meta"] is not None else want[:4]
    t = torch.from_numpy
    dd = t(d)
    got = tw.tileloop_seg_plain(
        t(org), dd, tw._safe_inv(dd), t(tmv), s["p_acc"].tri_rows,
        t(off.copy()), t(pair_cl[:off[-1]].copy()), float(kw["tn_scale"]),
        any_hit, **tl)
    compare(s, got, want, tmv, any_hit,
            2.5e-4 if tl["pair_meta"] is not None else 1e-4)


def test_entry_row_gate(monkeypatch):
    """The reference's mode rule: forced by TPURT_ENTRY_ROWS, else entry
    rows up to 4096 clusters while the (T + 8) × Cp slab fits 48 MB."""
    assert tw._entry_rows_enabled(854, 3750)  # the bunny bounce wave
    assert not tw._entry_rows_enabled(4097, 1)
    cp = tw._padded_lanes(2430)
    fit = tw.ENTRY_VMEM_BYTES // (cp * 4) - tw.ENTRY_GROUP
    assert tw._entry_rows_enabled(2430, fit)
    assert not tw._entry_rows_enabled(2430, fit + 1)
    for v, want in (("0", False), ("1", True)):
        monkeypatch.setenv("TPURT_ENTRY_ROWS", v)
        assert tw._entry_rows_enabled(854, 1) is want
        assert tw._entry_rows_enabled(5000, 10 ** 6) is want


@pytest.mark.parametrize("name,chunk", [("bunny", 256), ("bunny", 2),
                                        ("sponza_small", 256)],
                         ids=["bunny", "bunny-chunks", "sponza_small"])
def test_segment_render_matches_entry_rows(monkeypatch, name, chunk):
    """render_scene through pair segments (flat and two-level) equals the
    entry-row render bit for bit; every wave took the segment mode (one
    launch a wave, whatever the number of launch chunks: 2-tile chunks
    cut the 6-tile waves in three); no overflow, no retry."""
    cfg, scene, want = entry_row_render(name)
    ran = count_modes(monkeypatch)
    monkeypatch.setattr(tw, "TILES_PER_LAUNCH", chunk)
    monkeypatch.setenv("TPURT_ENTRY_ROWS", "0")
    state, stats = render_scene(cfg, device="cpu", scene=scene)
    assert not stats["pair_overflow"] and stats["budget_retries"] == 0
    assert ran == {"seg": 6, "grid": 0, "rows": 0}
    assert torch.equal(state.accum, want.accum)


def test_chunked_entry_rows_one_launch(monkeypatch):
    """A wave past the entry-row gate whose 2-tile launch chunks pass it
    takes entry rows, as in the reference, in one launch a wave (the
    6-tile waves are not cut in three); the image equals the entry-row
    render."""
    cfg, scene, want = entry_row_render("bunny")
    ran = count_modes(monkeypatch)
    monkeypatch.setattr(tw, "TILES_PER_LAUNCH", 2)
    monkeypatch.setattr(tw, "_entry_rows_enabled",
                        lambda n_clusters, n_tiles=0: n_tiles <= 2)
    state, stats = render_scene(cfg, device="cpu", scene=scene)
    assert not stats["pair_overflow"] and stats["budget_retries"] == 0
    assert ran == {"seg": 0, "grid": 0, "rows": 6}
    assert torch.equal(state.accum, want.accum)


def test_capacity_overflow_retries(monkeypatch):
    """Small pairs_avg* budgets overflow the pair-segment capacity; the
    render retries with doubled budgets until the lists fit and ends
    equal to the entry-row render."""
    cfg, scene, want = entry_row_render("bunny")
    monkeypatch.setenv("TPURT_ENTRY_ROWS", "0")
    state, stats = render_scene(
        get_config("bunny", **dict(SMALL, pairs_avg=4, pairs_avg_bounce=4,
                                   pairs_avg_shadow=4)),
        device="cpu", scene=scene)
    assert stats["budget_retries"] > 0 and not stats["pair_overflow"]
    assert torch.equal(state.accum, want.accum)
