"""``TPURT_EXACT_MASK`` and ``TPURT_FUSED_ENTRIES`` in tpurt_torch's tile
intersector, and every tile switch taking effect on a second render in
one process.

``TPURT_EXACT_MASK`` "0" (the interval mask on a sorted wave) and "all"
(exact entries on a primary wave) against the reference intersector per
ray after the restore, on the flat bunny stand-in. The reference runs in
interpret mode with its default kernel body (its SMEM body costs three
times as much there); the two bodies differ only in which row keeps an
exact-t tie (ROADMAP §3). Bars: validity and occlusion equal, t within
1e-6 relative plus 1e-6 of the scene diagonal, slots equal on ≥ 99% of
hits, barycentrics within 1e-4 where the slots are.

``TPURT_FUSED_ENTRIES=0`` builds the exact entry rows from the unpacked
mask (K3) and packs them in torch: the entry words K1 receives, and its
hits, must be bit-equal to K2's (``=1``), as the reference's
tests/unit/test_tilewave.py holds its two builds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh.paircluster import build_pair_accel as ref_build
from tpurt.kernels import tilewave as ref_tw
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene.device import to_device as ref_to_device
from tpurt.scene.procedural import bunny_standin as ref_bunny
from tpurt_torch import render as rd
from tpurt_torch.bvh.paircluster import build_pair_accel as port_build
from tpurt_torch.kernels import tilewave as tw
from tpurt_torch.render.intersectors import scene_meta as port_meta
from tpurt_torch.scene.device import to_device as port_to_device
from tpurt_torch.scene.procedural import bunny_standin as port_bunny
from tpurt_torch.utils.config import get_config


@pytest.fixture(scope="module")
def bunny():
    rs, ps = ref_bunny(subdivisions=3), port_bunny(subdivisions=3)
    r_ds, p_ds = ref_to_device(rs), port_to_device(ps, device="cpu")
    r_acc = ref_build(r_ds, ref_meta(rs), scene=rs)
    p_acc = port_build(p_ds, port_meta(ps), scene=ps).to("cpu")
    lo, hi = r_acc.cluster_lo.min(0), r_acc.cluster_hi.max(0)
    rng = np.random.default_rng(9)
    n = 1000  # not a tile multiple
    center, ext = (lo + hi) / 2, (hi - lo) / 2
    org = center + rng.normal(size=(n, 3)) * ext * 1.5
    d = center + rng.normal(size=(n, 3)) * ext * 0.3 - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    diag = float(np.linalg.norm(hi - lo))
    f32 = lambda x: np.asarray(x, np.float32)
    wave = (f32(org), f32(d),
            f32(np.where(np.arange(n) % 7 == 0, -1.0, np.inf)),
            f32(np.where(np.arange(n) % 5 == 0, -1.0, 0.2 * diag)))
    return dict(scene=ps, r_ds=r_ds, r_acc=r_acc, p_ds=p_ds, p_acc=p_acc,
                diag=diag, wave=wave)


@pytest.fixture
def calls(monkeypatch):
    """The intersector's calls of K2, K3 and K1 (by entry kind), and the
    entry rows K1 was given."""
    seen = {"entries": 0, "exact_mask": 0, "sc": 0, "cluster": 0,
            "rows": []}

    def count(attr, key):
        fn = getattr(tw, attr)

        def counted(*args, **kw):
            seen[key] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(tw, attr, counted)

    count("exact_entries", "entries")  # K2
    count("exact_mask", "exact_mask")  # K3
    loop = tw.tileloop

    def k1(org, dirn, inv_d, tmax, tri_rows, entries, counts, *args,
           sc_meta=None, **kw):
        seen["sc" if sc_meta is not None else "cluster"] += 1
        seen["rows"].append((entries.clone(), counts.clone()))
        return loop(org, dirn, inv_d, tmax, tri_rows, entries, counts,
                    *args, sc_meta=sc_meta, **kw)

    monkeypatch.setattr(tw, "tileloop", k1)
    return seen


def _hold(bunny, got, want):
    valid = np.asarray(want.valid)
    assert valid.sum() > 200
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.t.numpy()[valid],
                               np.asarray(want.t)[valid], rtol=1e-6,
                               atol=1e-6 * bunny["diag"])
    same = got.slot.numpy()[valid] == np.asarray(want.slot)[valid]
    assert same.mean() >= 0.99, same.mean()
    for name in ("u", "v"):
        np.testing.assert_allclose(
            getattr(got, name).numpy()[valid][same],
            np.asarray(getattr(want, name))[valid][same], atol=1e-4)


@pytest.mark.parametrize("switch,sort", [("0", "octant"), ("all", "none")])
def test_exact_mask_switch_matches_reference(bunny, monkeypatch, calls,
                                             switch, sort):
    """"0": a sorted wave takes the interval mask (no K2, no K3); "all":
    a primary wave takes K2's exact entries."""
    monkeypatch.setenv("TPURT_EXACT_MASK", switch)
    org, d, tmax, shadow = bunny["wave"]
    r_closest, r_any = ref_tw.make_tile_intersector(
        bunny["r_ds"], bunny["r_acc"], interpret=True, ray_sort=sort,
        shadow_ray_sort=sort, lean=True)
    p_closest, p_any = tw.make_tile_intersector(
        bunny["p_ds"], bunny["p_acc"], ray_sort=sort, shadow_ray_sort=sort,
        lean=True)
    t, j = torch.from_numpy, jnp.asarray
    _hold(bunny, p_closest(t(org), t(d), 0.0, t(tmax)),
          r_closest(j(org), j(d), 0.0, j(tmax)))
    occ = p_any(t(org), t(d), 0.0, t(shadow)).numpy()
    np.testing.assert_array_equal(
        occ, np.asarray(r_any(j(org), j(d), 0.0, j(shadow))))
    assert 0 < occ.sum() < occ.shape[0]
    assert (calls["entries"], calls["exact_mask"]) == (
        (0, 0) if switch == "0" else (2, 0))
    assert calls["cluster"] == 2


@pytest.mark.parametrize("rows", ["1", "0"], ids=["entry_rows", "segments"])
def test_exact_mask_off_keeps_the_hits(bunny, monkeypatch, calls, rows):
    """The interval mask is conservative: "0" gives the default's hits on
    a sorted wave, through entry rows and through the pair segments
    (``TPURT_ENTRY_ROWS=0``), and runs neither K2 nor K3."""
    monkeypatch.setenv("TPURT_ENTRY_ROWS", rows)
    org, d, tmax, shadow = (torch.from_numpy(x) for x in bunny["wave"])
    out, seen = {}, {}
    for switch in ("1", "0"):
        monkeypatch.setenv("TPURT_EXACT_MASK", switch)
        closest, any_hit = tw.make_tile_intersector(
            bunny["p_ds"], bunny["p_acc"], ray_sort="octant", lean=True)
        before = (calls["entries"], calls["exact_mask"])
        out[switch] = (closest(org, d, 0.0, tmax),
                       any_hit(org, d, 0.0, shadow))
        seen[switch] = (calls["entries"] - before[0],
                        calls["exact_mask"] - before[1])
    exact = (2, 0) if rows == "1" else (0, 2)
    assert seen == {"1": exact, "0": (0, 0)}
    (a, occ_a), (b, occ_b) = out["1"], out["0"]
    assert torch.equal(occ_a, occ_b)
    for f in ("valid", "t", "slot"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("sc", ["0", "1"], ids=["clusters",
                                                "superclusters"])
def test_unfused_entries_bit_equal(bunny, monkeypatch, calls, sc):
    """``TPURT_FUSED_ENTRIES=0``: K3 and the torch packing give K1 the
    entry words K2 gives it, bit for bit, so every hit is the same."""
    monkeypatch.setenv("TPURT_SUPERCLUSTER", sc)
    org, d, tmax, shadow = (torch.from_numpy(x) for x in bunny["wave"])
    out, rows = {}, {}
    for fused in ("1", "0"):
        monkeypatch.setenv("TPURT_FUSED_ENTRIES", fused)
        closest, any_hit = tw.make_tile_intersector(
            bunny["p_ds"], bunny["p_acc"], ray_sort="octant", lean=True)
        calls["rows"].clear()
        out[fused] = (closest(org, d, 0.0, tmax),
                      any_hit(org, d, 0.0, shadow))
        rows[fused] = list(calls["rows"])
    assert (calls["entries"], calls["exact_mask"]) == (2, 2)
    assert calls["sc" if sc == "1" else "cluster"] == 4
    for (e1, c1), (e0, c0) in zip(rows["1"], rows["0"]):
        assert e1.dtype == e0.dtype == torch.int32
        assert torch.equal(e1, e0) and torch.equal(c1, c0)
        assert int(c1.sum()) > 0
    (a, occ_a), (b, occ_b) = out["1"], out["0"]
    assert torch.equal(occ_a, occ_b)
    for f in ("valid", "t", "u", "v", "slot"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# each switch against the default, and what K2, K3 and K1 must show
# across one render of 64×48 × 1 spp (2 bounces: 3 closest and 3 shadow
# waves; the primary wave is unsorted)
SECOND_RENDER = {
    "TPURT_SUPERCLUSTER=1": (5, 0, 6, 0),
    "TPURT_EXACT_MASK=0": (0, 0, 0, 6),
    "TPURT_EXACT_MASK=all": (6, 0, 0, 6),
    "TPURT_FUSED_ENTRIES=0": (0, 5, 0, 6),
}


@pytest.mark.parametrize("switch", sorted(SECOND_RENDER))
def test_switch_takes_effect_on_a_second_render(bunny, monkeypatch, calls,
                                                switch):
    """render_scene keeps its renderer across calls: a switch set between
    two renders in one process must reach the second (the renderer key
    holds the switches). Counts of K2, K3, K1 with superclusters and K1
    with clusters in each render; the image stays the same."""
    cfg = get_config("bunny", width=64, height=48, spp=1, spp_per_batch=1,
                     max_bounces=2)
    for k in ("TPURT_SUPERCLUSTER", "TPURT_EXACT_MASK",
              "TPURT_FUSED_ENTRIES"):
        monkeypatch.delenv(k, raising=False)
    counts, images = [], []
    for env in ({}, dict([switch.split("=")])):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        before = dict(calls)
        state, _ = rd.render_scene(cfg, device="cpu", scene=bunny["scene"])
        counts.append(tuple(calls[k] - before[k] for k in
                            ("entries", "exact_mask", "sc", "cluster")))
        images.append(state.accum)
    assert counts == [(5, 0, 0, 6), SECOND_RENDER[switch]]
    assert torch.equal(images[0], images[1])
