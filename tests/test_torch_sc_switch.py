"""``TPURT_SUPERCLUSTER`` in tpurt_torch's tile intersector against the
reference's: "1" forces supercluster entries where the per-cluster ones
would run (the flat bunny stand-in, whose 14 clusters are far below the
auto rule's 2000, and the two-level sponza_standin(8, 3)), and "0" keeps
per-cluster entries where "auto" takes superclusters (both packages'
``SC_AUTO_MIN_CLUSTERS`` lowered below the scene's cluster count for the
test). Per ray after the restore, closest and any-hit.

The reference runs in interpret mode with its default kernel body: its
SMEM body (``TPURT_SMEM_TRI=1``) costs ten times as much per supercluster
entry there (156 s against 14 s for one closest wave of 1024 rays). The
two bodies differ only in which row keeps an exact-t tie (ROADMAP §3), so
slots may differ on a few rays whose t agrees. Bars: validity and
occlusion equal, t within 1e-6 relative plus 1e-6 of the scene diagonal
on every hit, slots equal on ≥ 99% of hits, barycentrics within 1e-4
(2.5e-4 two-level, the object transform's multiply-adds) where the slots
are.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh import paircluster as ref_pc
from tpurt.kernels import tilewave as ref_tw
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import procedural as ref_proc
from tpurt.scene.device import to_device as ref_to_device
from tpurt_torch.bvh import paircluster as port_pc
from tpurt_torch.kernels import tilewave as tw
from tpurt_torch.render.intersectors import scene_meta as port_meta
from tpurt_torch.scene import procedural as port_proc
from tpurt_torch.scene.device import to_device as port_to_device

SCENES = {
    "flat": (lambda m: m.bunny_standin(subdivisions=3), "build_pair_accel"),
    "two_level": (lambda m: m.sponza_standin(8, 3),
                  "build_pair_accel_two_level"),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    make, build = SCENES[request.param]
    rs, ps = make(ref_proc), make(port_proc)
    r_ds, p_ds = ref_to_device(rs), port_to_device(ps, device="cpu")
    r_acc = getattr(ref_pc, build)(r_ds, ref_meta(rs), scene=rs)
    p_acc = getattr(port_pc, build)(p_ds, port_meta(ps), scene=ps).to("cpu")
    lo, hi = r_acc.cluster_lo.min(0), r_acc.cluster_hi.max(0)
    return dict(kind=request.param, r_ds=r_ds, r_acc=r_acc, p_ds=p_ds,
                p_acc=p_acc, diag=float(np.linalg.norm(hi - lo)),
                lo=lo, hi=hi)


def _rays(sc, n=1000):
    """Seeded rays (not a tile multiple: the padding runs too); closest
    tmax inf with dead lanes, shadow tmax a fifth of the diagonal. Around
    the bunny toward its middle; in the sponza stand-in, the coherent
    camera-like rays of test_torch_twolevel.py (an eye in the nave, a
    cone toward the columns), on which its two-level bars were set."""
    rng = np.random.default_rng(5)
    if sc["kind"] == "flat":
        center = (sc["lo"] + sc["hi"]) / 2
        ext = (sc["hi"] - sc["lo"]) / 2
        org = center + rng.normal(size=(n, 3)) * ext * 1.5
        d = center + rng.normal(size=(n, 3)) * ext * 0.3 - org
    else:
        eye, look = np.array([-12.0, 3.0, -1.0]), np.array([-4.0, 1.5, 2.5])
        org = eye + rng.normal(size=(n, 3)) * 0.05
        d = (look - eye) / np.linalg.norm(look - eye)
        d = d + rng.normal(size=(n, 3)) * 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(n) % 7 == 0, -1.0, np.inf)
    shadow = np.where(np.arange(n) % 5 == 0, -1.0, 0.2 * sc["diag"])
    f32 = lambda x: np.asarray(x, np.float32)
    return f32(org), f32(d), f32(tmax), f32(shadow)


@pytest.fixture
def k1_calls(monkeypatch):
    """K1's calls through the intersector, by entry kind."""
    calls = {"sc": 0, "cluster": 0}
    plain = tw.tileloop

    def counted(*args, sc_meta=None, **kw):
        calls["sc" if sc_meta is not None else "cluster"] += 1
        return plain(*args, sc_meta=sc_meta, **kw)

    monkeypatch.setattr(tw, "tileloop", counted)
    return calls


def _hold(sc, got, want):
    valid = np.asarray(want.valid)
    assert valid.sum() > 200
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.t.numpy()[valid],
                               np.asarray(want.t)[valid], rtol=1e-6,
                               atol=1e-6 * sc["diag"])
    same = got.slot.numpy()[valid] == np.asarray(want.slot)[valid]
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_array_equal(got.inst.numpy()[valid][same],
                                  np.asarray(want.inst)[valid][same])
    atol = 1e-4 if sc["kind"] == "flat" else 2.5e-4
    for name in ("u", "v"):
        np.testing.assert_allclose(
            getattr(got, name).numpy()[valid][same],
            np.asarray(getattr(want, name))[valid][same], atol=atol)


@pytest.mark.parametrize("switch", ["1", "0"])
def test_supercluster_switch_matches_reference(scene, monkeypatch, k1_calls,
                                               switch):
    sc = scene
    monkeypatch.setenv("TPURT_SUPERCLUSTER", switch)
    if switch == "0":  # "auto" would take superclusters here
        low = sc["p_acc"].n_clusters
        monkeypatch.setattr(tw, "SC_AUTO_MIN_CLUSTERS", low)
        monkeypatch.setattr(ref_tw, "SC_AUTO_MIN_CLUSTERS", low)
    org, d, tmax, shadow = _rays(sc)
    r_closest, r_any = ref_tw.make_tile_intersector(
        sc["r_ds"], sc["r_acc"], interpret=True, ray_sort="octant",
        lean=True)
    p_closest, p_any = tw.make_tile_intersector(
        sc["p_ds"], sc["p_acc"], ray_sort="octant", lean=True)
    t, j = torch.from_numpy, jnp.asarray
    _hold(sc, p_closest(t(org), t(d), 0.0, t(tmax)),
          r_closest(j(org), j(d), 0.0, j(tmax)))
    occ = p_any(t(org), t(d), 0.0, t(shadow)).numpy()
    np.testing.assert_array_equal(
        occ, np.asarray(r_any(j(org), j(d), 0.0, j(shadow))))
    assert 0 < occ.sum() < occ.shape[0]
    on = switch == "1"
    assert k1_calls == {"sc": 2 if on else 0, "cluster": 0 if on else 2}


def test_auto_takes_superclusters_past_its_threshold(scene, monkeypatch,
                                                     k1_calls):
    """The rule "0" overrides: with the threshold at the scene's cluster
    count, "auto" walks supercluster entries, and gives the hits of the
    per-cluster entries ("0") on the same wave."""
    sc = scene
    monkeypatch.setattr(tw, "SC_AUTO_MIN_CLUSTERS", sc["p_acc"].n_clusters)
    org, d, tmax, shadow = (torch.from_numpy(x) for x in _rays(sc))
    hits = {}
    for switch in ("auto", "0"):
        monkeypatch.setenv("TPURT_SUPERCLUSTER", switch)
        closest, any_hit = tw.make_tile_intersector(
            sc["p_ds"], sc["p_acc"], ray_sort="octant", lean=True)
        hits[switch] = (closest(org, d, 0.0, tmax),
                        any_hit(org, d, 0.0, shadow))
    assert k1_calls == {"sc": 2, "cluster": 2}
    (a, occ_a), (b, occ_b) = hits["auto"], hits["0"]
    assert torch.equal(occ_a, occ_b)
    assert torch.equal(a.valid, b.valid)
    assert torch.equal(a.t, b.t)
    assert float((a.slot == b.slot).float().mean()) >= 0.99
