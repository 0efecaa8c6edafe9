"""``TPURT_CLUSTERING`` in tpurt_torch against the reference: the
triangle order of each mode (hier, kdsah, kd, morton) and the flat and
two-level pair-cluster tables built under it byte-equal (both builds are
host numpy); and the scene cache rebuilding the accel when the switch
changes between two renders in one process."""

import numpy as np
import pytest
import torch

from tpurt.bvh import paircluster as ref_pc
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import procedural as ref_proc
from tpurt_torch import render as rd
from tpurt_torch.bvh import paircluster as port_pc
from tpurt_torch.render.intersectors import scene_meta as port_meta
from tpurt_torch.scene import procedural as port_proc
from tpurt_torch.utils.config import get_config

MODES = ["hier", "kdsah", "kd", "morton"]


def _byte_equal(name, want, got):
    want = np.asarray(want)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), name


@pytest.fixture(scope="module")
def soup():
    """bunny_standin(4)'s Morton-sorted world triangles (5120, 54
    clusters), from the port's flattening (byte-equal to the reference's,
    test_torch_accel.py)."""
    scene = port_proc.bunny_standin(subdivisions=4)
    return port_pc.flatten_world_tris(None, port_meta(scene), scene=scene)


@pytest.mark.parametrize("mode", MODES)
def test_cluster_order_matches_reference(soup, monkeypatch, mode):
    monkeypatch.setenv("TPURT_CLUSTERING", mode)
    v0, v1, v2 = soup[:3]
    want = ref_pc.cluster_order(v0, v1, v2)
    got = port_pc.cluster_order(v0, v1, v2)
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(v0.shape[0]))
    if mode == "morton":
        np.testing.assert_array_equal(got, np.arange(v0.shape[0]))


def test_cluster_orders_differ(soup, monkeypatch):
    """Each mode is its own order (the switch is read at every call)."""
    orders = []
    for mode in MODES:
        monkeypatch.setenv("TPURT_CLUSTERING", mode)
        orders.append(port_pc.cluster_order(*soup[:3]).tobytes())
    assert len(set(orders)) == len(MODES)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["flat", "two_level"])
def test_pair_accel_tables_byte_equal(monkeypatch, mode, kind):
    monkeypatch.setenv("TPURT_CLUSTERING", mode)
    if kind == "flat":
        ref_scene = ref_proc.bunny_standin(subdivisions=3)
        port_scene = port_proc.bunny_standin(subdivisions=3)
        ref_build, port_build = (ref_pc.build_pair_accel,
                                 port_pc.build_pair_accel)
    else:
        ref_scene = ref_proc.sponza_standin(8, 3)
        port_scene = port_proc.sponza_standin(8, 3)
        ref_build, port_build = (ref_pc.build_pair_accel_two_level,
                                 port_pc.build_pair_accel_two_level)
    want = ref_build(None, ref_meta(ref_scene), scene=ref_scene)
    got = port_build(None, port_meta(port_scene), scene=port_scene)
    assert got._fields == want._fields
    for f in want._fields:
        if getattr(want, f) is None:
            assert getattr(got, f) is None, f
        else:
            _byte_equal(f, getattr(want, f), getattr(got, f))


def _cached_accel():
    return next(v for v in rd._SCENE_CACHE.values()
                if isinstance(v, dict))["accel"]


def test_switch_rebuilds_the_cached_accel(monkeypatch):
    """A second render with another TPURT_CLUSTERING builds a new scene
    context (a new accel, in the new order); the same switch again reuses
    it."""
    cfg = get_config("bunny", width=32, height=24, spp=1, spp_per_batch=1)
    scene = port_proc.bunny_standin(subdivisions=3)
    monkeypatch.setenv("TPURT_CLUSTERING", "hier")
    a, _ = rd.render_scene(cfg, device="cpu", scene=scene)
    rows_hier = _cached_accel().tri_rows
    builds = rd.scene_context_builds()
    monkeypatch.setenv("TPURT_CLUSTERING", "morton")
    b, _ = rd.render_scene(cfg, device="cpu", scene=scene)
    assert rd.scene_context_builds() == builds + 1
    rows_morton = _cached_accel().tri_rows
    assert not torch.equal(rows_hier, rows_morton)
    want = port_pc.build_pair_accel(None, port_meta(scene), scene=scene)
    assert torch.equal(rows_morton, torch.from_numpy(want.tri_rows))
    rd.render_scene(cfg, device="cpu", scene=scene)
    assert rd.scene_context_builds() == builds + 1
    # the closest hits are the same triangles in either order
    np.testing.assert_allclose(a.accum.numpy(), b.accum.numpy(), atol=1e-5)
