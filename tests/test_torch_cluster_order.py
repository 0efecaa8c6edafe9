"""The pair-cluster accel's cluster order from the host library
(``tpurt_torch/csrc/cluster_order.cpp``) against its numpy twin and the
reference's build, and a scan-scale scene (the benchmark's Happy Buddha
stand-in, cut to about 20 k triangles) through the port against the
benchmark's plain reference.

The orders of ``TPURT_CLUSTERING``'s hier, kdsah and kd modes are byte-
equal three ways (the library, the twin under ``TPURT_NO_NATIVE=1`` and
the reference) on the bunny stand-in, both Cornell boxes, each mesh of
the sponza stand-in as its two-level build orders them, and the Buddha
stand-in. The render holds the port's accumulation to the reference's
``off_share`` limit of the benchmark's ``buddha.accum`` cell, by the
default rule (cluster entry rows at this size) and under
``TPURT_SUPERCLUSTER=1`` (supercluster entry rows), and reads the accel
build's record and the waves counted by tile mode."""

import json
import os

import numpy as np
import pytest
import torch

from tpurt.bvh import paircluster as ref_pc
from tpurt_torch import kernels
from tpurt_torch import render as rd
from tpurt_torch.bvh import paircluster as port_pc
from tpurt_torch.bvh.cluster import _host_tris, _morton
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render.intersectors import scene_meta
from tpurt_torch.scene import procedural as port_proc
from tpurt_torch.utils import native, profiling
from tpurt_torch.utils.config import RenderConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["hier", "kdsah", "kd"]
SCENES = ["bunny4", "bunny5", "cornell", "cornell_pt", "sponza", "buddha"]
BUDDHA = {"segments": 100, "bands": 101}  # 20,000 + 6 triangles


def _buddha_scene():
    from perfbench import program, scenes

    sd = scenes.build("buddha_standin", BUDDHA)
    return sd, program.port_scene(sd)


def _scene(name):
    if name.startswith("bunny"):
        return port_proc.bunny_standin(subdivisions=int(name[-1]))
    if name.startswith("cornell"):
        return port_proc.cornell_box(path_tracer=name == "cornell_pt")
    if name == "sponza":
        return port_proc.sponza_standin(8, 3)
    return _buddha_scene()[1]


def _soups(name):
    """The (v0, v1, v2) corner sets the accel build orders: the world
    soup of a flat build, or each mesh's Morton-sorted object-space
    triangles of the sponza stand-in's two-level build."""
    scene = _scene(name)
    meta = scene_meta(scene)
    if name != "sponza":
        return [port_pc.flatten_world_tris(None, meta, scene=scene)[:3]]
    tv0, tv1, tv2, _ = _host_tris(None, meta, scene)
    out = []
    for start, count in meta.mesh_tri_ranges:
        if count == 0:
            continue
        v0, v1, v2 = (t[start:start + count] for t in (tv0, tv1, tv2))
        lo = np.minimum(np.minimum(v0, v1), v2).min(0)
        hi = np.maximum(np.maximum(v0, v1), v2).max(0)
        order = np.argsort(_morton((v0 + v1 + v2) / 3.0, lo, hi),
                           kind="stable")
        out.append((v0[order], v1[order], v2[order]))
    return out


@pytest.fixture(scope="module")
def soups():
    return {name: _soups(name) for name in SCENES}


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("mode", MODES)
def test_order_byte_equal_to_twin_and_reference(soups, monkeypatch, name,
                                                mode):
    monkeypatch.setenv("TPURT_CLUSTERING", mode)
    assert native.get_order_lib() is not None, native.order_build_error()
    for v0, v1, v2 in soups[name]:
        got = port_pc.cluster_order(v0, v1, v2)
        want = ref_pc.cluster_order(v0, v1, v2)
        monkeypatch.setenv("TPURT_NO_NATIVE", "1")
        twin = port_pc.cluster_order(v0, v1, v2)
        monkeypatch.delenv("TPURT_NO_NATIVE")
        assert got.dtype == twin.dtype == np.asarray(want).dtype
        assert got.tobytes() == twin.tobytes()
        assert got.tobytes() == np.asarray(want).tobytes()
        assert sorted(got.tolist()) == list(range(v0.shape[0]))


@pytest.mark.parametrize("kind", ["hier", "kdsah"])
def test_library_order_does_not_depend_on_threads(soups, monkeypatch, kind):
    v0, v1, v2 = soups["buddha"][0]
    parent = (port_pc.SC_SIZE * port_pc.TRIS_PER_CLUSTER
              if kind == "hier" else 0)
    orders = []
    for threads in (1, 3, 8):
        monkeypatch.setattr(native, "host_threads", lambda t=threads: t)
        orders.append(native.cluster_order(v0, v1, v2,
                                           port_pc.TRIS_PER_CLUSTER,
                                           parent).tobytes())
    assert len(set(orders)) == 1


def test_library_leaves_float64_corners_to_the_twin(soups):
    """The library takes float32 corners only (its arithmetic is the
    twin's on them); the twin orders anything else."""
    v0, v1, v2 = (v.astype(np.float64) for v in soups["bunny4"][0])
    assert native.cluster_order(v0, v1, v2, 96, 768) is None
    assert port_pc.hier_cluster_order(v0, v1, v2).tobytes() == \
        port_pc.hier_cluster_order_py(v0, v1, v2).tobytes()


# --- the scan-scale scene through the port, against the plain reference --


def _off_share(got, ref):
    """perfbench/check.py's accumulation comparison."""
    from perfbench.check import ABS_TOL, REL_TOL

    diff = (got - ref).abs() / torch.clamp_min(ref.abs(), ABS_TOL / REL_TOL)
    return float((~(diff <= REL_TOL)).float().mean())


@pytest.fixture(scope="module")
def reference_pixels():
    """The plain reference's mean radiance of every pixel (64 × 48, 2
    samples, the seed below) of the small Buddha scene."""
    from perfbench.reference.render import WorldScene, render_pixels

    sd, _ = _buddha_scene()
    w, h = 64, 48
    flat = torch.arange(w * h)
    ws = WorldScene(sd, torch.device("cpu"))
    ref = render_pixels(ws, sd.camera, 2718281901, 2, flat % w, flat // w,
                        w, h, 2, True)
    return ref / 2.0


@pytest.mark.parametrize("switch,mode", [("auto", "cluster_rows"),
                                         ("1", "sc_rows")])
def test_buddha_render_matches_plain_reference(monkeypatch,
                                               reference_pixels, switch,
                                               mode):
    with open(os.path.join(ROOT, "perfbench", "limits",
                           "buddha.accum.json")) as f:
        limit = json.load(f)["off_share"]
    monkeypatch.setenv("TPURT_SUPERCLUSTER", switch)
    _, scene = _buddha_scene()
    cfg = RenderConfig(scene="buddha", width=64, height=48, spp=2,
                       spp_per_batch=2, max_bounces=2, use_nee=True,
                       seed=2718281901)
    kernels.reset("waves.")
    state, _ = rd.render_scene(cfg, scene=scene, device="cpu")
    waves = kernels.counts("waves.")
    assert set(waves) == {f"waves.{mode}"} and waves[f"waves.{mode}"] >= 3
    got = fb.resolve(state).reshape(-1, 3)
    assert _off_share(got, reference_pixels) <= limit


def test_buddha_accel_record_and_counters():
    """The build's record is kept with the recorder off; on, the same
    counts are counters and the phases are spans inside accel.build."""
    _, scene = _buddha_scene()
    cfg = RenderConfig(scene="buddha", width=32, height=24, spp=1,
                       spp_per_batch=1, max_bounces=1)
    rd._SCENE_CACHE.clear()
    profiling.record(True)
    try:
        rd.render_scene(cfg, scene=scene, device="cpu")
    finally:
        profiling.record(False)
    rec = rd.accel_build_record()
    accel = next(v for v in rd._SCENE_CACHE.values()
                 if isinstance(v, dict))["accel"]
    n_tris = sum(m.num_triangles for m in scene.meshes)
    assert rec["kind"] == "PairAccel" and n_tris == 20006
    assert (rec["triangles"], rec["clusters"], rec["superclusters"]) == \
        (n_tris, -(-n_tris // 96), -(-(-(-n_tris // 96)) // 8))
    # a flat accel holds every instance's triangles
    assert (rec["instances"], rec["stored_triangles"]) == \
        (len(scene.instances), n_tris)
    assert rec["bytes"] == sum(t.numel() * t.element_size() for t in accel
                               if t is not None)
    assert set(rec["seconds"]) == {"build", "order", "pack", "shade_rows"}
    assert all(v > 0 for v in rec["seconds"].values())
    assert sum(rec["seconds"][k] for k in ("order", "pack", "shade_rows")) \
        <= rec["seconds"]["build"]
    r = profiling.records()
    for k in ("triangles", "clusters", "superclusters", "bytes",
              "instances", "stored_triangles"):
        assert r["counts"]["accel." + k] == rec[k]
    assert r["counts"]["waves.cluster_rows"] >= 3
    spans = r["spans"]
    build = next(i for i, s in enumerate(spans) if s.name == "accel.build")
    phases = [s for s in spans if s.name.startswith("accel.")
              and s.name != "accel.build"]
    assert [s.name for s in phases] == ["accel.order", "accel.pack",
                                        "accel.shade_rows"]
    assert all(s.parent == build for s in phases)
    # off, nothing is recorded and the record is still kept
    profiling.clear()
    rd._SCENE_CACHE.clear()
    rd.render_scene(cfg, scene=scene, device="cpu")
    assert profiling.records()["counts"] == {}
    assert rd.accel_build_record()["clusters"] == rec["clusters"]
