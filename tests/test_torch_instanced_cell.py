"""The benchmark's instanced atrium (``atrium.accum``: the ladder's config
5, a TLAS of 126 instances over 5 shared meshes) through the port on the
CPU.

perfbench's frozen scene builder is the program's ``sponza_standin``
array for array, and its counts and checksum are the ones the cell's
configuration froze. A small copy (12-segment, 4-ring columns) renders
through ``render_scene`` on the two-level pair-cluster accel, by the
default rule (cluster entry rows at this size) and with superclusters
forced (``TPURT_SUPERCLUSTER=1``: the supercluster entry rows the cell
takes at its size), each held to the benchmark's plain reference by the
cell's ``off_share`` limit, with the accel build's record and the waves
the PyTorch shade shaded (``shade.plain``) read off the same render."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from perfbench import program, scenes
from tpurt_torch import kernels
from tpurt_torch import render as rd
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.scene.procedural import sponza_standin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"column_segments": 12, "column_rings": 4}
SEED = 2718281901
SPP, SPP_PER_BATCH = 16, 8
PIXELS = 512  # of the 1,536 the reference recomputes


def _config():
    with open(os.path.join(ROOT, "perfbench", "configs", "atrium.json")) as f:
        return json.load(f)


def _limit():
    with open(os.path.join(ROOT, "perfbench", "limits",
                           "atrium.accum.json")) as f:
        return json.load(f)["off_share"]


def test_frozen_scene_is_the_programs_preset():
    cfg = _config()
    sd = scenes.build(cfg["scene"]["builder"], cfg["scene"]["args"])
    port = sponza_standin(**cfg["scene"]["args"])
    assert len(sd.meshes) == len(port.meshes) == 5
    for m, p in zip(sd.meshes, port.meshes):
        assert m.name == p.name
        for a, b in ((m.vertices, p.vertices), (m.indices, p.indices),
                     (m.material_ids, p.material_ids),
                     (m.normals, p.compute_vertex_normals())):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert [(m.kind, m.albedo, m.emission, m.param0, m.param1, m.name)
            for m in sd.materials] == \
        [(m.kind, tuple(m.albedo), tuple(m.emission), m.param0, m.param1,
          m.name) for m in port.materials]
    assert len(sd.instances) == len(port.instances) == 126
    for i, p in zip(sd.instances, port.instances):
        assert (i.mesh_id, i.name) == (p.mesh_id, p.name)
        assert p.material_override == -1
        assert np.array_equal(i.transform, p.transform)
    cam = program.port_camera(sd.camera)
    for a, b in zip(cam, port.camera):
        assert torch.equal(a, b)
    assert tuple(sd.background) == tuple(port.background)
    assert cfg["frozen"] == {
        "triangles": sum(m.indices.shape[0] for m in sd.meshes),
        "instanced_triangles": sd.instanced_triangles(),
        "sha256": sd.checksum()}
    assert (cfg["frozen"]["triangles"],
            cfg["frozen"]["instanced_triangles"]) == (2716, 258388)


@pytest.fixture(scope="module")
def small_scene():
    sd = scenes.build("atrium_standin", SMALL)
    return sd, program.port_scene(sd)


@pytest.fixture(scope="module")
def reference_pixels(small_scene):
    """The plain reference's mean radiance of a seeded sample of the
    small atrium's pixels (48 × 32, 16 samples, the seed above), as the
    cell's check draws one: (flat pixel ids, mean radiance)."""
    from perfbench.reference.render import WorldScene, render_pixels

    sd, _ = small_scene
    w, h = 48, 32
    flat = torch.as_tensor(np.random.default_rng([SEED, 3]).choice(
        w * h, size=PIXELS, replace=False))
    ws = WorldScene(sd, torch.device("cpu"))
    ref = render_pixels(ws, sd.camera, SEED, SPP, flat % w, flat // w, w, h,
                        2, True)
    return flat, ref / float(SPP)


@pytest.fixture(scope="module", params=[("auto", "cluster_rows"),
                                        ("1", "sc_rows")],
                ids=["default", "supercluster"])
def small_render(request, small_scene):
    """One render of the small atrium on the CPU with the cell's estimator
    (2 batches of 8 samples), by the default rule or with superclusters
    forced, for every case below: (the tile mode the waves take, mean
    radiance, the build record, the waves by tile mode, the launch
    counts)."""
    switch, mode = request.param
    config = dataclasses.replace(
        program.render_config({**_config()["render"], "width": 48,
                               "height": 32,
                               "spp_per_batch": SPP_PER_BATCH}),
        seed=SEED, spp=SPP)
    was = os.environ.get("TPURT_SUPERCLUSTER")
    os.environ["TPURT_SUPERCLUSTER"] = switch
    try:
        rd._SCENE_CACHE.clear()
        kernels.reset_launch_counts()
        kernels.reset("waves.")
        state, _ = rd.render_scene(config, scene=small_scene[1],
                                   device="cpu")
        return (mode, fb.resolve(state).reshape(-1, 3),
                rd.accel_build_record(), kernels.counts("waves."),
                kernels.launch_counts())
    finally:
        if was is None:
            del os.environ["TPURT_SUPERCLUSTER"]
        else:
            os.environ["TPURT_SUPERCLUSTER"] = was
        rd._SCENE_CACHE.clear()


def test_small_atrium_builds_the_two_level_accel(small_render, small_scene):
    _, _, record, _, _ = small_render
    sd, _ = small_scene
    assert record["kind"] == "PairAccelTL"
    assert record["instances"] == 126
    assert record["stored_triangles"] == \
        sum(m.indices.shape[0] for m in sd.meshes) == 148
    assert record["triangles"] == sd.instanced_triangles() == 11860
    # instance-clusters: each instance's mesh clusters (96 triangles a
    # cluster), and one supercluster at least an instance
    assert record["clusters"] == sum(
        -(-sd.meshes[i.mesh_id].indices.shape[0] // 96)
        for i in sd.instances)
    assert record["superclusters"] >= 126


def test_small_atrium_matches_plain_reference(small_render,
                                              reference_pixels):
    from perfbench.check import ABS_TOL, REL_TOL

    _, image, _, _, _ = small_render
    flat, ref = reference_pixels
    diff = (image[flat] - ref).abs() / torch.clamp_min(
        ref.abs(), ABS_TOL / REL_TOL)
    off = float((~(diff <= REL_TOL)).float().mean())
    assert off <= _limit()
    assert float(ref.mean()) > 0.05  # a lit image


def test_small_atrium_counts_its_waves_and_plain_shades(small_render):
    """Each batch traces and shades 3 waves (the camera wave and two
    bounces) and traces a shadow wave after each: all in the tile mode
    the rule picks, and every shade by the PyTorch code on the CPU."""
    mode, _, _, waves, launches = small_render
    batches = SPP // SPP_PER_BATCH
    assert waves == {f"waves.{mode}": 6 * batches}
    assert launches["shade.plain"] == 3 * batches
    assert launches["shade"] == 0
