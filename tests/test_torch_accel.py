"""Host scene packing and the flat pair-cluster build of tpurt_torch
against the reference: both are host numpy, so every array must be
byte-equal (same dtype, shape and bytes)."""

import numpy as np
import pytest

from tpurt.bvh.paircluster import build_pair_accel as ref_build
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import procedural as ref_proc
from tpurt.scene.device import to_device as ref_to_device
from tpurt_torch.bvh.paircluster import build_pair_accel as port_build
from tpurt_torch.render.intersectors import scene_meta as port_meta
from tpurt_torch.scene import procedural as port_proc
from tpurt_torch.scene.device import to_device as port_to_device

SCENES = {
    "cornell": lambda m: m.cornell_box(path_tracer=False),
    "cornell_pt": lambda m: m.cornell_box(path_tracer=True),
    "bunny3": lambda m: m.bunny_standin(subdivisions=3),
}


def _byte_equal(name, want, got):
    want = np.asarray(want)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), name


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_to_device_byte_equal(scene):
    ref_scene = SCENES[scene](ref_proc)
    port_scene = SCENES[scene](port_proc)
    want = ref_to_device(ref_scene)
    got = port_to_device(port_scene, device="cpu")
    assert got._fields == want._fields
    for f in want._fields:
        _byte_equal(f, getattr(want, f), getattr(got, f).numpy())
    assert port_meta(port_scene) == ref_meta(ref_scene)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_build_pair_accel_byte_equal(scene):
    ref_scene = SCENES[scene](ref_proc)
    port_scene = SCENES[scene](port_proc)
    want = ref_build(None, ref_meta(ref_scene), scene=ref_scene)
    got = port_build(None, port_meta(port_scene), scene=port_scene)
    assert got._fields == want._fields
    for f in want._fields:
        _byte_equal(f, getattr(want, f), getattr(got, f))
    # the torch copy of the tables keeps every byte
    on_dev = got.to("cpu")
    for f in want._fields:
        _byte_equal(f, getattr(want, f), getattr(on_dev, f).numpy())


def test_build_from_device_scene_matches_host_build():
    """Without a host Scene the build reads the DeviceScene tensors back
    and must produce the same tables."""
    scene = port_proc.bunny_standin(subdivisions=3)
    meta = port_meta(scene)
    a = port_build(None, meta, scene=scene)
    b = port_build(port_to_device(scene, device="cpu"), meta)
    for f in a._fields:
        _byte_equal(f, getattr(a, f), getattr(b, f))
