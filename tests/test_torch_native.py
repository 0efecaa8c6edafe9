"""The port's binding to the C++ host library against the reference's
(``tpurt.utils.native``), and the PNG codec around it.

Both packages build ``native/tpurt_native.cpp`` with g++, each into its
own directory; the tests skip where g++ is missing, as the reference's
test does. Tolerances: none — PNG bytes, parsed OBJ arrays, tree arrays
and packet-BVH tables equal, and every PNG decode equal to its source.
"""

import os
import shutil

import numpy as np
import pytest

from tpurt.bvh import cluster as ref_cluster
from tpurt.render import png as ref_png
from tpurt.scene import procedural as ref_proc
from tpurt.scene.device import to_device as ref_to_device
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.utils import native as ref_native
from tpurt_torch.bvh import cluster as port_cluster
from tpurt_torch.render import png as port_png
from tpurt_torch.render.intersectors import scene_meta as port_meta
from tpurt_torch.scene import procedural as port_proc
from tpurt_torch.scene.obj import load_obj, save_obj
from tpurt_torch.scene.types import Mesh
from tpurt_torch.utils import native

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ unavailable: no native build")


@pytest.fixture(scope="module")
def lib():
    got = native.get_lib()
    assert got is not None, native.build_error()
    assert ref_native.get_lib() is not None
    assert os.path.dirname(native.SO).endswith(os.path.join("tpurt_torch",
                                                            "build"))
    return got


def test_png_bytes_equal_reference(tmp_path, lib, monkeypatch):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    a, b = str(tmp_path / "port.png"), str(tmp_path / "ref.png")
    assert native.png_write(a, img) and ref_native.png_write(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(port_png.read_png(a), img)
    # write_png takes the native encoder, or zlib here without it: the
    # same pixels either way
    c = str(tmp_path / "python.png")
    monkeypatch.setenv("TPURT_NO_NATIVE", "1")
    port_png.write_png(c, img)
    np.testing.assert_array_equal(port_png.read_png(c), img)


def test_png_decode_matches_reference():
    """decode_png on RGBA, RGB and gray streams using every filter type:
    equal to the source and to the reference's decode; srgb_to_linear
    bit-equal on every byte value."""
    from tests.test_torch_loaders import rgba_png

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (11, 9, 4), dtype=np.uint8)
    data = rgba_png(img)
    for keep in (True, False):
        got = port_png.decode_png(data, keep_alpha=keep)
        want = ref_png.decode_png(data, keep_alpha=keep)
        np.testing.assert_array_equal(got, img if keep else img[..., :3])
        assert got.tobytes() == want.tobytes()
    v = np.arange(256, dtype=np.uint8).reshape(16, 16)
    lin = port_png.srgb_to_linear(v)
    assert lin.dtype == np.float32
    assert lin.tobytes() == ref_png.srgb_to_linear(v).tobytes()
    with pytest.raises(ValueError):
        port_png.decode_png(b"not a png")


def test_obj_parse_matches_reference(tmp_path, lib):
    v, idx, vn = port_proc.icosphere(3)
    path = str(tmp_path / "sphere.obj")
    save_obj(path, Mesh(v, idx, np.zeros(idx.shape[0], np.int32), normals=vn,
                        name="sphere"))
    quad = str(tmp_path / "quad.obj")
    with open(quad, "w") as f:
        f.write("mtllib q.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n")
        f.write("usemtl a\nf -4 -3 -2 -1\nusemtl b\nf 1 2 3\n")
    for p in (path, quad):
        got, want = native.obj_parse(p), ref_native.obj_parse(p)
        for g, w in zip(got[:5], want[:5]):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        assert got[5:] == want[5:]
    verts, normals, tri_v, tri_n, face_mat, names, mtllib = \
        native.obj_parse(quad)
    np.testing.assert_array_equal(tri_v, [[0, 1, 2], [0, 2, 3], [0, 1, 2]])
    assert (tri_n == -1).all() and names == ["a", "b"]
    assert mtllib == "q.mtl" and face_mat.tolist() == [0, 0, 1]


def test_obj_native_equals_python_twin(tmp_path, lib, monkeypatch):
    v, idx, vn = port_proc.icosphere(3)
    path = str(tmp_path / "sphere.obj")
    save_obj(path, Mesh(v, idx, np.zeros(idx.shape[0], np.int32), normals=vn,
                        name="sphere"))
    a = load_obj(path)
    monkeypatch.setenv("TPURT_NO_NATIVE", "1")
    assert native.get_lib() is None
    b = load_obj(path)
    for f in ("vertices", "indices", "normals"):
        x, y = getattr(a.meshes[0], f), getattr(b.meshes[0], f)
        assert x.tobytes() == y.tobytes(), f


def _boxes(n, seed=2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n, 3)).astype(np.float32)
    half = rng.uniform(0.01, 0.3, (n, 3)).astype(np.float32)
    return centers - half, centers + half


@pytest.mark.parametrize("n", [1, 2, 137, 1000])
def test_bvh_build_matches_reference(lib, n, monkeypatch):
    """The native tree equals the reference's native tree, the Python
    twin the reference's twin, and both keep the tree contract."""
    bmin, bmax = _boxes(n)
    got, want = native.bvh_build(bmin, bmax), ref_native.bvh_build(bmin, bmax)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    py = port_cluster._median_split_tree(bmin, bmax)
    monkeypatch.setenv("TPURT_NO_NATIVE", "1")
    monkeypatch.setattr(ref_native, "_tried", False)
    ref_py = ref_cluster._median_split_tree(bmin, bmax)
    for g, w in zip(py, ref_py):
        assert g.tobytes() == w.tobytes()
    for tree in (got, tuple(py)):
        m = tree[2].shape[0]
        first, count, skip = tree[2], tree[3], tree[4]
        assert m == 2 * n - 1 and skip[0] == m
        assert sorted(first[count > 0].tolist()) == list(range(n))
        assert (skip > np.arange(m)).all()


def test_packet_accel_native_byte_equal():
    """The packet BVH of an instanced scene built natively by both
    packages: every table byte-equal."""
    rs, ps = ref_proc.sponza_standin(8, 3), port_proc.sponza_standin(8, 3)
    want = ref_cluster.build_packet_accel(ref_to_device(rs), ref_meta(rs),
                                          scene=rs)
    got = port_cluster.build_packet_accel(None, port_meta(ps), scene=ps)
    for f in got._fields:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def test_build_at_first_use_and_on_a_newer_source(tmp_path, monkeypatch):
    """The library builds when missing and again when the source is
    newer; a source that does not compile leaves get_lib None with the
    compiler's message, and the callers' Python twins carry on."""
    src = str(tmp_path / "tpurt_native.cpp")
    shutil.copy(native.SRC, src)
    so = str(tmp_path / "build" / "libtpurt_native.so")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "SO", so)
    for attr, val in (("_tried", False), ("_lib", None), ("_error", "")):
        monkeypatch.setattr(native, attr, val)
    assert native.get_lib() is not None and os.path.exists(so)
    built = os.path.getmtime(so)
    with open(src, "a") as f:
        f.write("\nthis is not C++\n")
    os.utime(src, (built + 10, built + 10))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native.get_lib() is None
    assert "error" in native.build_error()
    assert native.bvh_build(*_boxes(5)) is None
    assert port_cluster._build_tree(*_boxes(5)).first.shape == (9,)
