"""Scene files in tpurt_torch against tpurt: the OBJ (+ MTL) and glTF
loaders on the same files, the exporters' files byte for byte, and the
port's full-scale round trips of tests/unit/test_export.py.

Tolerances: none. Every mesh, material, texture, instance and camera
array of a loaded scene equals the reference's, the exported files are
byte-equal, and the round-tripped world triangle soup is bit-exact.
"""

import base64
import dataclasses
import json
import os
import struct
import zlib

import numpy as np
import pytest

from tpurt.scene import procedural as ref_proc
from tpurt.scene.export import save_glb as ref_save_glb
from tpurt.scene.export import save_gltf as ref_save_gltf
from tpurt.scene.export import save_obj_scene as ref_save_obj_scene
from tpurt.scene.loader import load_scene as ref_load
from tpurt.scene.obj import save_obj as ref_save_obj
from tpurt.utils import native as ref_native
from tpurt_torch.render.intersectors import scene_meta
from tpurt_torch.scene import procedural as port_proc
from tpurt_torch.scene.export import export_scene, save_glb, save_gltf
from tpurt_torch.scene.export import save_obj_scene
from tpurt_torch.scene.loader import load_scene
from tpurt_torch.scene.obj import save_obj


def assert_same_scene(got, want):
    """Every array and field of two host scenes (one per package)."""
    assert got.name == want.name
    assert tuple(got.background) == tuple(want.background)
    assert len(got.meshes) == len(want.meshes)
    for a, b in zip(got.meshes, want.meshes):
        assert a.name == b.name
        for f in ("vertices", "indices", "material_ids", "normals", "uvs"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and x.shape == y.shape, f
                assert x.tobytes() == y.tobytes(), f
    assert [dataclasses.asdict(m) | {"map_kd": getattr(m, "map_kd", None)}
            for m in got.materials] == [
        dataclasses.asdict(m) | {"map_kd": getattr(m, "map_kd", None)}
        for m in want.materials]
    assert len(got.textures) == len(want.textures)
    for a, b in zip(got.textures, want.textures):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert len(got.instances) == len(want.instances)
    for a, b in zip(got.instances, want.instances):
        assert (a.mesh_id, a.material_override, a.name) == \
            (b.mesh_id, b.material_override, b.name)
        assert a.transform.tobytes() == b.transform.tobytes()
    assert (got.camera is None) == (want.camera is None)
    if got.camera is not None:
        for f in ("position", "look_at", "up", "vfov_deg"):
            x = np.asarray(getattr(got.camera, f))
            y = np.asarray(getattr(want.camera, f))
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def rgba_png(img: np.ndarray) -> bytes:
    """(H, W, 4) uint8 → PNG bytes (color type 6), every filter type
    used once per five rows so the decoders' unfiltering is exercised."""
    h, w, _ = img.shape
    rows = []
    prev = np.zeros(w * 4, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        filt = y % 5
        left = np.concatenate([np.zeros(4, np.int32), cur[:-4]])
        ul = np.concatenate([np.zeros(4, np.int32), prev[:-4]])
        if filt == 0:
            enc = cur
        elif filt == 1:
            enc = cur - left
        elif filt == 2:
            enc = cur - prev
        elif filt == 3:
            enc = cur - ((left + prev) >> 1)
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
            enc = cur - pred
        rows.append(bytes([filt]) + (enc & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def quad_gltf_doc(textured=False):
    """One quad (2 triangles) on a node with a rotation, scale and
    translation under a parent node with a matrix, a camera node, one
    material; with ``textured`` a TEXCOORD_0 attribute, an embedded RGBA
    PNG base color and alphaMode MASK."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    buf = pos.tobytes() + nrm.tobytes() + uv.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 2],
                    "extras": {"tpurt_background": [0.1, 0.2, 0.3]}}],
        "nodes": [
            {"children": [1], "matrix": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0,
                                         0.5, -1.0, 0.25, 1]},
            {"mesh": 0, "translation": [2.0, 0.0, 0.0],
             "rotation": [0.0, 0.3826834, 0.0, 0.9238795],
             "scale": [1.5, 1.0, 0.5], "name": "quad"},
            {"camera": 0, "translation": [0.0, 0.5, 4.0], "name": "cam"},
        ],
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.7, "znear": 0.01}}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1},
            "indices": 3, "material": 0}]}],
        "materials": [{
            "name": "red",
            "pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.1, 0.1, 1.0],
                                     "metallicFactor": 0.0,
                                     "roughnessFactor": 0.4},
            "emissiveFactor": [0.5, 0.25, 0.0],
        }],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 48},
            {"buffer": 0, "byteOffset": 96, "byteLength": 32},
            {"buffer": 0, "byteOffset": 128, "byteLength": 12},
        ],
        "buffers": [{"byteLength": len(buf)}],
    }
    if textured:
        rng = np.random.default_rng(5)
        img = rng.integers(0, 256, (6, 5, 4), dtype=np.uint8)
        img[..., 3] = np.where(np.indices((6, 5)).sum(0) % 2, 255, 0)
        doc["meshes"][0]["primitives"][0]["attributes"]["TEXCOORD_0"] = 2
        doc["images"] = [{"uri": "data:image/png;base64,"
                          + base64.b64encode(rgba_png(img)).decode()}]
        doc["textures"] = [{"source": 0}]
        doc["materials"][0].update(
            alphaMode="MASK", alphaCutoff=0.4,
            pbrMetallicRoughness={"baseColorFactor": [1, 1, 1, 1],
                                  "baseColorTexture": {"index": 0},
                                  "metallicFactor": 0.0,
                                  "roughnessFactor": 1.0})
    return doc, buf


def _write_gltf(tmp_path, kind):
    doc, buf = quad_gltf_doc(textured=kind == "textured")
    if kind == "external":
        with open(os.path.join(tmp_path, "quad.bin"), "wb") as f:
            f.write(buf)
        doc["buffers"][0]["uri"] = "quad.bin"
    elif kind != "glb":
        doc["buffers"][0]["uri"] = (
            "data:application/octet-stream;base64,"
            + base64.b64encode(buf).decode())
    if kind == "glb":
        js = json.dumps(doc).encode()
        js += b" " * ((4 - len(js) % 4) % 4)
        bb = buf + b"\x00" * ((4 - len(buf) % 4) % 4)
        path = os.path.join(tmp_path, "quad.glb")
        with open(path, "wb") as f:
            f.write(b"glTF" + struct.pack("<II", 2, 28 + len(js) + len(bb))
                    + struct.pack("<I", len(js)) + b"JSON" + js
                    + struct.pack("<I", len(bb)) + b"BIN\x00" + bb)
        return path
    path = os.path.join(tmp_path, "quad.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


@pytest.mark.parametrize("kind", ["base64", "external", "glb", "textured"])
def test_gltf_matches_reference(tmp_path, kind):
    path = _write_gltf(tmp_path, kind)
    got, want = load_scene(path), ref_load(path)
    assert_same_scene(got, want)
    assert len(got.instances) == 1 and got.camera is not None
    if kind == "textured":
        mat = got.materials[got.meshes[0].material_ids[0]]
        assert mat.alpha_cutoff == pytest.approx(0.4)
        assert mat.base_color_texture == 0
        assert got.textures[0].shape == (6, 5, 4)
        assert scene_meta(got).has_alpha_cutout


def _write_obj_with_mtl(tmp_path, textured: bool):
    """Two materials (a Blinn-Phong and a glass) over a quad, and with
    ``textured`` a map_Kd PNG and vt texcoords."""
    from tpurt_torch.render.png import write_png

    mtl = os.path.join(tmp_path, "scene.mtl")
    with open(mtl, "w") as f:
        f.write("newmtl redmat\nKd 0.9 0.1 0.1\nNs 64\nKs 0.5 0.5 0.5\n")
        if textured:
            f.write("map_Kd tex.png\n")
        f.write("newmtl glassmat\nNi 1.5\nillum 7\nKd 1 1 1\n")
        f.write("newmtl mirror\nKd 0.9 0.9 0.9\nillum 3\n")
    rng = np.random.default_rng(3)
    write_png(os.path.join(tmp_path, "tex.png"),
              rng.integers(0, 256, (4, 3, 3), dtype=np.uint8))
    obj = os.path.join(tmp_path, "scene.obj")
    with open(obj, "w") as f:
        f.write("# tpurt_camera 0 0 5 0 0 0 0 1 0 40\n")
        f.write("# tpurt_background 0.25 0.5 0.75\n")
        f.write("mtllib scene.mtl\n")
        f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nv 2 1 0\n")
        f.write("vn 0 0 1\nvn 0 0.6 0.8\n")
        if textured:
            f.write("vt 0 0\nvt 1 0\nvt 0 1\nvt 1 1\n")
            f.write("usemtl redmat\nf 1/1/1 2/2/1 3/3/2\n")
            f.write("usemtl glassmat\nf 2/2/1 4/4/2 3/3/2\n")
        else:
            f.write("usemtl redmat\nf 1//1 2//1 3//2\n")
            f.write("usemtl glassmat\nf -4//1 -2//2 -3//2\n")
            f.write("usemtl mirror\nf 2//1 5//2 4//1 3//2\n")
    return obj


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("textured", [False, True],
                         ids=["plain", "map_kd"])
def test_obj_matches_reference(tmp_path, monkeypatch, native, textured):
    """OBJ + MTL through both packages' loaders, with the native parser
    (each package's own binding) and without (TPURT_NO_NATIVE=1). A
    material with map_Kd takes the Python parser either way."""
    if native:
        from tpurt_torch.utils import native as port_native

        assert port_native.get_lib() is not None, port_native.build_error()
    else:
        monkeypatch.setenv("TPURT_NO_NATIVE", "1")
        monkeypatch.setattr(ref_native, "_tried", False)
    obj = _write_obj_with_mtl(tmp_path, textured)
    got, want = load_scene(obj), ref_load(obj)
    assert_same_scene(got, want)
    mesh = got.meshes[0]
    assert mesh.num_triangles == (2 if textured else 4)
    assert (mesh.uvs is not None) == textured
    assert (len(got.textures) == 1) == textured
    assert got.background == (0.25, 0.5, 0.75)


SMALL = {"bunny2": lambda p: p.bunny_standin(subdivisions=2),
         "cornell_pt": lambda p: p.cornell_box(path_tracer=True),
         "sponza_small": lambda p: p.sponza_standin(8, 3)}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_exported_files_byte_equal(tmp_path, name):
    """save_glb, save_gltf and save_obj_scene (and save_obj of the first
    mesh) of the same scene write the same bytes in both packages; the
    port reads the files back to the scene the reference reads."""
    ps, rs = SMALL[name](port_proc), SMALL[name](ref_proc)
    for ext, port_save, ref_save in (
            ("glb", save_glb, ref_save_glb),
            ("gltf", save_gltf, ref_save_gltf),
            ("obj", save_obj_scene, ref_save_obj_scene)):
        a = str(tmp_path / f"port.{ext}")
        b = str(tmp_path / f"ref.{ext}")
        port_save(a, ps)
        ref_save(b, rs)
        with open(a, "rb") as fa, open(b, "rb") as fb_:
            da, db = fa.read(), fb_.read()
        if ext == "obj":  # the mtllib line names each file's own MTL
            da = da.replace(b"mtllib port.mtl", b"mtllib ref.mtl")
            with open(a[:-3] + "mtl", "rb") as fa, \
                    open(b[:-3] + "mtl", "rb") as fb_:
                assert fa.read() == fb_.read()
        assert da == db, ext
        assert_same_scene(load_scene(b), ref_load(b))
    a, b = str(tmp_path / "mesh_p.obj"), str(tmp_path / "mesh_r.obj")
    save_obj(a, ps.meshes[0])
    ref_save_obj(b, rs.meshes[0])
    assert open(a, "rb").read() == open(b, "rb").read()


def _world_soup(scene):
    """Instance-flattened world triangle soup with each triangle's
    material parameters, sorted (tests/unit/test_export.py)."""
    from tpurt_torch.bvh.paircluster import flatten_world_tris

    v0, v1, v2, tri_id, inst_id = flatten_world_tris(None, scene_meta(scene),
                                                     scene)
    tri_mat = np.concatenate([m.material_ids for m in scene.meshes])
    inst_over = np.asarray([i.material_override for i in scene.instances],
                           np.int32)
    mid = np.where(inst_over[inst_id] >= 0, inst_over[inst_id],
                   tri_mat[tri_id])
    mats = np.asarray([[scene.materials[j].kind, *scene.materials[j].albedo,
                        *scene.materials[j].emission,
                        scene.materials[j].param0, scene.materials[j].param1]
                       for j in mid], np.float32)
    soup = np.concatenate([v0, v1, v2, mats], axis=1)
    return soup[np.lexsort(soup.T[::-1])]


def test_obj_roundtrip_bunny_full_scale(tmp_path):
    """The bunny preset (~82k triangles) through export and the native
    OBJ parser: the world soup bit-exact, camera and background kept."""
    scene = port_proc.bunny_standin()
    assert scene.num_triangles > 70_000
    path = str(tmp_path / "bunny.obj")
    export_scene(path, scene)
    loaded = load_scene(path)
    loaded.validate()
    assert loaded.num_triangles == sum(
        scene.meshes[i.mesh_id].num_triangles for i in scene.instances)
    np.testing.assert_array_equal(_world_soup(loaded), _world_soup(scene))
    for f in ("position", "look_at", "up", "vfov_deg"):
        np.testing.assert_array_equal(np.asarray(getattr(loaded.camera, f)),
                                      np.asarray(getattr(scene.camera, f)))
    assert loaded.background == pytest.approx(scene.background)


def test_glb_roundtrip_sponza_full_scale(tmp_path):
    """The sponza preset (~230k instanced triangles, 126 instances)
    through the GLB writer and reader: the world soup bit-exact."""
    scene = port_proc.sponza_standin()
    meta = scene_meta(scene)
    assert sum(meta.mesh_tri_ranges[m][1] for m in meta.inst_mesh) > 200_000
    path = str(tmp_path / "sponza.glb")
    export_scene(path, scene)
    loaded = load_scene(path)
    loaded.validate()
    assert len(loaded.instances) >= len(scene.instances) > 100
    np.testing.assert_array_equal(_world_soup(loaded), _world_soup(scene))
    for f in ("position", "look_at", "up", "vfov_deg"):
        np.testing.assert_array_equal(np.asarray(getattr(loaded.camera, f)),
                                      np.asarray(getattr(scene.camera, f)))
    assert loaded.background == pytest.approx(scene.background)


def test_export_rejects_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="unknown export format"):
        export_scene(str(tmp_path / "x.ply"), port_proc.hello_triangle())
    with pytest.raises(ValueError, match="unknown scene"):
        load_scene(str(tmp_path / "x.ply"))

