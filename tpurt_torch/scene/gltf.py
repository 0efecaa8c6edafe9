"""Minimal glTF 2.0 loader — port of ``tpurt.scene.gltf`` (numpy).

.gltf (JSON, external or data-URI buffers) and .glb (binary container);
POSITION, NORMAL and TEXCOORD_0 attributes; indexed and non-indexed
triangle primitives; pbrMetallicRoughness mapped onto the four material
families; PNG base-color images decoded to linear textures (alpha kept);
``alphaMode`` MASK (with ``alphaCutoff``) and BLEND as alpha cutout; and
the node hierarchy (matrix or TRS) flattened into per-primitive
instances. The exact parameters ``scene.export`` writes in ``extras``
round-trip losslessly.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional

import numpy as np

from tpurt_torch.scene.types import (
    BLINN_PHONG,
    LAMBERT,
    MIRROR,
    Material,
    Mesh,
    Scene,
    Instance,
)

_COMPONENT_DTYPE = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_buffers(doc: dict, base_dir: str, glb_bin: Optional[bytes]) -> List[bytes]:
    bufs = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if glb_bin is None:
                raise ValueError("glTF buffer has no uri and no GLB BIN chunk")
            bufs.append(glb_bin)
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                bufs.append(f.read())
    return bufs


def _read_accessor(doc: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    n_comp = _TYPE_COUNT[acc["type"]]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    count = acc["count"]
    if "bufferView" not in acc:
        return np.zeros((count, n_comp), dtype)
    view = doc["bufferViews"][acc["bufferView"]]
    data = buffers[view["buffer"]]
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    itemsize = np.dtype(dtype).itemsize * n_comp
    stride = view.get("byteStride", itemsize)
    if stride == itemsize:
        out = np.frombuffer(data, dtype, count * n_comp, start).reshape(count, n_comp)
    else:  # interleaved
        raw = np.frombuffer(
            data, np.uint8, stride * (count - 1) + itemsize, start
        )
        out = np.lib.stride_tricks.as_strided(
            raw.view(dtype), shape=(count, n_comp), strides=(stride, np.dtype(dtype).itemsize)
        ).copy()
    return out


def _node_matrix(node: dict) -> np.ndarray:
    """Node local transform as a 4x4 (glTF stores column-major)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        m[:3, :3] = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ],
            np.float32,
        )
    if "scale" in node:
        m[:3, :3] = m[:3, :3] * np.asarray(node["scale"], np.float32)[None, :]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _parse_glb(data: bytes):
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    offset = 12
    doc, bin_chunk = None, None
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8 : offset + 8 + chunk_len]
        if chunk_type == 0x4E4F534A:  # 'JSON'
            doc = json.loads(chunk)
        elif chunk_type == 0x004E4942:  # 'BIN'
            bin_chunk = chunk
        offset += 8 + chunk_len + (-chunk_len) % 4
    if doc is None:
        raise ValueError("GLB missing JSON chunk")
    return doc, bin_chunk


def _load_images(doc: dict, buffers: List[bytes], base_dir: str,
                 scene: Scene) -> List[int]:
    """glTF images → Scene.textures (PNG only — other sources get a white
    1×1 stand-in). Returns image index → texture id."""
    from tpurt_torch.render.png import decode_png, srgb_to_linear

    ids = []
    for img in doc.get("images", []):
        data = None
        uri = img.get("uri")
        if uri is not None:
            if uri.startswith("data:"):
                data = base64.b64decode(uri.split(",", 1)[1])
            else:
                p = os.path.join(base_dir, uri)
                if os.path.exists(p):
                    with open(p, "rb") as f:
                        data = f.read()
        elif "bufferView" in img:
            view = doc["bufferViews"][img["bufferView"]]
            start = view.get("byteOffset", 0)
            data = buffers[view["buffer"]][
                start:start + view["byteLength"]
            ]
        tex = np.ones((1, 1, 3), np.float32)
        if data is not None and data[:8] == b"\x89PNG\r\n\x1a\n":
            raw_img = decode_png(data, keep_alpha=True)
            tex = srgb_to_linear(raw_img[..., :3])
            if raw_img.shape[2] == 4:
                # alpha is stored LINEAR in glTF (only RGB is sRGB)
                tex = np.concatenate(
                    [tex, raw_img[..., 3:4].astype(np.float32) / 255.0],
                    axis=2,
                )
        ids.append(scene.add_texture(tex))
    return ids


def _material_from_gltf(gm: dict) -> Material:
    # exact parameters, written by scene.export in the glTF
    # application-specific ``extras``: a lossless round trip
    tp = gm.get("extras", {}).get("tpurt")
    # alphaMode MASK: an alpha-tested material; BLEND is approximated as
    # MASK at 0.5 (no transparency sorting)
    mode = gm.get("alphaMode", "OPAQUE")
    cutoff = (float(gm.get("alphaCutoff", 0.5)) if mode == "MASK"
              else (0.5 if mode == "BLEND" else 0.0))
    if tp is not None:
        return Material(
            kind=int(tp["kind"]),
            albedo=tuple(tp["albedo"]),
            emission=tuple(tp["emission"]),
            param0=float(tp["param0"]),
            param1=float(tp["param1"]),
            alpha_cutoff=float(tp.get("alpha_cutoff", cutoff)),
            name=gm.get("name", ""),
        )
    pbr = gm.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])[:3]
    metallic = pbr.get("metallicFactor", 1.0)
    roughness = pbr.get("roughnessFactor", 1.0)
    emissive = gm.get("emissiveFactor", [0.0, 0.0, 0.0])
    strength = gm.get("extensions", {}).get(
        "KHR_materials_emissive_strength", {}
    ).get("emissiveStrength", 1.0)
    emission = tuple(float(e) * strength for e in emissive)
    if metallic > 0.7 and roughness < 0.35:
        return Material(MIRROR, tuple(base), emission, param0=roughness,
                        alpha_cutoff=cutoff, name=gm.get("name", ""))
    if roughness < 0.6:
        shininess = max(2.0 / max(roughness, 1e-3) ** 2, 2.0)
        return Material(BLINN_PHONG, tuple(base), emission, param0=shininess,
                        param1=0.4 * (1.0 - roughness), alpha_cutoff=cutoff,
                        name=gm.get("name", ""))
    return Material(LAMBERT, tuple(base), emission, alpha_cutoff=cutoff,
                    name=gm.get("name", ""))


def load_gltf(path: str, scene: Optional[Scene] = None) -> Scene:
    """Load a .gltf/.glb file: meshes + materials + node transforms →
    Scene meshes/instances."""
    if scene is None:
        scene = Scene(name=os.path.basename(path))
    base_dir = os.path.dirname(path)
    with open(path, "rb") as f:
        raw = f.read()
    if path.endswith(".glb") or raw[:4] == b"glTF":
        doc, glb_bin = _parse_glb(raw)
    else:
        doc, glb_bin = json.loads(raw), None
    buffers = _load_buffers(doc, base_dir, glb_bin)

    image_tex_ids = _load_images(doc, buffers, base_dir, scene)

    def _texture_id(tex_index: int) -> int:
        textures = doc.get("textures", [])
        if not (0 <= tex_index < len(textures)):
            return -1
        src = textures[tex_index].get("source", -1)
        if not (0 <= src < len(image_tex_ids)):
            return -1
        return image_tex_ids[src]

    mat_ids = []
    for gm in doc.get("materials", []):
        mat = _material_from_gltf(gm)
        bct = gm.get("pbrMetallicRoughness", {}).get("baseColorTexture")
        if bct is not None:
            mat.base_color_texture = _texture_id(bct.get("index", -1))
        mat_ids.append(scene.add_material(mat))
    default_mat = scene.add_material(Material(name="gltf_default"))

    # mesh → list of (tpurt mesh id) one per primitive
    prim_mesh_ids: Dict[int, List[int]] = {}
    for mi, gm in enumerate(doc.get("meshes", [])):
        ids = []
        for pi, prim in enumerate(gm.get("primitives", [])):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            nrm = None
            if "NORMAL" in attrs:
                nrm = _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
            uv = None
            if "TEXCOORD_0" in attrs:
                acc = doc["accessors"][attrs["TEXCOORD_0"]]
                uv = _read_accessor(
                    doc, buffers, attrs["TEXCOORD_0"]
                ).astype(np.float32)
                # normalized integer texcoords (glTF 2.0 §3.6.2.2)
                comp = acc["componentType"]
                if comp == 5121:
                    uv = uv / 255.0
                elif comp == 5123:
                    uv = uv / 65535.0
            if "indices" in prim:
                idx = _read_accessor(doc, buffers, prim["indices"]).reshape(-1)
            else:
                idx = np.arange(pos.shape[0], dtype=np.int64)
            idx = idx.astype(np.int32).reshape(-1, 3)
            mat = (
                mat_ids[prim["material"]]
                if "material" in prim and prim["material"] < len(mat_ids)
                else default_mat
            )
            mesh = Mesh(pos, idx, mat, normals=nrm, uvs=uv,
                        name=f"{gm.get('name', f'mesh{mi}')}/p{pi}")
            ids.append(scene.add_mesh(mesh))
        prim_mesh_ids[mi] = ids

    nodes = doc.get("nodes", [])
    scene_idx = doc.get("scene", 0)
    roots = (
        doc["scenes"][scene_idx].get("nodes", list(range(len(nodes))))
        if doc.get("scenes")
        else list(range(len(nodes)))
    )

    def walk(node_idx: int, parent: np.ndarray):
        node = nodes[node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            override = int(
                node.get("extras", {}).get("tpurt_material_override", -1)
            )
            for mesh_id in prim_mesh_ids.get(node["mesh"], []):
                scene.add_instance(
                    Instance(mesh_id, world[:3, :].astype(np.float32),
                             material_override=override,
                             name=node.get("name", f"node{node_idx}"))
                )
        if "camera" in node and scene.camera is None:
            from tpurt_torch.core.camera import Camera

            tc = node.get("extras", {}).get("tpurt_camera")
            if tc is not None:  # exact (written by scene.export)
                scene.camera = Camera.make(
                    tc["position"], tc["look_at"], tc["up"],
                    tc["vfov_deg"],
                )
            else:  # standard glTF camera: node looks down its −Z
                gcam = doc.get("cameras", [])[node["camera"]]
                persp = gcam.get("perspective", {})
                pos = world[:3, 3]
                fwd = -world[:3, 2]
                up = world[:3, 1]
                scene.camera = Camera.make(
                    pos, pos + fwd, up,
                    float(np.rad2deg(persp.get("yfov", 0.8))),
                )
        for child in node.get("children", []):
            walk(child, world)

    for r in roots:
        walk(r, np.eye(4, dtype=np.float32))
    if doc.get("scenes"):
        bg = (
            doc["scenes"][scene_idx]
            .get("extras", {})
            .get("tpurt_background")
        )
        if bg is not None:
            scene.background = tuple(float(c) for c in bg)
    if not scene.instances and scene.meshes:
        for mid in range(len(scene.meshes)):
            scene.add_instance(Instance(mid))
    return scene
