"""Scene exporters — port of ``tpurt.scene.export``: glTF 2.0 (.glb and
.gltf) and Wavefront OBJ (+ MTL).

The presets are procedural stand-ins for the demo assets; these writers
materialize them as standard files, which the loaders
(``scene.obj``, ``scene.gltf``) read back (``python -m tpurt_torch
export``). The files are byte-equal to the reference's for the same
scene.

Fidelity:
  * GLB: lossless round trip. Geometry, indices and transforms are binary
    float32; the exact material parameters ride in glTF ``extras`` beside
    a pbrMetallicRoughness approximation for other viewers; the camera
    and background ride in extras plus a standard glTF camera node.
    Textures and UVs are not written.
  * OBJ: a world-space bake (OBJ has no instancing). Materials map onto
    Kd/Ke/Ns/Ks/Ni/illum as ``scene.obj.parse_mtl`` inverts them; the
    camera and background ride in ``# tpurt_camera`` header comments.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import List

import numpy as np

from tpurt_torch.scene.types import (
    BLINN_PHONG,
    DIELECTRIC,
    LAMBERT,
    MIRROR,
    Material,
    Mesh,
    Scene,
)

# ---------------------------------------------------------------------------
# glTF 2.0 (.glb)
# ---------------------------------------------------------------------------


def _gltf_material(m: Material) -> dict:
    """Material → glTF material dict.

    The pbrMetallicRoughness factors invert
    ``scene.gltf._material_from_gltf``'s kind mapping, so even without
    the extras block the round trip keeps the material kind; the extras
    block keeps the parameters bit for bit.
    """
    base = [float(c) for c in m.albedo] + [1.0]
    if m.kind == MIRROR:
        pbr = {
            "baseColorFactor": base,
            "metallicFactor": 1.0,
            # loader requires roughness < 0.35 for the MIRROR mapping and
            # reads param0 (fuzz) back from roughnessFactor
            "roughnessFactor": min(float(m.param0), 0.34),
        }
    elif m.kind == BLINN_PHONG:
        # loader: shininess = 2 / roughness²  ⇒  roughness = sqrt(2/Ns)
        rough = float(np.sqrt(2.0 / max(m.param0, 2.0)))
        pbr = {
            "baseColorFactor": base,
            "metallicFactor": 0.0,
            "roughnessFactor": min(rough, 0.59),
        }
    else:  # LAMBERT / DIELECTRIC (no standard mapping for dielectric)
        pbr = {
            "baseColorFactor": base,
            "metallicFactor": 0.0,
            "roughnessFactor": 1.0,
        }
    gm = {"name": m.name, "pbrMetallicRoughness": pbr}
    strength = max(float(e) for e in m.emission)
    if strength > 0.0:
        gm["emissiveFactor"] = [float(e) / strength for e in m.emission]
        if strength != 1.0:
            gm["extensions"] = {
                "KHR_materials_emissive_strength": {
                    "emissiveStrength": strength
                }
            }
    cutoff = float(getattr(m, "alpha_cutoff", 0.0))
    if cutoff > 0.0:
        gm["alphaMode"] = "MASK"
        gm["alphaCutoff"] = cutoff
    gm["extras"] = {
        "tpurt": {
            "kind": int(m.kind),
            "albedo": [float(c) for c in m.albedo],
            "emission": [float(e) for e in m.emission],
            "param0": float(m.param0),
            "param1": float(m.param1),
            "alpha_cutoff": cutoff,
        }
    }
    return gm


class _BinBuilder:
    """Accumulates the single GLB binary buffer + bufferViews/accessors."""

    def __init__(self):
        self.blob = bytearray()
        self.views: List[dict] = []
        self.accessors: List[dict] = []

    def _add_view(self, data: bytes, target: int) -> int:
        while len(self.blob) % 4:
            self.blob.append(0)
        self.views.append(
            {
                "buffer": 0,
                "byteOffset": len(self.blob),
                "byteLength": len(data),
                "target": target,
            }
        )
        self.blob.extend(data)
        return len(self.views) - 1

    def vec3(self, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr, np.float32)
        view = self._add_view(arr.tobytes(), 34962)  # ARRAY_BUFFER
        self.accessors.append(
            {
                "bufferView": view,
                "componentType": 5126,
                "count": int(arr.shape[0]),
                "type": "VEC3",
                "min": [float(x) for x in arr.min(0)],
                "max": [float(x) for x in arr.max(0)],
            }
        )
        return len(self.accessors) - 1

    def indices(self, idx: np.ndarray) -> int:
        idx = np.ascontiguousarray(idx.reshape(-1), np.uint32)
        view = self._add_view(idx.tobytes(), 34963)  # ELEMENT_ARRAY_BUFFER
        self.accessors.append(
            {
                "bufferView": view,
                "componentType": 5125,
                "count": int(idx.shape[0]),
                "type": "SCALAR",
            }
        )
        return len(self.accessors) - 1


def save_glb(path: str, scene: Scene) -> None:
    """Write a Scene as a self-contained binary glTF (.glb).

    Per-triangle material ids are expressed by splitting each mesh into
    one primitive per distinct material (glTF materials are
    per-primitive); instances become nodes carrying the 3×4 affine as a
    column-major 4×4 ``matrix``.
    """
    bin_b = _BinBuilder()
    materials = [_gltf_material(m) for m in scene.materials]

    gltf_meshes = []
    for mesh in scene.meshes:
        prims = []
        mats = mesh.material_ids
        nrm = mesh.normals
        for mat_id in sorted(set(int(x) for x in mats)):
            fmask = mats == mat_id
            tri = mesh.indices[fmask]
            # compact the vertex range used by this primitive
            uniq, inv = np.unique(tri.reshape(-1), return_inverse=True)
            attrs = {"POSITION": bin_b.vec3(mesh.vertices[uniq])}
            if nrm is not None:
                attrs["NORMAL"] = bin_b.vec3(nrm[uniq])
            prim = {
                "attributes": attrs,
                "indices": bin_b.indices(inv.astype(np.uint32)),
                "mode": 4,
            }
            if 0 <= mat_id < len(materials):
                prim["material"] = mat_id
            prims.append(prim)
        gltf_meshes.append({"name": mesh.name, "primitives": prims})

    nodes = []
    for inst in scene.instances:
        m4 = np.eye(4, dtype=np.float32)
        m4[:3, :] = inst.transform
        node = {
            "name": inst.name,
            "mesh": int(inst.mesh_id),
            # glTF matrices are column-major flattened
            "matrix": [float(x) for x in m4.T.reshape(-1)],
        }
        if inst.material_override >= 0:
            node.setdefault("extras", {})["tpurt_material_override"] = int(
                inst.material_override
            )
        nodes.append(node)

    cameras = []
    if scene.camera is not None:
        cam = scene.camera
        pos = np.asarray(cam.position, np.float32)
        look = np.asarray(cam.look_at, np.float32)
        up = np.asarray(cam.up, np.float32)
        vfov = float(cam.vfov_deg)
        # standard glTF camera node (looks down its −Z): basis from the
        # pinhole frame
        fwd = look - pos
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        m4 = np.eye(4, dtype=np.float32)
        m4[:3, 0] = right
        m4[:3, 1] = true_up
        m4[:3, 2] = -fwd
        m4[:3, 3] = pos
        cameras.append(
            {
                "type": "perspective",
                "perspective": {
                    "yfov": float(np.deg2rad(np.float32(vfov))),
                    "znear": 0.001,
                },
            }
        )
        nodes.append(
            {
                "name": "tpurt_camera",
                "camera": 0,
                "matrix": [float(x) for x in m4.T.reshape(-1)],
                "extras": {
                    "tpurt_camera": {
                        "position": [float(x) for x in pos],
                        "look_at": [float(x) for x in look],
                        "up": [float(x) for x in up],
                        "vfov_deg": vfov,
                    }
                },
            }
        )

    doc = {
        "asset": {"version": "2.0", "generator": "tpurt"},
        "scene": 0,
        "scenes": [
            {
                "nodes": list(range(len(nodes))),
                "extras": {
                    "tpurt_background": [float(c) for c in scene.background]
                },
            }
        ],
        "nodes": nodes,
        "meshes": gltf_meshes,
        "materials": materials,
        "buffers": [{"byteLength": len(bin_b.blob)}],
        "bufferViews": bin_b.views,
        "accessors": bin_b.accessors,
    }
    if cameras:
        doc["cameras"] = cameras
    if any("extensions" in m for m in materials):
        doc["extensionsUsed"] = ["KHR_materials_emissive_strength"]

    json_chunk = json.dumps(doc, separators=(",", ":")).encode()
    json_chunk += b" " * ((-len(json_chunk)) % 4)
    bin_chunk = bytes(bin_b.blob) + b"\x00" * ((-len(bin_b.blob)) % 4)
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)


def save_gltf(path: str, scene: Scene) -> None:
    """.gltf (JSON with a data-URI buffer) variant of save_glb."""
    tmp = path + ".glb.tmp"
    save_glb(tmp, scene)
    with open(tmp, "rb") as f:
        raw = f.read()
    os.remove(tmp)
    from tpurt_torch.scene.gltf import _parse_glb

    doc, bin_chunk = _parse_glb(raw)
    doc["buffers"][0]["uri"] = (
        "data:application/octet-stream;base64,"
        + base64.b64encode(bin_chunk).decode()
    )
    with open(path, "w") as f:
        json.dump(doc, f)


# ---------------------------------------------------------------------------
# Wavefront OBJ (+ MTL)
# ---------------------------------------------------------------------------


def _mtl_entry(name: str, m: Material) -> str:
    """One MTL record, written so ``scene.obj.parse_mtl`` inverts it
    exactly (key order matters: Ns before Ks; Ni before illum)."""
    lines = [f"newmtl {name}"]
    lines.append(f"Kd {m.albedo[0]} {m.albedo[1]} {m.albedo[2]}")
    if any(e > 0 for e in m.emission):
        lines.append(f"Ke {m.emission[0]} {m.emission[1]} {m.emission[2]}")
    if m.kind == BLINN_PHONG:
        lines.append(f"Ns {m.param0}")
        lines.append(f"Ks {m.param1} {m.param1} {m.param1}")
        lines.append("illum 2")
    elif m.kind == MIRROR:
        lines.append("illum 5")  # parser: kind=MIRROR, param0=0 (fuzz lost)
    elif m.kind == DIELECTRIC:
        lines.append(f"Ni {m.param0}")
        lines.append("illum 7")
    else:
        lines.append("illum 1")
    return "\n".join(lines) + "\n"


def save_obj_scene(path: str, scene: Scene) -> None:
    """Write a whole Scene as OBJ + MTL, instances baked to world space
    (OBJ has no instancing). Floats print with numpy's shortest-roundtrip
    repr, so reloading reproduces the float32 world geometry bit-exactly.
    """
    stem = os.path.splitext(path)[0]
    mtl_path = stem + ".mtl"
    mat_names = []
    used = set()
    for i, m in enumerate(scene.materials):
        base = "".join(
            c if c.isalnum() or c in "_-" else "_" for c in (m.name or "mat")
        )
        name = base
        if name in used:
            name = f"{base}_{i}"
        used.add(name)
        mat_names.append(name)
    with open(mtl_path, "w") as f:
        f.write("# tpurt MTL export\n")
        for name, m in zip(mat_names, scene.materials):
            f.write(_mtl_entry(name, m))

    with open(path, "w") as f:
        f.write(f"# tpurt OBJ export: {scene.name}\n")
        if scene.camera is not None:
            cam = scene.camera
            vals = [
                *np.asarray(cam.position, np.float32),
                *np.asarray(cam.look_at, np.float32),
                *np.asarray(cam.up, np.float32),
                np.float32(float(cam.vfov_deg)),
            ]
            f.write("# tpurt_camera " + " ".join(str(v) for v in vals) + "\n")
        f.write(
            "# tpurt_background "
            + " ".join(str(np.float32(c)) for c in scene.background)
            + "\n"
        )
        f.write(f"mtllib {os.path.basename(mtl_path)}\n")
        v_off = 1
        n_off = 1
        for k, inst in enumerate(scene.instances):
            mesh = scene.meshes[inst.mesh_id]
            tf = inst.transform
            verts = (mesh.vertices @ tf[:, :3].T + tf[:, 3]).astype(
                np.float32
            )
            nrm = (
                mesh.normals
                if mesh.normals is not None
                else mesh.compute_vertex_normals()
            )
            nrm_mat = np.linalg.inv(tf[:, :3]).T
            wn = nrm @ nrm_mat.T
            wn = (
                wn / np.maximum(np.linalg.norm(wn, axis=1, keepdims=True),
                                1e-20)
            ).astype(np.float32)
            f.write(f"o {inst.name or mesh.name or f'inst{k}'}\n")
            for v in verts:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for n in wn:
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
            mats = mesh.material_ids
            if inst.material_override >= 0:
                mats = np.full_like(mats, inst.material_override)
            # contiguous runs of one material share a usemtl block
            cur = None
            for t, tri in enumerate(mesh.indices):
                mid = int(mats[t])
                if mid != cur:
                    f.write(f"usemtl {mat_names[mid]}\n")
                    cur = mid
                a, b, c = (int(x) for x in tri)
                f.write(
                    f"f {a + v_off}//{a + n_off} {b + v_off}//{b + n_off} "
                    f"{c + v_off}//{c + n_off}\n"
                )
            v_off += verts.shape[0]
            n_off += wn.shape[0]


def export_scene(path: str, scene: Scene) -> None:
    """Format-sniffing export entry point (.obj / .gltf / .glb)."""
    lower = path.lower()
    if lower.endswith(".obj"):
        save_obj_scene(path, scene)
    elif lower.endswith(".glb"):
        save_glb(path, scene)
    elif lower.endswith(".gltf"):
        save_gltf(path, scene)
    else:
        raise ValueError(f"unknown export format for {path!r}")
