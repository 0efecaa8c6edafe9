"""Wavefront OBJ (+ MTL) loader — port of ``tpurt.scene.obj`` (numpy).

Supports ``v``, ``vt``, ``vn``, ``f`` (v, v/vt, v//vn and v/vt/vn forms,
negative indices, polygon fan triangulation), ``o``/``g`` grouping,
``usemtl`` + ``mtllib`` with Kd/Ke/Ns/Ks/Ni/illum and ``map_Kd`` PNG
textures, and the ``# tpurt_camera`` / ``# tpurt_background`` header
comments that ``scene.export.save_obj_scene`` writes. Unknown directives
are ignored.

Untextured files parse their geometry through the native host library
(``utils.native.obj_parse``) when it loads; the Python parser here is its
twin and the path for textured files (the native parser reads no ``vt``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tpurt_torch.scene.types import (
    BLINN_PHONG,
    DIELECTRIC,
    LAMBERT,
    MIRROR,
    Material,
    Mesh,
    Scene,
    Instance,
)


def parse_mtl(path: str) -> Dict[str, Material]:
    """Parse a .mtl file into Material records."""
    mats: Dict[str, Material] = {}
    cur: Optional[Material] = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "newmtl":
                cur = Material(name=tok[1] if len(tok) > 1 else "")
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif key == "Kd":
                cur.albedo = tuple(float(x) for x in tok[1:4])
            elif key == "map_Kd" and len(tok) > 1:
                # base-color texture file (options ignored; last token is
                # the path). Resolved relative to the MTL file by load_obj.
                cur.map_kd = os.path.join(os.path.dirname(path), tok[-1])
            elif key == "Ke":
                cur.emission = tuple(float(x) for x in tok[1:4])
            elif key == "Ns":
                # Shininess > 1 ⇒ Blinn-Phong unless overridden by illum.
                cur.param0 = float(tok[1])
                if cur.kind == LAMBERT and cur.param0 > 1.0:
                    cur.kind = BLINN_PHONG
                    cur.param1 = max(cur.param1, 0.3)
            elif key == "Ks" and len(tok) >= 4:
                cur.param1 = float(np.mean([float(x) for x in tok[1:4]]))
            elif key == "Ni":
                ior = float(tok[1])
                if abs(ior - 1.0) > 1e-3:
                    cur.param0 = ior
            elif key == "illum":
                illum = int(float(tok[1]))
                if illum in (3, 5):  # reflective
                    cur.kind = MIRROR
                    cur.param0 = 0.0
                elif illum in (4, 6, 7, 9):  # refractive glass
                    cur.kind = DIELECTRIC
                    if cur.param0 <= 1.0:
                        cur.param0 = 1.5
    return mats


def _parse_tpurt_headers(path: str, scene: Scene) -> None:
    """Read optional ``# tpurt_camera`` / ``# tpurt_background`` header
    comments (written by ``scene.export.save_obj_scene``: OBJ has no
    camera or environment). Only the file head is scanned."""
    try:
        with open(path, "r", errors="replace") as f:
            for _ in range(16):
                line = f.readline()
                if not line:
                    break
                tok = line.split()
                if len(tok) >= 12 and tok[:2] == ["#", "tpurt_camera"]:
                    from tpurt_torch.core.camera import Camera

                    v = [float(x) for x in tok[2:13]]
                    scene.camera = Camera.make(
                        v[0:3], v[3:6], v[6:9], v[9]
                    )
                elif len(tok) >= 5 and tok[:2] == ["#", "tpurt_background"]:
                    scene.background = tuple(float(x) for x in tok[2:5])
    except OSError:
        pass


def _parse_face_vert(token: str, nv: int, nt: int,
                     nn: int) -> Tuple[int, int, int]:
    """'v', 'v/vt', 'v//vn', 'v/vt/vn' → (vertex, texcoord, normal)
    indices; -1 marks an absent texcoord/normal."""
    parts = token.split("/")
    vi = int(parts[0])
    vi = vi - 1 if vi > 0 else nv + vi
    ti = -1
    if len(parts) >= 2 and parts[1]:
        ti = int(parts[1])
        ti = ti - 1 if ti > 0 else nt + ti
    ni = -1
    if len(parts) == 3 and parts[2]:
        ni = int(parts[2])
        ni = ni - 1 if ni > 0 else nn + ni
    return vi, ti, ni


def load_obj(path: str, scene: Optional[Scene] = None,
             default_material: Optional[Material] = None) -> Scene:
    """Load an OBJ file into a (new or existing) Scene as one mesh + instance.

    Each distinct (position, texcoord, normal) corner becomes one output
    vertex (OBJ's triple indexing flattened), so the device packer stays
    a plain SoA gather. Geometry parses natively when the host library
    loads and no material has a ``map_Kd``; this Python parser is the
    twin.
    """
    if scene is None:
        scene = Scene(name=os.path.basename(path))
    if default_material is None:
        default_material = Material(name="obj_default")
    cur_mat = scene.add_material(default_material)
    _parse_tpurt_headers(path, scene)

    from tpurt_torch.utils import native

    parsed = native.obj_parse(path)
    if parsed is not None:
        verts_np, normals_np, tri_v, tri_n, face_slot, names, mtllib = parsed
        mtl = (
            parse_mtl(os.path.join(os.path.dirname(path), mtllib))
            if mtllib else {}
        )
        if any(getattr(m, "map_kd", None) for m in mtl.values()):
            parsed = None  # textured: needs vt — the Python path below
    if parsed is not None:
        if tri_v.shape[0] == 0:
            raise ValueError(f"OBJ {path!r} contains no faces")
        slot_to_mat = np.asarray(
            [scene.add_material(mtl.get(n, Material(name=n)))
             for n in names] + [cur_mat],
            np.int32,
        )
        face_mats_arr = slot_to_mat[
            np.where(face_slot >= 0, face_slot, len(names))
        ]
        zeros = np.full(tri_v.size, -1, np.int64)
        corner_arr = np.stack(
            [tri_v.reshape(-1).astype(np.int64), zeros,
             tri_n.reshape(-1).astype(np.int64)], axis=1
        )
        return _finish_obj(
            scene, path, verts_np,
            normals_np if normals_np.shape[0] else None,
            None, corner_arr, face_mats_arr,
        )

    positions: List[List[float]] = []
    texcoords: List[List[float]] = []
    normals: List[List[float]] = []
    # corner stream: (vi, ti, ni) and per-face material id
    corners: List[Tuple[int, int, int]] = []
    face_mats: List[int] = []
    mat_lookup: Dict[str, int] = {}

    def _add_material(name: str, mat: Material) -> int:
        # load map_Kd lazily, once per material, sharing texture ids
        kd = getattr(mat, "map_kd", None)
        if kd and mat.base_color_texture < 0 and os.path.exists(kd):
            from tpurt_torch.render.png import decode_png, srgb_to_linear

            try:
                with open(kd, "rb") as tf:
                    mat.base_color_texture = scene.add_texture(
                        srgb_to_linear(decode_png(tf.read()))
                    )
            except ValueError:
                pass  # non-PNG map: shade untextured
        return scene.add_material(mat)

    mtl: Dict[str, Material] = {}
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "v":
                positions.append([float(x) for x in tok[1:4]])
            elif key == "vt":
                # OBJ v runs bottom-up; device convention is v-down (glTF)
                texcoords.append([float(tok[1]), 1.0 - float(tok[2])])
            elif key == "vn":
                normals.append([float(x) for x in tok[1:4]])
            elif key == "mtllib" and len(tok) > 1:
                mtl.update(
                    parse_mtl(os.path.join(os.path.dirname(path), tok[1]))
                )
            elif key == "usemtl" and len(tok) > 1:
                name = tok[1]
                if name not in mat_lookup:
                    mat_lookup[name] = _add_material(
                        name, mtl.get(name, Material(name=name))
                    )
                cur_mat = mat_lookup[name]
            elif key == "f":
                nv, nt, nn = len(positions), len(texcoords), len(normals)
                fv = [_parse_face_vert(t, nv, nt, nn) for t in tok[1:]]
                for k in range(1, len(fv) - 1):  # fan triangulation
                    corners += [fv[0], fv[k], fv[k + 1]]
                    face_mats.append(cur_mat)

    if not corners:
        raise ValueError(f"OBJ {path!r} contains no faces")

    pos = np.asarray(positions, np.float32)
    uv = np.asarray(texcoords, np.float32) if texcoords else None
    nrm = np.asarray(normals, np.float32) if normals else None
    return _finish_obj(
        scene, path, pos, nrm, uv, np.asarray(corners, np.int64),
        np.asarray(face_mats, np.int32),
    )


def _finish_obj(scene: Scene, path: str, pos: np.ndarray,
                nrm: Optional[np.ndarray], uv: Optional[np.ndarray],
                corner_arr: np.ndarray,
                face_mats: np.ndarray) -> Scene:
    """Shared tail: flatten dual indexing, register mesh + instance."""
    # Flatten OBJ's triple indexing: unique (vi, ti, ni) become vertices.
    uniq, inverse = np.unique(corner_arr, axis=0, return_inverse=True)
    verts = pos[uniq[:, 0]]
    indices = inverse.reshape(-1, 3).astype(np.int32)
    out_uvs = None
    if uv is not None and (uniq[:, 1] >= 0).any():
        out_uvs = np.where(
            (uniq[:, 1] >= 0)[:, None],
            uv[np.maximum(uniq[:, 1], 0)], 0.0
        ).astype(np.float32)
    out_normals = None
    if nrm is not None and (uniq[:, 2] >= 0).all():
        out_normals = nrm[uniq[:, 2]]
        ln = np.linalg.norm(out_normals, axis=1, keepdims=True)
        out_normals = (out_normals / np.maximum(ln, 1e-20)).astype(np.float32)

    mesh = Mesh(
        verts,
        indices,
        np.asarray(face_mats, np.int32),
        normals=out_normals,
        uvs=out_uvs,
        name=os.path.basename(path),
    )
    mid = scene.add_mesh(mesh)
    scene.add_instance(Instance(mid, name=mesh.name))
    return scene


def save_obj(path: str, mesh: Mesh) -> None:
    """Write a Mesh back out (used to generate loader test fixtures)."""
    with open(path, "w") as f:
        f.write(f"# tpurt OBJ export: {mesh.name}\n")
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        has_uv = mesh.uvs is not None
        if has_uv:
            for t in mesh.uvs:
                # device convention is v-down; OBJ vt runs bottom-up
                f.write(f"vt {t[0]} {1.0 - t[1]}\n")
        if mesh.normals is not None:
            for n in mesh.normals:
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
            for t in mesh.indices:
                c = [t[0] + 1, t[1] + 1, t[2] + 1]
                if has_uv:
                    f.write(f"f {c[0]}/{c[0]}/{c[0]} {c[1]}/{c[1]}/{c[1]}"
                            f" {c[2]}/{c[2]}/{c[2]}\n")
                else:
                    f.write(f"f {c[0]}//{c[0]} {c[1]}//{c[1]}"
                            f" {c[2]}//{c[2]}\n")
        elif has_uv:
            for t in mesh.indices:
                c = [t[0] + 1, t[1] + 1, t[2] + 1]
                f.write(f"f {c[0]}/{c[0]} {c[1]}/{c[1]} {c[2]}/{c[2]}\n")
        else:
            for t in mesh.indices:
                f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")
