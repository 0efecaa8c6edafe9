"""Host→device SoA packing — port of ``tpurt.scene.device``.

One pack of the host Scene into flat, padded SoA torch tensors on the
requested device. Triangles are pre-dereferenced (``tri_v0/v1/v2`` hold
vertex positions), meshes share one global triangle address space with
``mesh_tri_offset`` ranges, emissive triangles are pre-expanded per
instance into world space for next-event estimation, and triangle tables
pad to a multiple of ``pad_to`` with degenerate triangles. Every array is
equal to the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch.scene.types import Scene


class DeviceScene(NamedTuple):
    """Flat SoA device-resident scene (field layout of the reference)."""

    # Geometry (object space, all meshes concatenated)
    tri_v0: torch.Tensor  # (T, 3) f32
    tri_v1: torch.Tensor  # (T, 3) f32
    tri_v2: torch.Tensor  # (T, 3) f32
    tri_n0: torch.Tensor  # (T, 3) f32 shading normals at each corner
    tri_n1: torch.Tensor  # (T, 3) f32
    tri_n2: torch.Tensor  # (T, 3) f32
    tri_mat: torch.Tensor  # (T,) i32 material id per triangle
    mesh_tri_offset: torch.Tensor  # (M + 1,) i32 triangle ranges per mesh

    # Instances (world = transform @ [p; 1])
    inst_mesh: torch.Tensor  # (I,) i32
    inst_transform: torch.Tensor  # (I, 3, 4) f32 object→world
    inst_inv: torch.Tensor  # (I, 3, 4) f32 world→object
    inst_nrm: torch.Tensor  # (I, 3, 3) f32 normal matrix (inv-transpose 3x3)
    inst_mat_override: torch.Tensor  # (I,) i32, -1 = none

    # Materials
    mat_kind: torch.Tensor  # (K,) i32
    mat_albedo: torch.Tensor  # (K, 3) f32
    mat_emission: torch.Tensor  # (K, 3) f32
    mat_param0: torch.Tensor  # (K,) f32
    mat_param1: torch.Tensor  # (K,) f32
    mat_texture: torch.Tensor  # (K,) i32 base-color texture id, -1 = none

    # Texture coordinates per triangle corner (zeros when absent)
    tri_uv0: torch.Tensor  # (T, 2) f32
    tri_uv1: torch.Tensor  # (T, 2) f32
    tri_uv2: torch.Tensor  # (T, 2) f32

    # Base-color texture pool: images flattened row-major into one (P, 3)
    # table; tex_meta rows are (row_offset, width, height, 0) as f32.
    tex_data: torch.Tensor  # (P, 3) f32, P >= 1
    tex_meta: torch.Tensor  # (Ntex, 4) f32, Ntex >= 1

    # Emissive triangles in world space (padded to >= 1)
    light_v0: torch.Tensor  # (L, 3) f32
    light_v1: torch.Tensor  # (L, 3) f32
    light_v2: torch.Tensor  # (L, 3) f32
    light_emission: torch.Tensor  # (L, 3) f32
    light_area: torch.Tensor  # (L,) f32 (0 for padding)
    num_lights: torch.Tensor  # () i32

    background: torch.Tensor  # (3,) f32

    # Alpha cutout: per-material cutoff (0 = opaque) and the texture
    # pool's alpha channel ((P,) f32, 1.0 for RGB images and the fallback)
    mat_alpha_cutoff: torch.Tensor  # (K,) f32
    tex_alpha: torch.Tensor  # (P,) f32

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_instances(self) -> int:
        return self.inst_mesh.shape[0]


def _pad_rows(a: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def apply_transform(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Affine (3,4) applied to points (..., 3)."""
    return p @ m[:, :3].T + m[:, 3]


def invert_affine(m: np.ndarray) -> np.ndarray:
    """Inverse of a (3,4) affine transform."""
    r_inv = np.linalg.inv(m[:, :3])
    out = np.zeros((3, 4), np.float32)
    out[:, :3] = r_inv
    out[:, 3] = -r_inv @ m[:, 3]
    return out


def to_device(scene: Scene, device="cpu", pad_to: int = 8) -> DeviceScene:
    """Pack a host Scene into a DeviceScene on ``device``."""
    scene.validate()
    if not scene.instances:
        raise ValueError("scene has no instances")

    v0s, v1s, v2s, n0s, n1s, n2s, mats = [], [], [], [], [], [], []
    uv0s, uv1s, uv2s = [], [], []
    offsets = [0]
    for mesh in scene.meshes:
        v = mesh.vertices
        idx = mesh.indices
        nrm = (mesh.normals if mesh.normals is not None
               else mesh.compute_vertex_normals())
        v0s.append(v[idx[:, 0]])
        v1s.append(v[idx[:, 1]])
        v2s.append(v[idx[:, 2]])
        n0s.append(nrm[idx[:, 0]])
        n1s.append(nrm[idx[:, 1]])
        n2s.append(nrm[idx[:, 2]])
        uv = (mesh.uvs if mesh.uvs is not None
              else np.zeros((v.shape[0], 2), np.float32))
        uv0s.append(uv[idx[:, 0]])
        uv1s.append(uv[idx[:, 1]])
        uv2s.append(uv[idx[:, 2]])
        mats.append(mesh.material_ids)
        offsets.append(offsets[-1] + mesh.num_triangles)

    t_total = offsets[-1]
    t_pad = max(_round_up(t_total, pad_to), pad_to)
    cat = lambda xs: (np.concatenate(xs, axis=0) if xs
                      else np.zeros((0, 3), np.float32))
    tri_v0 = _pad_rows(cat(v0s).astype(np.float32), t_pad)
    tri_v1 = _pad_rows(cat(v1s).astype(np.float32), t_pad)
    tri_v2 = _pad_rows(cat(v2s).astype(np.float32), t_pad)
    tri_n0 = _pad_rows(cat(n0s).astype(np.float32), t_pad)
    tri_n1 = _pad_rows(cat(n1s).astype(np.float32), t_pad)
    tri_n2 = _pad_rows(cat(n2s).astype(np.float32), t_pad)
    tri_mat = _pad_rows(np.concatenate(mats).astype(np.int32), t_pad)
    cat2 = lambda xs: (np.concatenate(xs, axis=0) if xs
                       else np.zeros((0, 2), np.float32))
    tri_uv0 = _pad_rows(cat2(uv0s).astype(np.float32), t_pad)
    tri_uv1 = _pad_rows(cat2(uv1s).astype(np.float32), t_pad)
    tri_uv2 = _pad_rows(cat2(uv2s).astype(np.float32), t_pad)

    inst_mesh = np.array([i.mesh_id for i in scene.instances], np.int32)
    inst_transform = np.stack(
        [i.transform for i in scene.instances]).astype(np.float32)
    inst_inv = np.stack([invert_affine(i.transform) for i in scene.instances])
    inst_nrm = np.stack([
        np.linalg.inv(i.transform[:, :3]).T.astype(np.float32)
        for i in scene.instances
    ])
    inst_mat_override = np.array(
        [i.material_override for i in scene.instances], np.int32
    )

    k = max(len(scene.materials), 1)
    mat_kind = np.zeros(k, np.int32)
    mat_albedo = np.zeros((k, 3), np.float32)
    mat_emission = np.zeros((k, 3), np.float32)
    mat_param0 = np.zeros(k, np.float32)
    mat_param1 = np.zeros(k, np.float32)
    mat_texture = np.full(k, -1, np.int32)
    mat_alpha_cutoff = np.zeros(k, np.float32)
    for j, m in enumerate(scene.materials):
        mat_kind[j] = m.kind
        mat_albedo[j] = m.albedo
        mat_emission[j] = m.emission
        mat_param0[j] = m.param0
        mat_param1[j] = m.param1
        mat_texture[j] = m.base_color_texture
        mat_alpha_cutoff[j] = m.alpha_cutoff

    # Texture pool: row 0 is the white-fallback texel, then every image
    # flattened row-major; meta rows carry (row_offset, W, H).
    tex_rows = [np.ones((1, 3), np.float32)]
    tex_alpha_rows = [np.ones(1, np.float32)]
    tex_meta = []
    off = 1
    for img in scene.textures:
        h_i, w_i = img.shape[0], img.shape[1]
        flat = np.asarray(img, np.float32).reshape(h_i * w_i, -1)
        tex_rows.append(flat[:, :3])
        tex_alpha_rows.append(
            flat[:, 3] if flat.shape[1] == 4
            else np.ones(h_i * w_i, np.float32)
        )
        tex_meta.append([off, w_i, h_i, 0.0])
        off += h_i * w_i
    tex_data = np.concatenate(tex_rows, axis=0)
    tex_alpha = np.concatenate(tex_alpha_rows, axis=0)
    tex_meta = (np.asarray(tex_meta, np.float32) if tex_meta
                else np.zeros((1, 4), np.float32))

    # Emissive triangles, expanded per instance into world space (NEE table).
    lv0, lv1, lv2, lem = [], [], [], []
    for inst in scene.instances:
        mesh = scene.meshes[inst.mesh_id]
        mids = (
            np.full_like(mesh.material_ids, inst.material_override)
            if inst.material_override >= 0
            else mesh.material_ids
        )
        emissive = np.array(
            [scene.materials[mid].is_emissive() for mid in mids], bool
        ) if len(scene.materials) else np.zeros(mesh.num_triangles, bool)
        if not emissive.any():
            continue
        idx = mesh.indices[emissive]
        w = lambda pts: apply_transform(inst.transform, pts)
        lv0.append(w(mesh.vertices[idx[:, 0]]))
        lv1.append(w(mesh.vertices[idx[:, 1]]))
        lv2.append(w(mesh.vertices[idx[:, 2]]))
        lem.append(mat_emission[mids[emissive]])

    if lv0:
        light_v0 = np.concatenate(lv0).astype(np.float32)
        light_v1 = np.concatenate(lv1).astype(np.float32)
        light_v2 = np.concatenate(lv2).astype(np.float32)
        light_emission = np.concatenate(lem).astype(np.float32)
        n_lights = light_v0.shape[0]
    else:
        light_v0 = light_v1 = light_v2 = np.zeros((1, 3), np.float32)
        light_emission = np.zeros((1, 3), np.float32)
        n_lights = 0
    l_pad = max(_round_up(max(n_lights, 1),
                          pad_to if n_lights > pad_to else 1), 1)
    light_v0 = _pad_rows(light_v0, l_pad)
    light_v1 = _pad_rows(light_v1, l_pad)
    light_v2 = _pad_rows(light_v2, l_pad)
    light_emission = _pad_rows(light_emission, l_pad)
    light_area = 0.5 * np.linalg.norm(
        np.cross(light_v1 - light_v0, light_v2 - light_v0), axis=1
    ).astype(np.float32)
    if n_lights < l_pad:
        light_area[n_lights:] = 0.0

    dev = lambda a: torch.from_numpy(np.array(a)).to(device)
    return DeviceScene(
        tri_v0=dev(tri_v0), tri_v1=dev(tri_v1), tri_v2=dev(tri_v2),
        tri_n0=dev(tri_n0), tri_n1=dev(tri_n1), tri_n2=dev(tri_n2),
        tri_mat=dev(tri_mat),
        mesh_tri_offset=dev(np.asarray(offsets, np.int32)),
        inst_mesh=dev(inst_mesh),
        inst_transform=dev(inst_transform),
        inst_inv=dev(inst_inv.astype(np.float32)),
        inst_nrm=dev(inst_nrm.astype(np.float32)),
        inst_mat_override=dev(inst_mat_override),
        mat_kind=dev(mat_kind),
        mat_albedo=dev(mat_albedo),
        mat_emission=dev(mat_emission),
        mat_param0=dev(mat_param0),
        mat_param1=dev(mat_param1),
        mat_texture=dev(mat_texture),
        tri_uv0=dev(tri_uv0), tri_uv1=dev(tri_uv1), tri_uv2=dev(tri_uv2),
        tex_data=dev(tex_data),
        tex_meta=dev(tex_meta),
        light_v0=dev(light_v0), light_v1=dev(light_v1),
        light_v2=dev(light_v2),
        light_emission=dev(light_emission),
        light_area=dev(light_area),
        num_lights=dev(np.asarray(n_lights, np.int32)),
        background=dev(np.asarray(scene.background, np.float32)),
        mat_alpha_cutoff=dev(mat_alpha_cutoff),
        tex_alpha=dev(tex_alpha),
    )
