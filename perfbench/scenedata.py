"""The benchmark's host scene format: plain numpy, independent of the program.

The frozen scene builders (``perfbench.scenes``) make a ``SceneData``; the
harness converts it into the program's scene type (``perfbench.program``)
and the plain reference (``perfbench.reference``) reads it as it is, so
both sides render one input.

Material model (the scene API of the renderer under test): ``kind`` 0
Lambert (albedo), 1 Blinn-Phong (``param0`` shininess, ``param1`` specular
strength), 2 mirror (``param0`` fuzz), 3 dielectric (``param0`` index of
refraction); any material may emit (``emission``), which makes its
triangles area lights for next-event estimation.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Tuple

import numpy as np

LAMBERT, BLINN_PHONG, MIRROR, DIELECTRIC = 0, 1, 2, 3


@dataclasses.dataclass
class MeshData:
    vertices: np.ndarray  # (V, 3) f32, object space
    indices: np.ndarray  # (T, 3) i32
    normals: np.ndarray  # (V, 3) f32 shading normals
    material_ids: np.ndarray  # (T,) i32
    name: str = ""


@dataclasses.dataclass
class MaterialData:
    kind: int
    albedo: Tuple[float, float, float]
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    param0: float = 0.0
    param1: float = 0.0
    name: str = ""


@dataclasses.dataclass
class InstanceData:
    mesh_id: int
    transform: np.ndarray  # (3, 4) f32, world = M @ [p; 1]
    name: str = ""


@dataclasses.dataclass
class CameraData:
    position: Tuple[float, float, float]
    look_at: Tuple[float, float, float]
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    vfov_deg: float = 45.0


@dataclasses.dataclass
class SceneData:
    meshes: List[MeshData]
    materials: List[MaterialData]
    instances: List[InstanceData]
    camera: CameraData
    background: Tuple[float, float, float]
    name: str = ""

    def instanced_triangles(self) -> int:
        """Triangles after instancing (every instance's mesh counted)."""
        return sum(self.meshes[i.mesh_id].indices.shape[0]
                   for i in self.instances)

    def checksum(self) -> str:
        """sha256 of every array and number of the scene, in order."""
        h = hashlib.sha256()

        def add(a):
            h.update(np.ascontiguousarray(a).tobytes())

        for m in self.meshes:
            for a in (m.vertices, m.indices, m.normals, m.material_ids):
                add(a)
        for mat in self.materials:
            add(np.asarray([mat.kind, *mat.albedo, *mat.emission,
                            mat.param0, mat.param1], np.float64))
        for inst in self.instances:
            add(np.asarray([inst.mesh_id], np.int64))
            add(inst.transform)
        c = self.camera
        add(np.asarray([*c.position, *c.look_at, *c.up, c.vfov_deg,
                        *self.background], np.float64))
        return h.hexdigest()


def vertex_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (f32)."""
    v, i = vertices, indices
    fn = np.cross(v[i[:, 1]] - v[i[:, 0]], v[i[:, 2]] - v[i[:, 0]])
    n = np.zeros_like(v)
    for k in range(3):
        np.add.at(n, i[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def make_transform(translate=(0.0, 0.0, 0.0), rotate_y: float = 0.0):
    """(3, 4) f32 affine: a rotation about +y, then a translation."""
    c, s = np.cos(rotate_y), np.sin(rotate_y)
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    m[:, 3] = translate
    return m


def mesh(vertices, indices, material_id, normals=None, name="") -> MeshData:
    vertices = np.ascontiguousarray(vertices, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    if normals is None:
        normals = vertex_normals(vertices, indices)
    mats = np.full(indices.shape[0], int(material_id), np.int32)
    return MeshData(vertices, indices,
                    np.ascontiguousarray(normals, np.float32), mats, name)
