"""The Happy Buddha stand-in (Stanford's ``happy_vrip`` scan: 543,652
vertices, 1,087,716 triangles) in the ladder's config 3 scene: a closed,
upright, displaced UV sphere of exactly the scan's triangle count on the
bunny's floor, before its mirror wall, under its area light. The scanned
mesh is not in the repository; the triangle count, and so the accel, is
the scan's, the surface is not.

The sphere has ``segments`` meridians and ``bands`` latitude bands, the
two polar bands as fans: ``2 * segments * (bands - 1)`` triangles, which
the defaults make 1,087,716. It is twice as tall as it is wide (a
statue's proportions), and its radius is displaced by the bunny's
low-frequency term plus a finer one; the displacement stays positive, so
the surface stays star-shaped about its centre and does not intersect
itself. Every step is one numpy pass over the vertices or triangles."""

from __future__ import annotations

import numpy as np

from perfbench.scenedata import (BLINN_PHONG, LAMBERT, MIRROR, CameraData,
                                 InstanceData, MaterialData, MeshData,
                                 SceneData, make_transform, mesh)
from perfbench.scenes.geometry import quad

WIDTH, HEIGHT = 0.8, 1.6  # half extents of the undisplaced body


def uv_sphere(segments: int, bands: int):
    """Unit sphere: ``bands - 1`` rings of ``segments`` vertices between
    two poles; (vertices f32, indices i32), outward-facing
    counter-clockwise triangles."""
    theta = np.arange(1, bands, dtype=np.float64) * (np.pi / bands)
    phi = np.arange(segments, dtype=np.float64) * (2.0 * np.pi / segments)
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    ring = np.stack([st * np.cos(phi), ct * np.ones_like(phi),
                     st * np.sin(phi)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])
    n_rings = bands - 1
    south = 1 + n_rings * segments
    j = np.arange(segments)
    k = (j + 1) % segments
    top = np.stack([np.zeros(segments, np.int64), 1 + k, 1 + j], -1)
    r = np.arange(n_rings - 1)[:, None]
    a, b = 1 + r * segments + j, 1 + r * segments + k  # ring r
    c, d = a + segments, b + segments  # ring r + 1
    quads = np.stack([np.stack([a, b, d], -1), np.stack([a, d, c], -1)],
                     1).reshape(-1, 3)
    last = 1 + (n_rings - 1) * segments
    bottom = np.stack([last + j, last + k,
                       np.full(segments, south, np.int64)], -1)
    faces = np.concatenate([top, quads, bottom])
    return verts.astype(np.float32), faces.astype(np.int32)


def smooth_normals(vertices: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (f32), summed with ``np.bincount``."""
    v, i = vertices.astype(np.float64), indices
    fn = np.cross(v[i[:, 1]] - v[i[:, 0]], v[i[:, 2]] - v[i[:, 0]])
    n = np.stack([sum(np.bincount(i[:, k], fn[:, a], v.shape[0])
                      for k in range(3)) for a in range(3)], -1)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def build(segments: int = 1126, bands: int = 484) -> SceneData:
    materials = [
        MaterialData(BLINN_PHONG, (0.55, 0.42, 0.3), param0=64.0,
                     param1=0.4, name="body"),
        MaterialData(LAMBERT, (0.6, 0.6, 0.62), name="floor"),
        MaterialData(MIRROR, (0.9, 0.9, 0.95), name="mirror"),
        MaterialData(LAMBERT, (0.0, 0.0, 0.0), emission=(10.0, 9.5, 9.0),
                     name="key"),
    ]
    u, i = uv_sphere(segments, bands)
    x, y, z = (u[:, k].astype(np.float64) for k in range(3))
    d = (1.0 + 0.18 * np.sin(3.0 * x + 1.0) * np.cos(2.0 * y)
         + 0.12 * np.sin(5.0 * z)
         + 0.04 * np.sin(13.0 * x + 2.0) * np.sin(11.0 * y)
         * np.cos(9.0 * z))
    v = (u * d[:, None] * np.array([WIDTH, HEIGHT, WIDTH])).astype(
        np.float32)
    body = MeshData(v, i, smooth_normals(v, i),
                    np.zeros(i.shape[0], np.int32), "body")
    meshes = [body,
              mesh(*quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6]), 1,
                   name="floor"),
              mesh(*quad([-6, 0, 4.5], [6, 0, 4.5], [6, 6, 4.5],
                         [-6, 6, 4.5]), 2, name="mirror_wall"),
              mesh(*quad([-1.5, 5.5, -1.5], [1.5, 5.5, -1.5],
                         [1.5, 5.5, 1.5], [-1.5, 5.5, 1.5]), 3, name="lamp")]
    instances = [InstanceData(0, make_transform((0.0, 1.75, 0.0)), "body")]
    instances += [InstanceData(k, make_transform(), meshes[k].name)
                  for k in (1, 2, 3)]
    camera = CameraData((3.6, 3.1, -5.0), (0.0, 1.7, 0.0), vfov_deg=38.0)
    return SceneData(meshes, materials, instances, camera,
                     (0.35, 0.45, 0.6), "buddha")
