"""The bunny stand-in (the ladder's config 3: ~70k triangles, Blinn-Phong
and a mirror): a displaced icosphere of 20 * 4^subdivisions triangles on a
floor, before a mirror wall, under one square area light. The scanned mesh
is not in the repository; this is the geometry the program's ``bunny``
preset renders."""

from __future__ import annotations

import numpy as np

from perfbench.scenedata import (BLINN_PHONG, LAMBERT, MIRROR, CameraData,
                                 InstanceData, MaterialData, SceneData,
                                 make_transform, mesh)
from perfbench.scenes.geometry import icosphere, quad


def build(subdivisions: int = 6) -> SceneData:
    materials = [
        MaterialData(BLINN_PHONG, (0.55, 0.42, 0.3), param0=64.0,
                     param1=0.4, name="body"),
        MaterialData(LAMBERT, (0.6, 0.6, 0.62), name="floor"),
        MaterialData(MIRROR, (0.9, 0.9, 0.95), name="mirror"),
        MaterialData(LAMBERT, (0.0, 0.0, 0.0), emission=(10.0, 9.5, 9.0),
                     name="key"),
    ]
    v, i = icosphere(subdivisions)
    d = (1.0 + 0.18 * np.sin(3.0 * v[:, 0] + 1.0) * np.cos(2.0 * v[:, 1])
         + 0.12 * np.sin(5.0 * v[:, 2])).astype(np.float32)
    v = v * d[:, None]
    meshes = [mesh(v, i, 0, name="blob"),
              mesh(*quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6]), 1,
                   name="floor"),
              mesh(*quad([-6, 0, 4.5], [6, 0, 4.5], [6, 6, 4.5],
                         [-6, 6, 4.5]), 2, name="mirror_wall"),
              mesh(*quad([-1.5, 5.5, -1.5], [1.5, 5.5, -1.5],
                         [1.5, 5.5, 1.5], [-1.5, 5.5, 1.5]), 3, name="lamp")]
    instances = [InstanceData(0, make_transform((0.0, 1.25, 0.0)), "blob")]
    instances += [InstanceData(k, make_transform(), meshes[k].name)
                  for k in (1, 2, 3)]
    camera = CameraData((3.2, 2.6, -4.5), (0.0, 1.1, 0.0), vfov_deg=38.0)
    return SceneData(meshes, materials, instances, camera,
                     (0.35, 0.45, 0.6), "bunny")
