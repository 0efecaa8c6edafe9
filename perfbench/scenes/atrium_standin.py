"""The instanced atrium of the ladder's config 5 (a two-level TLAS over
shared BLASes, ~260k instanced triangles at 1080p): a colonnaded atrium
whose fluted columns, plinths and architraves are instances of five
meshes. It is the program's config-5 preset (``sponza_standin``) as it
was when the benchmark took it: Crytek Sponza's mesh is not in the
repository, so this scene has its scale and its instancing, not its
surface.

The column is a capped cylinder of ``column_segments`` meridians and
``column_rings`` rings, fluted by a radial ripple:
``2 * segments * (rings + 1)`` triangles, instanced 96 times in two
tiers of four rows of twelve; 24 plinths and 4 architraves are boxes,
the ground and the skylight one quad each."""

from __future__ import annotations

import numpy as np

from perfbench.scenedata import (BLINN_PHONG, LAMBERT, CameraData,
                                 InstanceData, MaterialData, SceneData,
                                 make_transform, mesh)
from perfbench.scenes.geometry import quad


def box(bmin, bmax):
    """Axis-aligned box as 12 triangles with outward winding."""
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    faces = [
        ([x0, y0, z0], [x0, y1, z0], [x1, y1, z0], [x1, y0, z0]),  # -z
        ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),  # +z
        ([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),  # -x
        ([x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1]),  # +x
        ([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),  # -y
        ([x0, y1, z0], [x0, y1, z1], [x1, y1, z1], [x1, y1, z0]),  # +y
    ]
    quads = [quad(*f) for f in faces]
    return (np.concatenate([v for v, _ in quads]),
            np.concatenate([i + 4 * k for k, (_, i) in enumerate(quads)]))


def cylinder(radius, height, segments, rings):
    """Capped cylinder along +y from y = 0: ``rings + 1`` rings of
    ``segments`` vertices, then the top and bottom centres; (vertices
    f32, indices i32), each side quad as two triangles, then a top and a
    bottom fan triangle a segment."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring_y = np.linspace(0, height, rings + 1)
    side = np.stack([np.broadcast_to(radius * np.cos(ang), (rings + 1,
                                                            segments)),
                     np.broadcast_to(ring_y[:, None], (rings + 1, segments)),
                     np.broadcast_to(radius * np.sin(ang), (rings + 1,
                                                            segments))], -1)
    verts = np.concatenate([side.reshape(-1, 3).astype(np.float32),
                            np.array([[0, height, 0], [0, 0, 0]],
                                     np.float32)])
    s = np.arange(segments)
    s1 = (s + 1) % segments
    b0 = np.arange(rings)[:, None] * segments
    b1 = b0 + segments
    tris = np.stack([np.stack([b0 + s, b1 + s, b1 + s1], -1),
                     np.stack([b0 + s, b1 + s1, b0 + s1], -1)], 2)
    top, btm, last = (rings + 1) * segments, (rings + 1) * segments + 1, \
        rings * segments
    caps = np.stack([np.stack([np.full(segments, top), last + s1, last + s],
                              -1),
                     np.stack([np.full(segments, btm), s, s1], -1)], 1)
    idx = np.concatenate([tris.reshape(-1, 3), caps.reshape(-1, 3)])
    return verts, idx.astype(np.int32)


def build(column_segments: int = 48, column_rings: int = 27) -> SceneData:
    materials = [
        MaterialData(LAMBERT, (0.62, 0.58, 0.5), name="stone"),
        MaterialData(BLINN_PHONG, (0.45, 0.42, 0.4), param0=32.0,
                     param1=0.25, name="floor"),
        MaterialData(LAMBERT, (0.5, 0.32, 0.22), name="trim"),
        MaterialData(LAMBERT, (0.0, 0.0, 0.0), emission=(6.0, 5.8, 5.2),
                     name="sky"),
    ]
    stone, floor_mat, trim, sky = range(4)
    cv, ci = cylinder(0.35, 4.0, column_segments, column_rings)
    # the flutes: a radial ripple of twelve periods (the cap centres keep
    # their place)
    ang = np.arctan2(cv[:, 2], cv[:, 0])
    r = np.sqrt(cv[:, 0] ** 2 + cv[:, 2] ** 2)
    ripple = 1.0 + 0.06 * np.cos(12.0 * ang) * (r > 1e-6)
    cv = np.stack([cv[:, 0] * ripple, cv[:, 1], cv[:, 2] * ripple],
                  axis=1).astype(np.float32)
    meshes = [
        mesh(cv, ci, stone, name="column"),
        mesh(*box([-0.45, 0.0, -0.45], [0.45, 0.35, 0.45]), trim,
             name="plinth"),
        mesh(*box([-22.0, 0.0, -0.6], [22.0, 0.8, 0.6]), trim,
             name="architrave"),
        mesh(*quad([-24, 0, -10], [-24, 0, 10], [24, 0, 10], [24, 0, -10]),
             floor_mat, name="ground"),
        mesh(*quad([-20, 9.0, -3], [20, 9.0, -3], [20, 9.0, 3],
                   [-20, 9.0, 3]), sky, name="skylight"),
    ]
    column, plinth, architrave, ground, skylight = range(5)
    instances = [InstanceData(ground, make_transform(), "ground"),
                 InstanceData(skylight, make_transform(), "skylight")]
    # two double rows of columns along x, two tiers high, an architrave
    # over each double row of each tier
    xs = np.linspace(-20, 20, 12)
    for tier in range(2):
        y = tier * 4.5 + (0.35 if tier == 0 else 0.0)
        for zrow in (-4.0, -3.0, 3.0, 4.0):
            for k, x in enumerate(xs):
                instances.append(InstanceData(
                    column, make_transform(
                        (x, y, zrow),
                        rotate_y=0.3 * k + (0.7 if tier else 0.0)),
                    f"col_t{tier}_z{zrow}_{k}"))
        for zrow in (-3.5, 3.5):
            instances.append(InstanceData(
                architrave, make_transform((0.0, y + 4.0, zrow)),
                f"arch_t{tier}_z{zrow}"))
    for x in xs:
        for zrow in (-3.5, 3.5):
            instances.append(InstanceData(
                plinth, make_transform((x, 0.0, zrow)),
                f"plinth_{x}_{zrow}"))
    camera = CameraData((-18.0, 2.2, 0.0), (20.0, 3.0, 0.0), vfov_deg=55.0)
    return SceneData(meshes, materials, instances, camera,
                     (0.55, 0.65, 0.8), "atrium")
