"""Procedural scenes — port of ``tpurt.scene.procedural``.

The benchmark ladder's scenes are procedural stand-ins with the scale and
feature coverage of the published demo scenes:

  config 1  hello_triangle()   1 tri, flat shading
  config 2  cornell_box()      ~36 tris, Lambertian + light
  config 3  bunny_standin()    ~82k-tri smooth mesh, Blinn-Phong + mirror
  config 4  cornell_box(path_tracer=True)  diffuse/glossy/dielectric
  config 5  sponza_standin()   ~260k instanced tris, two-level TLAS

They are host numpy and produce byte-identical scenes to the
reference's, so both packages can be fed the same input.
"""

from __future__ import annotations

import numpy as np

from tpurt_torch.core.camera import Camera
from tpurt_torch.scene.types import (
    BLINN_PHONG,
    DIELECTRIC,
    Instance,
    LAMBERT,
    MIRROR,
    Material,
    Mesh,
    Scene,
    make_transform,
)

# ---------------------------------------------------------------------------
# small geometry helpers (host-side numpy)
# ---------------------------------------------------------------------------


def quad(p0, p1, p2, p3):
    """Two triangles for the quad p0-p1-p2-p3 (counter-clockwise)."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, idx


def box(bmin, bmax):
    """Axis-aligned box as 12 triangles with outward winding."""
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    faces = [
        # -z
        ([x0, y0, z0], [x0, y1, z0], [x1, y1, z0], [x1, y0, z0]),
        # +z
        ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),
        # -x
        ([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),
        # +x
        ([x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1]),
        # -y
        ([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),
        # +y
        ([x0, y1, z0], [x0, y1, z1], [x1, y1, z1], [x1, y1, z0]),
    ]
    verts, idx = [], []
    for k, f in enumerate(faces):
        v, i = quad(*f)
        idx.append(i + 4 * k)
        verts.append(v)
    return np.concatenate(verts), np.concatenate(idx)


def merge(parts):
    """Merge [(verts, idx, mat_id), ...] into one flat mesh arrays triple."""
    verts, idx, mats = [], [], []
    off = 0
    for v, i, m in parts:
        verts.append(np.asarray(v, np.float32))
        idx.append(np.asarray(i, np.int32) + off)
        mats.append(np.full(len(i), m, np.int32))
        off += len(v)
    return np.concatenate(verts), np.concatenate(idx), np.concatenate(mats)


def icosphere(subdivisions: int, radius: float = 1.0):
    """Subdivided icosahedron: 20 * 4^n triangles, smooth unit sphere."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        edge_mid = {}
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                verts_list.append(m)
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    v = (verts * radius).astype(np.float32)
    n = verts.astype(np.float32)  # unit sphere: normal == position
    return v, faces.astype(np.int32), n


def cylinder(radius, height, segments, rings=1, cap=True):
    """Open/capped cylinder along +y starting at y=0."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring_y = np.linspace(0, height, rings + 1)
    verts = []
    for y in ring_y:
        verts.append(
            np.stack([radius * np.cos(ang), np.full_like(ang, y),
                      radius * np.sin(ang)], axis=1)
        )
    verts = np.concatenate(verts).astype(np.float32)
    idx = []
    for r in range(rings):
        base0, base1 = r * segments, (r + 1) * segments
        for s in range(segments):
            s1 = (s + 1) % segments
            idx += [
                [base0 + s, base1 + s, base1 + s1],
                [base0 + s, base1 + s1, base0 + s1],
            ]
    if cap:
        top = len(verts)
        verts = np.concatenate(
            [verts, np.array([[0, height, 0], [0, 0, 0]], np.float32)]
        )
        btm = top + 1
        last = rings * segments
        for s in range(segments):
            s1 = (s + 1) % segments
            idx.append([top, last + s1, last + s])
            idx.append([btm, s, s1])
    return verts, np.asarray(idx, np.int32)


# ---------------------------------------------------------------------------
# config 1 — hello triangle [B:7]
# ---------------------------------------------------------------------------


def hello_triangle() -> Scene:
    """Single flat-shaded triangle, primary rays only (BASELINE.json:7)."""
    scene = Scene(name="hello_triangle", background=(0.05, 0.05, 0.08))
    mat = scene.add_material(
        Material(kind=LAMBERT, albedo=(0.9, 0.3, 0.2), name="tri")
    )
    verts = np.array(
        [[-1.0, -0.8, 0.0], [1.0, -0.8, 0.0], [0.0, 1.0, 0.0]], np.float32
    )
    idx = np.array([[0, 1, 2]], np.int32)
    mesh = scene.add_mesh(Mesh(verts, idx, mat, name="triangle"))
    scene.add_instance(Instance(mesh_id=mesh, name="triangle"))
    scene.camera = Camera.make((0.0, 0.0, -3.0), (0.0, 0.0, 0.0), vfov_deg=60.0)
    return scene


# ---------------------------------------------------------------------------
# configs 2 & 4 — Cornell box [B:8, B:10]
# ---------------------------------------------------------------------------


def cornell_box(path_tracer: bool = False) -> Scene:
    """Classic 555-unit Cornell box, ~36 triangles.

    path_tracer=False → config 2: all-Lambertian + area light (shadow rays).
    path_tracer=True  → config 4: tall box glossy mirror, short box glass
    dielectric (diffuse/glossy/dielectric per BASELINE.json:10).
    """
    scene = Scene(
        name="cornell_pt" if path_tracer else "cornell",
        background=(0.0, 0.0, 0.0),
    )
    white = scene.add_material(Material(LAMBERT, (0.73, 0.73, 0.73), name="white"))
    red = scene.add_material(Material(LAMBERT, (0.65, 0.05, 0.05), name="red"))
    green = scene.add_material(Material(LAMBERT, (0.12, 0.45, 0.15), name="green"))
    light = scene.add_material(
        Material(LAMBERT, (0.0, 0.0, 0.0), emission=(15.0, 15.0, 15.0), name="light")
    )
    if path_tracer:
        tall_mat = scene.add_material(
            Material(MIRROR, (0.95, 0.95, 0.95), param0=0.08, name="glossy")
        )
        short_mat = scene.add_material(
            Material(DIELECTRIC, (1.0, 1.0, 1.0), param0=1.5, name="glass")
        )
    else:
        tall_mat = short_mat = white

    parts = []
    # floor / ceiling / back wall (white)
    parts.append((*quad([0, 0, 0], [555, 0, 0], [555, 0, 555], [0, 0, 555]), white))
    parts.append((*quad([0, 555, 0], [0, 555, 555], [555, 555, 555], [555, 555, 0]), white))
    parts.append((*quad([0, 0, 555], [555, 0, 555], [555, 555, 555], [0, 555, 555]), white))
    # left (red) / right (green) walls
    parts.append((*quad([555, 0, 0], [555, 555, 0], [555, 555, 555], [555, 0, 555]), red))
    parts.append((*quad([0, 0, 0], [0, 0, 555], [0, 555, 555], [0, 555, 0]), green))
    # ceiling light
    parts.append(
        (*quad([213, 554.5, 227], [343, 554.5, 227], [343, 554.5, 332],
               [213, 554.5, 332]), light)
    )
    verts, idx, mats = merge(parts)
    walls = scene.add_mesh(Mesh(verts, idx, mats, name="walls"))
    scene.add_instance(Instance(mesh_id=walls, name="walls"))

    # The two boxes, as separate meshes placed via instance transforms
    # (exercises the instance path even in the single-level configs).
    sv, si = box([0, 0, 0], [165, 165, 165])
    short = scene.add_mesh(Mesh(sv, si, short_mat, name="short_box"))
    scene.add_instance(
        Instance(short, make_transform((130, 0, 65), rotate_y=np.deg2rad(-18.0)),
                 name="short_box")
    )
    tv, ti = box([0, 0, 0], [165, 330, 165])
    tall = scene.add_mesh(Mesh(tv, ti, tall_mat, name="tall_box"))
    scene.add_instance(
        Instance(tall, make_transform((265, 0, 295), rotate_y=np.deg2rad(15.0)),
                 name="tall_box")
    )

    scene.camera = Camera.make((278, 273, -800), (278, 273, 0), vfov_deg=40.0)
    return scene


# ---------------------------------------------------------------------------
# config 3 — bunny stand-in (~70k tris) [B:9]
# ---------------------------------------------------------------------------


def bunny_standin(subdivisions: int = 6) -> Scene:
    """~80k-triangle smooth mesh on a ground plane with a mirror back wall:
    full BVH traversal, Blinn-Phong + 1-bounce mirror (BASELINE.json:9).

    The Stanford bunny OBJ is not on disk; a displaced icosphere with the
    same triangle count (20·4^6 = 81 920) is the stand-in. When a real
    bunny.obj is provided, ``load_scene`` renders it with this same setup.
    """
    scene = Scene(name="bunny", background=(0.35, 0.45, 0.6))
    body = scene.add_material(
        Material(BLINN_PHONG, (0.55, 0.42, 0.3), param0=64.0, param1=0.4,
                 name="body")
    )
    floor_mat = scene.add_material(
        Material(LAMBERT, (0.6, 0.6, 0.62), name="floor")
    )
    mirror_mat = scene.add_material(
        Material(MIRROR, (0.9, 0.9, 0.95), param0=0.0, name="mirror")
    )
    key_light = scene.add_material(
        Material(LAMBERT, (0, 0, 0), emission=(10.0, 9.5, 9.0), name="key")
    )

    v, i, n = icosphere(subdivisions)
    # Low-frequency displacement so the surface has bunny-like lumps and the
    # BVH is non-trivial (uneven leaf density).
    d = (
        1.0
        + 0.18 * np.sin(3.0 * v[:, 0] + 1.0) * np.cos(2.0 * v[:, 1])
        + 0.12 * np.sin(5.0 * v[:, 2])
    ).astype(np.float32)
    v = v * d[:, None]
    mesh = Mesh(v, i, body, name="blob")
    mesh.normals = mesh.compute_vertex_normals()
    blob = scene.add_mesh(mesh)
    scene.add_instance(Instance(blob, make_transform((0.0, 1.25, 0.0)), name="blob"))

    fv, fi = quad([-6, 0, -6], [-6, 0, 6], [6, 0, 6], [6, 0, -6])
    floor = scene.add_mesh(Mesh(fv, fi, floor_mat, name="floor"))
    scene.add_instance(Instance(floor, name="floor"))

    wv, wi = quad([-6, 0, 4.5], [6, 0, 4.5], [6, 6, 4.5], [-6, 6, 4.5])
    wall = scene.add_mesh(Mesh(wv, wi, mirror_mat, name="mirror_wall"))
    scene.add_instance(Instance(wall, name="mirror_wall"))

    lv, li = quad([-1.5, 5.5, -1.5], [1.5, 5.5, -1.5], [1.5, 5.5, 1.5],
                  [-1.5, 5.5, 1.5])
    lamp = scene.add_mesh(Mesh(lv, li, key_light, name="lamp"))
    scene.add_instance(Instance(lamp, name="lamp"))

    scene.camera = Camera.make((3.2, 2.6, -4.5), (0.0, 1.1, 0.0), vfov_deg=38.0)
    return scene


# ---------------------------------------------------------------------------
# config 5 — Sponza stand-in (~260k instanced tris) [B:11]
# ---------------------------------------------------------------------------


def sponza_standin(column_segments: int = 48, column_rings: int = 24) -> Scene:
    """Colonnaded atrium with instanced detailed columns: two-level
    TLAS-over-BLAS with real instancing (BASELINE.json:11).

    One column BLAS (~{segments×rings×2 + caps} ≈ 2.4k tris) instanced
    ~96 times + ornate architrave blocks + ground + clerestory light ⇒
    ~260k effective triangles, while only ~6k unique BLAS triangles —
    exactly the two-level memory win the reference's TLAS demonstrates.
    """
    scene = Scene(name="sponza", background=(0.55, 0.65, 0.8))
    stone = scene.add_material(
        Material(LAMBERT, (0.62, 0.58, 0.5), name="stone")
    )
    floor_mat = scene.add_material(
        Material(BLINN_PHONG, (0.45, 0.42, 0.4), param0=32.0, param1=0.25,
                 name="floor")
    )
    trim = scene.add_material(Material(LAMBERT, (0.5, 0.32, 0.22), name="trim"))
    sky_light = scene.add_material(
        Material(LAMBERT, (0, 0, 0), emission=(6.0, 5.8, 5.2), name="sky")
    )

    cv, ci = cylinder(0.35, 4.0, column_segments, column_rings)
    # flute the columns: radial ripple so the BLAS has real detail
    ang = np.arctan2(cv[:, 2], cv[:, 0])
    r = np.sqrt(cv[:, 0] ** 2 + cv[:, 2] ** 2)
    ripple = 1.0 + 0.06 * np.cos(12.0 * ang) * (r > 1e-6)
    cv = np.stack([cv[:, 0] * ripple, cv[:, 1], cv[:, 2] * ripple], axis=1).astype(
        np.float32
    )
    column = scene.add_mesh(Mesh(cv, ci, stone, name="column"))

    bv, bi = box([-0.45, 0.0, -0.45], [0.45, 0.35, 0.45])
    plinth = scene.add_mesh(Mesh(bv, bi, trim, name="plinth"))

    av, ai = box([-22.0, 0.0, -0.6], [22.0, 0.8, 0.6])
    architrave = scene.add_mesh(Mesh(av, ai, trim, name="architrave"))

    gv, gi = quad([-24, 0, -10], [-24, 0, 10], [24, 0, 10], [24, 0, -10])
    ground = scene.add_mesh(Mesh(gv, gi, floor_mat, name="ground"))
    scene.add_instance(Instance(ground, name="ground"))

    lv, li = quad([-20, 9.0, -3], [20, 9.0, -3], [20, 9.0, 3], [-20, 9.0, 3])
    lamp = scene.add_mesh(Mesh(lv, li, sky_light, name="skylight"))
    scene.add_instance(Instance(lamp, name="skylight"))

    # Two double rows of columns along x, two tiers high.
    n_per_row = 12
    xs = np.linspace(-20, 20, n_per_row)
    for tier in range(2):
        y = tier * 4.5 + (0.35 if tier == 0 else 0.0)
        for zrow in (-4.0, -3.0, 3.0, 4.0):
            for k, x in enumerate(xs):
                scene.add_instance(
                    Instance(
                        column,
                        make_transform((x, y, zrow),
                                       rotate_y=0.3 * k + (0.7 if tier else 0.0)),
                        name=f"col_t{tier}_z{zrow}_{k}",
                    )
                )
        for zrow in (-3.5, 3.5):
            scene.add_instance(
                Instance(architrave, make_transform((0.0, y + 4.0, zrow)),
                         name=f"arch_t{tier}_z{zrow}")
            )
    for x in xs:
        for zrow in (-3.5, 3.5):
            scene.add_instance(
                Instance(plinth, make_transform((x, 0.0, zrow)),
                         name=f"plinth_{x}_{zrow}")
            )

    scene.camera = Camera.make((-18.0, 2.2, 0.0), (20.0, 3.0, 0.0), vfov_deg=55.0)
    return scene


def sponza_flythrough(n_frames: int = 24):
    """The animated camera path through the atrium; frame 0 is the
    preset camera."""
    from tpurt_torch.core.camera import flythrough_path

    waypoints = [(-18, 2.2, 0.0), (-6, 2.8, 1.5), (6, 3.2, -1.5),
                 (18, 2.4, 0.0)]
    look_ats = [(20, 3, 0), (20, 3, 0), (20, 2, 0), (24, 2, 0)]
    return flythrough_path(waypoints, look_ats, n_frames, vfov_deg=55.0)


PRESET_BUILDERS = {
    "hello_triangle": hello_triangle,
    "cornell": lambda: cornell_box(False),
    "bunny": bunny_standin,
    "cornell_pt": lambda: cornell_box(True),
    "sponza": sponza_standin,
}


def flythrough_cameras(scene_name: str, n_frames: int):
    """Camera path of ``python -m tpurt_torch animate``: sponza's scripted
    atrium path; any other scene a 90° orbit from its own camera around
    its target."""
    if scene_name == "sponza":
        return sponza_flythrough(n_frames)
    from tpurt_torch.core.camera import orbit_camera
    from tpurt_torch.scene.loader import load_scene

    cam = load_scene(scene_name).camera
    center = np.asarray(cam.look_at, np.float32)
    offset = np.asarray(cam.position, np.float32) - center
    radius = float(np.linalg.norm(offset))
    theta0 = float(np.arctan2(offset[0], offset[2]))
    phi0 = float(np.arcsin(np.clip(offset[1] / max(radius, 1e-6), -1, 1)))
    return [
        orbit_camera(center, radius,
                     theta0 + 0.5 * np.pi * f / max(n_frames - 1, 1), phi0,
                     vfov_deg=float(cam.vfov_deg))
        for f in range(n_frames)
    ]

