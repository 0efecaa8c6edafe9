"""Base-color textures of tpurt_torch against tpurt: the samplers, the
device pool, the shade-record texture columns and the three resolvers on
the same textured scene, then the port's own renders of
tests/unit/test_textures.py.

Tolerances: the samplers' outputs bit-equal (nearest, bilinear and
alpha, on UVs below 0 and above 1 and with tex_id -1); the device pool
and shade-record columns 22:29 byte-equal; resolved attributes as in
tests/test_torch_materials.py (atol 1e-6 plus 1e-6 relative: torch and
XLA:CPU round normalize's sqrt and contracted multiply-adds differently
in the last bits), integers and booleans exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt import materials as ref
from tpurt.bvh.paircluster import build_pair_accel as ref_build
from tpurt.bvh.paircluster import build_pair_accel_two_level as ref_build_tl
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import types as ref_types
from tpurt.scene.device import to_device as ref_to_device
from tpurt_torch import materials as port
from tpurt_torch.bvh.paircluster import build_pair_accel as port_build
from tpurt_torch.bvh.paircluster import (
    build_pair_accel_two_level as port_build_tl,
)
from tpurt_torch.core.camera import Camera
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render import render_scene
from tpurt_torch.render.intersectors import scene_meta as port_meta
from tpurt_torch.scene import types as port_types
from tpurt_torch.scene.device import to_device as port_to_device
from tpurt_torch.scene.types import LAMBERT, Instance, Material, Mesh, Scene
from tpurt_torch.utils.config import get_config

torch.set_num_threads(1)
N = 4096
T = torch.from_numpy


def textured_scene(ty):
    """Three textures (RGB 3×5, RGBA 4×7, RGB 1×1), an untextured, two
    textured and one cut-out material, and a mesh instanced three times
    (one instance with a material override), with random UVs."""
    rng = np.random.default_rng(11)
    scene = ty.Scene(name="textured", background=(0.1, 0.2, 0.3))
    tex = [rng.uniform(0, 1, (3, 5, 3)).astype(np.float32),
           rng.uniform(0, 1, (4, 7, 4)).astype(np.float32),
           np.full((1, 1, 3), 0.5, np.float32)]
    tid = [scene.add_texture(t) for t in tex]
    mats = [
        scene.add_material(ty.Material(ty.LAMBERT, (0.7, 0.6, 0.5))),
        scene.add_material(ty.Material(ty.LAMBERT, (0.9, 0.8, 0.7),
                                       base_color_texture=tid[0])),
        scene.add_material(ty.Material(ty.BLINN_PHONG, (0.5, 0.9, 0.4),
                                       param0=20.0, param1=0.3,
                                       base_color_texture=tid[2])),
        scene.add_material(ty.Material(ty.LAMBERT, (1.0, 1.0, 1.0),
                                       base_color_texture=tid[1],
                                       alpha_cutoff=0.5)),
    ]
    n_v, n_t = 40, 60
    verts = rng.normal(size=(n_v, 3)).astype(np.float32)
    idx = rng.integers(0, n_v, (n_t, 3)).astype(np.int32)
    idx[:, 1] = (idx[:, 0] + 1 + idx[:, 1] % (n_v - 1)) % n_v
    idx[:, 2] = (idx[:, 1] + 1 + idx[:, 2] % (n_v - 2)) % n_v
    bad = idx[:, 2] == idx[:, 0]
    idx[bad, 2] = (idx[bad, 2] + 1) % n_v
    uvs = rng.uniform(-1.5, 2.5, (n_v, 2)).astype(np.float32)
    mids = np.asarray(mats, np.int32)[rng.integers(0, 4, n_t)]
    m = scene.add_mesh(ty.Mesh(verts, idx, mids, uvs=uvs, name="blob"))
    for k, over in enumerate((-1, -1, mats[1])):
        scene.add_instance(ty.Instance(
            m, ty.make_transform((3.0 * k, 0.5 * k, 0.0), rotate_y=0.4 * k,
                                 scale=1.0 + 0.25 * k),
            material_override=over))
    return scene


@pytest.fixture(scope="module")
def scenes():
    rs, ps = textured_scene(ref_types), textured_scene(port_types)
    return dict(rs=rs, ps=ps, r_ds=ref_to_device(rs),
                p_ds=port_to_device(ps, "cpu"))


def _lookups(rng, n_tex):
    tid = rng.integers(-1, n_tex, N).astype(np.int32)
    tu = rng.uniform(-2.5, 3.5, N).astype(np.float32)
    tv = rng.uniform(-2.5, 3.5, N).astype(np.float32)
    # exact texel edges and wrap points too
    tu[:64] = np.arange(64, dtype=np.float32) / 7.0 - 2.0
    tv[64:128] = np.arange(64, dtype=np.float32) / 4.0 - 3.0
    return tid, tu, tv


def test_device_pool_byte_equal(scenes):
    r, p = scenes["r_ds"], scenes["p_ds"]
    for f in ("tex_data", "tex_meta", "tex_alpha", "mat_texture",
              "mat_alpha_cutoff", "tri_uv0", "tri_uv1", "tri_uv2"):
        a, b = getattr(p, f).numpy(), np.asarray(getattr(r, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("two_level", [False, True], ids=["flat", "tl"])
def test_shade_record_texture_columns_byte_equal(scenes, two_level):
    build = (ref_build_tl, port_build_tl) if two_level else \
        (ref_build, port_build)
    want = build[0](None, ref_meta(scenes["rs"]), scene=scenes["rs"])
    got = build[1](None, port_meta(scenes["ps"]), scene=scenes["ps"])
    a, b = got.shade_rows[:, 22:30], np.asarray(want.shade_rows)[:, 22:30]
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()
    assert (a[:, 6] >= 0).any() and (a[:, 7] > 0).any()  # textured, cut out


@pytest.mark.parametrize("bilinear", [False, True],
                         ids=["nearest", "bilinear"])
def test_sample_base_color_bit_equal(scenes, bilinear):
    r, p = scenes["r_ds"], scenes["p_ds"]
    tid, tu, tv = _lookups(np.random.default_rng(1), r.tex_meta.shape[0])
    want = np.asarray(ref.sample_base_color(
        r.tex_data, r.tex_meta, jnp.asarray(tid), jnp.asarray(tu),
        jnp.asarray(tv), bilinear=bilinear))
    got = port.sample_base_color(p.tex_data, p.tex_meta, T(tid), T(tu),
                                 T(tv), bilinear=bilinear).numpy()
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got[tid < 0], 1.0)


def test_sample_alpha_bit_equal(scenes):
    r, p = scenes["r_ds"], scenes["p_ds"]
    tid, tu, tv = _lookups(np.random.default_rng(2), r.tex_meta.shape[0])
    want = np.asarray(ref.sample_alpha(
        r.tex_alpha, r.tex_meta, jnp.asarray(tid), jnp.asarray(tu),
        jnp.asarray(tv)))
    got = port.sample_alpha(p.tex_alpha, p.tex_meta, T(tid), T(tu),
                            T(tv)).numpy()
    assert got.tobytes() == want.tobytes()
    assert (got < 0.5).any() and (got[tid != 1] == 1.0).all()


def _eq(got, want, name):
    got, want = got.numpy(), np.asarray(want)
    if got.dtype == bool or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def _rays(rng, n):
    org = rng.normal(size=(n, 3)).astype(np.float32) * 3.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0.1, 5.0, n).astype(np.float32)
    u = rng.uniform(0.0, 0.6, n).astype(np.float32)
    v = (rng.uniform(0.0, 1.0, n) * (1.0 - u)).astype(np.float32)
    return org, d, t, u, v


@pytest.mark.parametrize("kind", ["per_field", "packed", "packed_tl"])
@pytest.mark.parametrize("texture_filter", ["nearest", "bilinear"])
def test_resolvers_match_reference(scenes, kind, texture_filter):
    """make_resolver's three paths on the textured pool: the per-field
    gathers (the packet BVH's), the flat shade records and the two-level
    records with their instance table (an overridden instance shades
    untextured)."""
    rs, ps = scenes["rs"], scenes["ps"]
    rng = np.random.default_rng(7)
    if kind == "per_field":
        r_acc = p_acc = None
        n_slots = 1
    else:
        build = (ref_build_tl, port_build_tl) if kind == "packed_tl" else \
            (ref_build, port_build)
        r_acc = build[0](None, ref_meta(rs), scene=rs)
        p_acc = build[1](None, port_meta(ps), scene=ps).to("cpu")
        n_slots = r_acc.shade_rows.shape[0]
    org, d, t, u, v = _rays(rng, N)
    tri = rng.integers(0, rs.num_triangles, N).astype(np.int32)
    inst = rng.integers(0, len(rs.instances), N).astype(np.int32)
    slot = rng.integers(-1, n_slots, N).astype(np.int32)
    args = (org, d, t, u, v, tri, inst, slot)
    want = ref.make_resolver(scenes["r_ds"], r_acc,
                             texture_filter=texture_filter)(
        *map(jnp.asarray, args))
    got = port.make_resolver(scenes["p_ds"], p_acc,
                             texture_filter=texture_filter)(*map(T, args))
    for f in ref.HitAttrs._fields:
        _eq(getattr(got, f), getattr(want, f), f)


def test_untextured_scene_skips_the_gather(monkeypatch):
    """A scene holding only the white-fallback texel never samples."""
    from tpurt_torch.scene import procedural

    ps = procedural.cornell_box(path_tracer=True)
    ds = port_to_device(ps, "cpu")
    assert ds.tex_data.shape[0] == 1

    def boom(*a, **k):
        raise AssertionError("sampled an untextured scene")

    monkeypatch.setattr(port, "sample_base_color", boom)
    acc = port_build(None, port_meta(ps), scene=ps).to("cpu")
    org, d, t, u, v = _rays(np.random.default_rng(3), 64)
    z = np.zeros(64, np.int32)
    for a in (acc, None):
        port.make_resolver(ds, a)(*map(T, (org, d, t, u, v, z, z, z)))


# --- the port's own renders, as tests/unit/test_textures.py -----------------

def checkerboard():
    """2×2 texture: red / green // blue / white (rows top to bottom)."""
    return np.array([[[1, 0, 0], [0, 1, 0]], [[0, 0, 1], [1, 1, 1]]],
                    np.float32)


def textured_quad_scene(tex=None, albedo=(1.0, 1.0, 1.0)):
    """Unit quad in z=0 spanning [0,1]², uv = xy, camera looking at it."""
    scene = Scene(name="texquad")
    tid = scene.add_texture(tex if tex is not None else checkerboard())
    mid = scene.add_material(
        Material(kind=LAMBERT, albedo=albedo, base_color_texture=tid))
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
                     np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    m = scene.add_mesh(Mesh(verts, idx, np.full(2, mid), uvs=uvs))
    scene.add_instance(Instance(mesh_id=m))
    scene.camera = Camera.make(position=(0.5, 0.5, 1.75),
                               look_at=(0.5, 0.5, 0.0), vfov_deg=45.0)
    scene.background = (0.0, 0.0, 0.0)
    return scene


def test_sampler_nearest_wrap_and_fallback():
    ds = port_to_device(textured_quad_scene(), "cpu")
    tid = torch.tensor([0, 0, 0, 0, 0, -1], dtype=torch.int32)
    # texture v=0 is the TOP image row (glTF convention)
    tu = torch.tensor([0.25, 0.75, 0.25, 0.75, 1.25, 0.5])
    tv = torch.tensor([0.25, 0.25, 0.75, 0.75, 0.25, 0.5])
    got = port.sample_base_color(ds.tex_data, ds.tex_meta, tid, tu, tv)
    want = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1],
                     [1, 0, 0],  # u 1.25 wraps to 0.25: top-left red
                     [1, 1, 1]],  # tex_id -1: white fallback
                    np.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_bilinear_sampler_analytic():
    """LINEAR filtering of a 1×2 black/white texture interpolates between
    texel centers; REPEAT wraps the outer halves toward the opposite
    texel."""
    ds = port_to_device(textured_quad_scene(
        tex=np.array([[[0, 0, 0], [1, 1, 1]]], np.float32)), "cpu")
    tid = torch.zeros(5, dtype=torch.int32)
    tu = torch.tensor([0.25, 0.75, 0.5, 0.375, 0.625])
    tv = torch.full((5,), 0.5)
    got = port.sample_base_color(ds.tex_data, ds.tex_meta, tid, tu, tv,
                                 bilinear=True)[:, 0]
    np.testing.assert_allclose(got.numpy(), [0.0, 1.0, 0.5, 0.25, 0.75],
                               atol=1e-6)


def _flat(scene, size=64, **over):
    cfg = get_config("cornell", width=size, height=size, spp=1,
                     spp_per_batch=1, max_bounces=0, shading_mode="flat",
                     **over)
    state, _ = render_scene(cfg, device="cpu", scene=scene)
    return fb.resolve(state).numpy()


@pytest.mark.parametrize("intersector", ["bvh_tile", "bvh_packet"])
def test_textured_quad_render(intersector):
    """Flat render of the checkerboard quad: each quadrant shows its
    texel colour, through the packed (bvh_tile) and per-field
    (bvh_packet) resolvers."""
    img = _flat(textured_quad_scene(), intersector=intersector)
    h, w = img.shape[:2]
    probe = lambda fx, fy: img[int(fy * h), int(fx * w)]
    # image row 0 is the top of the frame: quad y = 1, uv v = 1
    np.testing.assert_allclose(probe(0.3, 0.7), [1, 0, 0], atol=1e-3)
    np.testing.assert_allclose(probe(0.7, 0.7), [0, 1, 0], atol=1e-3)
    np.testing.assert_allclose(probe(0.3, 0.3), [0, 0, 1], atol=1e-3)
    np.testing.assert_allclose(probe(0.7, 0.3), [1, 1, 1], atol=1e-3)


def test_albedo_factor_multiplies_texture():
    img = _flat(textured_quad_scene(tex=np.full((1, 1, 3), 1.0, np.float32),
                                    albedo=(0.25, 0.5, 1.0)), size=32)
    np.testing.assert_allclose(img[16, 16], [0.25, 0.5, 1.0], atol=1e-3)


def test_bilinear_render_smoke():
    """Bilinear through the packed resolver: the quadrant centers keep
    their colours; the quad center blends all four texels."""
    img = _flat(textured_quad_scene(), texture_filter="bilinear")
    h, w = img.shape[:2]
    probe = lambda fx, fy: img[int(fy * h), int(fx * w)]
    # texel centers at quad uv 0.25/0.75; the 45° camera at 1.75 spans
    # 1.45 world units, so uv maps to image fraction 0.5 + (uv − 0.5)/1.45
    fx = lambda uv: 0.5 + (uv - 0.5) / 1.45
    np.testing.assert_allclose(probe(fx(0.25), fx(0.75)), [1, 0, 0],
                               atol=8e-2)
    np.testing.assert_allclose(probe(fx(0.75), fx(0.25)), [1, 1, 1],
                               atol=8e-2)
    center = probe(0.5, 0.5)
    assert 0.15 < center[0] < 0.85 and 0.15 < center[1] < 0.85
