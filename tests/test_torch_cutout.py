"""Alpha cutout of tpurt_torch against tpurt: the cut-out occluder and
closest on the same rays, the opaque identity contract, a whole render of
a small cut-out textured scene, and the port's own checker-against-
geometry equivalence of tests/unit/test_alpha_cutout.py.

The wrappers of both packages are fed the same plain closest function,
the brute-force oracle of each package, so no Pallas call is needed;
the shade-record branch gets each hit's slot from the flat accel's prim
tables, the per-field branch (the packet BVH's) reads ``Hit.tri`` and
``Hit.inst``.

Tolerances: occlusion flags, validity, triangle, instance and slot exact;
t within 1e-6 relative and barycentrics within 1e-4 absolute (XLA:CPU
contracts Möller–Trumbore's multiply-adds, tests/test_torch_tilewave.py).
The whole render against the reference's staged render (both through
bvh_tile) at energy bias ≤ 1e-3 and RMSE ≤ 1e-3 (ROADMAP §3,
transcendentals). The equivalences as in the reference's test: atol 2e-3
against the geometric twin and the quad-less scene, 1e-5 against the
opaque quad.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh.paircluster import build_pair_accel as ref_build
from tpurt.core import camera as ref_camera
from tpurt.render import framebuffer as ref_fb
from tpurt.render import integrator as ref_integ
from tpurt.render import render_scene as ref_render
from tpurt.render.intersectors import make_brute_force as ref_brute
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import types as ref_types
from tpurt.scene.device import to_device as ref_to_device
from tpurt.utils.config import get_config as ref_config
from tpurt_torch.bvh.paircluster import build_pair_accel as port_build
from tpurt_torch.core import camera as port_camera
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render import integrator as port_integ
from tpurt_torch.render import render_scene
from tpurt_torch.render.intersectors import make_brute_force as port_brute
from tpurt_torch.render.intersectors import scene_meta as port_meta
from tpurt_torch.render.staged import StagedRenderer
from tpurt_torch.scene import types as port_types
from tpurt_torch.scene.device import to_device as port_to_device
from tpurt_torch.utils.config import get_config

torch.set_num_threads(1)
T = torch.from_numpy


def _quad(x0, z0, x1, z1, y, uv=False):
    """Two-triangle horizontal quad at height y (uv spans [0,1]² when
    asked)."""
    v = np.array([[x0, y, z0], [x1, y, z0], [x1, y, z1], [x0, y, z1]],
                 np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uvs = (np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
           if uv else None)
    return v, idx, uvs


def base_scene(ty, camera):
    """Ground plane and an area light; cut-out quads go in between."""
    scene = ty.Scene(background=(0.0, 0.0, 0.0))
    ground = scene.add_material(ty.Material(kind=ty.LAMBERT,
                                            albedo=(0.7, 0.7, 0.7)))
    light = scene.add_material(ty.Material(
        kind=ty.LAMBERT, albedo=(0, 0, 0), emission=(8.0, 8.0, 8.0)))
    for (x0, z0, x1, z1, y), m in (((-4, -4, 4, 4, 0.0), ground),
                                   ((-0.7, -0.7, 0.7, 0.7, 4.0), light)):
        v, i, _ = _quad(x0, z0, x1, z1, y)
        scene.add_instance(ty.Instance(scene.add_mesh(
            ty.Mesh(vertices=v, indices=i, material_ids=m))))
    scene.camera = camera.Camera.make(position=(0.0, 3.0, 3.5),
                                      look_at=(0.0, 0.0, 0.0), vfov_deg=55.0)
    return scene


def add_cutout_quad(ty, scene, rgba, cutoff, y=2.0, half=1.5):
    tex = scene.add_texture(rgba)
    mat = scene.add_material(ty.Material(
        kind=ty.LAMBERT, albedo=(0.4, 0.8, 0.4), base_color_texture=tex,
        alpha_cutoff=cutoff))
    v, i, uv = _quad(-half, -half, half, half, y, uv=True)
    scene.add_instance(ty.Instance(scene.add_mesh(
        ty.Mesh(vertices=v, indices=i, material_ids=mat, uvs=uv))))
    return scene


def checker(n=1, rgb=None):
    """(2n, 2n, 4) RGBA: white (or ``rgb``) colour, checkerboard alpha."""
    a = np.indices((2 * n, 2 * n)).sum(axis=0) % 2
    img = np.ones((2 * n, 2 * n, 4), np.float32)
    if rgb is not None:
        img[..., :3] = rgb
    img[..., 3] = a
    return img


def layered_scene(ty, camera):
    """Three stacked cut-out quads (4×4, 2×2 and 8×8 checkers, one with
    random texel colours): rays cross up to three transparent texels, so
    the loops run past their second round."""
    rng = np.random.default_rng(4)
    scene = base_scene(ty, camera)
    add_cutout_quad(ty, scene, checker(2), 0.5, y=2.0)
    add_cutout_quad(ty, scene, checker(1, rgb=rng.uniform(0, 1, (2, 2, 3))),
                    0.5, y=2.5, half=1.2)
    add_cutout_quad(ty, scene, checker(4), 0.3, y=1.5, half=2.0)
    return scene


@pytest.fixture(scope="module")
def layered():
    rs = layered_scene(ref_types, ref_camera)
    ps = layered_scene(port_types, port_camera)
    r_meta, p_meta = ref_meta(rs), port_meta(ps)
    assert r_meta.has_alpha_cutout and p_meta.has_alpha_cutout
    rng = np.random.default_rng(8)
    n = 6000
    org = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(3.0, 4.5, n),
                    rng.uniform(-2.5, 2.5, n)], axis=1).astype(np.float32)
    tgt = np.stack([rng.uniform(-2.5, 2.5, n), np.zeros(n),
                    rng.uniform(-2.5, 2.5, n)], axis=1).astype(np.float32)
    d = tgt - org
    dist = np.linalg.norm(d, axis=1)
    d = (d / dist[:, None]).astype(np.float32)
    tmax = (dist * 0.999).astype(np.float32)
    tmax[::9] = -1.0  # dead rays
    tmax[1::9] = np.inf
    return dict(rs=rs, ps=ps, r_meta=r_meta, p_meta=p_meta,
                r_ds=ref_to_device(rs), p_ds=port_to_device(ps, device="cpu"),
                org=org, d=d, tmax=tmax)


def _closests(L, records: bool):
    """The brute-force closest of each package, and the accel whose
    records the alpha probe reads (None: the per-field branch). With
    records, each hit's slot comes from the accel's prim tables."""
    r_close, _ = ref_brute(L["r_ds"], L["r_meta"])
    p_close, _ = port_brute(L["p_ds"], L["p_meta"])
    if not records:
        return r_close, p_close, None, None
    r_acc = ref_build(None, L["r_meta"], scene=L["rs"])
    p_acc = port_build(None, L["p_meta"], scene=L["ps"]).to("cpu")
    slot_of = np.full((len(L["rs"].instances), L["rs"].num_triangles), -1,
                      np.int32)
    real = r_acc.prim_tri >= 0
    slot_of[r_acc.prim_inst[real], r_acc.prim_tri[real]] = \
        np.nonzero(real)[0]

    def r_slotted(o, d, t0, t1):
        h = r_close(o, d, t0, t1)
        return h._replace(slot=jnp.where(
            h.valid, jnp.asarray(slot_of)[h.inst, h.tri], -1))

    def p_slotted(o, d, t0, t1):
        h = p_close(o, d, t0, t1)
        s = T(slot_of)[h.inst.long(), h.tri.long()]
        return h._replace(slot=torch.where(h.valid, s, -1))

    return r_slotted, p_slotted, r_acc, p_acc


@pytest.mark.parametrize("records", [True, False],
                         ids=["shade_records", "per_field"])
def test_occluder_matches_reference(layered, records):
    L = layered
    r_close, p_close, r_acc, p_acc = _closests(L, records)
    want = ref_integ.make_occluder(L["r_ds"], r_acc, r_close, None,
                                   meta=L["r_meta"])
    got = port_integ.make_occluder(L["p_ds"], p_acc, p_close, None,
                                   meta=L["p_meta"])
    args = (L["org"], L["d"], 0.0, L["tmax"])
    w = np.asarray(want(jnp.asarray(args[0]), jnp.asarray(args[1]), 0.0,
                        jnp.asarray(args[3])))
    g = got(T(args[0]), T(args[1]), 0.0, T(args[3])).numpy()
    np.testing.assert_array_equal(g, w)
    live = L["tmax"] > 0
    # both outcomes occur, and texels were skipped on the way
    assert 0.2 < g[live].mean() < 0.95


@pytest.mark.parametrize("records", [True, False],
                         ids=["shade_records", "per_field"])
def test_cutout_closest_matches_reference(layered, records):
    L = layered
    r_close, p_close, r_acc, p_acc = _closests(L, records)
    want = ref_integ.make_cutout_closest(L["r_ds"], r_acc, r_close,
                                         meta=L["r_meta"])
    got = port_integ.make_cutout_closest(L["p_ds"], p_acc, p_close,
                                         meta=L["p_meta"])
    tmax = np.where(L["tmax"] < 0, -1.0, np.inf).astype(np.float32)
    w = want(jnp.asarray(L["org"]), jnp.asarray(L["d"]), 0.0,
             jnp.asarray(tmax))
    g = got(T(L["org"]), T(L["d"]), 0.0, T(tmax))
    valid = np.asarray(w.valid)
    np.testing.assert_array_equal(g.valid.numpy(), valid)
    for f in ("tri", "inst", "slot"):
        np.testing.assert_array_equal(getattr(g, f).numpy()[valid],
                                      np.asarray(getattr(w, f))[valid], f)
    np.testing.assert_allclose(g.t.numpy()[valid], np.asarray(w.t)[valid],
                               rtol=1e-6)
    for f in ("u", "v"):
        np.testing.assert_allclose(getattr(g, f).numpy()[valid],
                                   np.asarray(getattr(w, f))[valid],
                                   atol=1e-4)
    # hits beyond the first quad: candidates were skipped
    ground = L["rs"].instances[0].mesh_id
    assert (np.asarray(w.inst)[valid] == ground).mean() > 0.2


def test_cutout_stats_fold_over_rounds(layered):
    """Each round's stats fold into the wrapper's: pair counts summed,
    the overflow flag at its largest, live-cap overflow summed."""
    L = layered
    close, _ = port_brute(L["p_ds"], L["p_meta"])
    calls = []

    def counted(o, d, t0, t1):
        return close(o, d, t0, t1)

    def with_stats(o, d, t0, t1):
        calls.append(len(calls))
        k = float(len(calls))
        return close(o, d, t0, t1), torch.tensor([10.0 * k, k % 2, k])

    counted.with_stats = with_stats
    for make in (lambda: port_integ.make_occluder(
                     L["p_ds"], None, counted, None, meta=L["p_meta"]),
                 lambda: port_integ.make_cutout_closest(
                     L["p_ds"], None, counted, meta=L["p_meta"])):
        calls.clear()
        _, st = make().with_stats(T(L["org"]), T(L["d"]), 0.0,
                                  T(L["tmax"]))
        r = port_integ.ALPHA_OCCLUSION_ROUNDS
        assert len(calls) == r
        np.testing.assert_array_equal(
            st.numpy(), [10.0 * r * (r + 1) / 2, 1.0, r * (r + 1) / 2])


def test_opaque_scene_keeps_lean_path():
    """No alpha-tested material: the wrappers hand back the very
    intersectors they were given, and the staged renderer traces through
    the tile intersector's own closures."""
    ps = base_scene(port_types, port_camera)
    meta = port_meta(ps)
    assert not meta.has_alpha_cutout
    sentinel = object()
    assert port_integ.make_occluder(None, None, None, sentinel,
                                    meta=meta) is sentinel
    assert port_integ.make_cutout_closest(None, None, sentinel,
                                          meta=meta) is sentinel
    cfg = get_config("cornell", scene="custom", width=32, height=32,
                     spp=1, spp_per_batch=1, max_bounces=1)
    ds = port_to_device(ps, device="cpu")
    acc = port_build(ds, meta, scene=ps).to("cpu")
    r = StagedRenderer(ds, acc, meta=meta, config=cfg, device="cpu")
    for fn in r.closest + r.occluders:
        assert "make_tile_intersector" in fn.__qualname__
    cut = add_cutout_quad(port_types, base_scene(port_types, port_camera),
                          checker(), 0.5)
    cmeta = port_meta(cut)
    cds = port_to_device(cut, device="cpu")
    r = StagedRenderer(cds, port_build(cds, cmeta, scene=cut).to("cpu"),
                       meta=cmeta, config=cfg, device="cpu")
    assert all("make_cutout_closest" in fn.__qualname__ for fn in r.closest)
    assert all("make_occluder" in fn.__qualname__ for fn in r.occluders)


def test_render_matches_reference():
    """A cut-out, textured scene end to end through render_scene in both
    packages (bvh_tile, the staged loop): the layered checkers over the
    ground, 32×24 × 2 spp, one bounce with NEE."""
    over = dict(scene="custom", width=32, height=24, spp=2, spp_per_batch=2,
                max_bounces=1, intersector="bvh_tile")
    state, stats = render_scene(get_config("cornell", **over), device="cpu",
                                scene=layered_scene(port_types, port_camera))
    ref_state, ref_stats = ref_render(
        ref_config("cornell", pipeline="staged", **over),
        scene=layered_scene(ref_types, ref_camera))
    img = fb.resolve(state).numpy()
    want = np.asarray(ref_fb.resolve(ref_state))
    assert img.shape == want.shape == (24, 32, 3) and np.isfinite(img).all()
    assert abs(float(img.mean()) - float(want.mean())) <= 1e-3
    assert float(np.sqrt(np.mean((img - want) ** 2))) <= 1e-3
    assert not stats["pair_overflow"] and not ref_stats["pair_overflow"]
    # rays count once a wave, whatever the number of cut-out rounds
    assert stats["rays_closest"] == ref_stats["rays_closest"]
    assert stats["rays_shadow"] == ref_stats["rays_shadow"]


# --- the port alone, as tests/unit/test_alpha_cutout.py ---------------------

def _render(scene, **overrides):
    cfg = get_config("cornell", scene="custom", width=64, height=48, spp=4,
                     spp_per_batch=2, max_bounces=1, **overrides)
    state, stats = render_scene(cfg, device="cpu", scene=scene)
    return fb.resolve(state).numpy(), stats


def _base():
    return base_scene(port_types, port_camera)


def _cut(rgba, cutoff):
    return add_cutout_quad(port_types, _base(), rgba, cutoff)


@pytest.mark.parametrize("intersector", ["bvh_tile", "bvh_packet"])
def test_fully_transparent_equals_no_quad(intersector):
    clear = np.zeros((2, 2, 4), np.float32) + [1, 1, 1, 0]
    img_none, _ = _render(_base(), intersector=intersector)
    img_clear, _ = _render(_cut(clear, 0.5), intersector=intersector)
    np.testing.assert_allclose(img_clear, img_none, atol=2e-3)


@pytest.mark.parametrize("intersector", ["bvh_tile", "bvh_packet"])
def test_fully_opaque_equals_opaque_quad(intersector):
    opaque = np.ones((2, 2, 4), np.float32)
    img_cut, _ = _render(_cut(opaque, 0.5), intersector=intersector)
    img_opq, _ = _render(_cut(opaque, 0.0), intersector=intersector)
    np.testing.assert_allclose(img_cut, img_opq, atol=1e-5)


@pytest.mark.parametrize("intersector", ["bvh_tile", "bvh_packet"])
def test_checkerboard_equals_geometric_cutout(intersector):
    """A 2×2 checker alpha on the quad equals its two opaque texels as
    real sub-quads: primary, shadow and bounce rays agree."""
    img_cut, _ = _render(_cut(checker(1), 0.5), intersector=intersector)
    # opaque texels (alpha 1): image (row 0, col 1) and (row 1, col 0);
    # v-down maps them to uv [0.5:1, 0:0.5] and [0:0.5, 0.5:1]
    geo = _base()
    mat = geo.add_material(port_types.Material(kind=port_types.LAMBERT,
                                    albedo=(0.4, 0.8, 0.4)))
    for (u0, v0) in ((0.5, 0.0), (0.0, 0.5)):
        x0, z0 = -1.5 + u0 * 3.0, -1.5 + v0 * 3.0
        v, i, _ = _quad(x0, z0, x0 + 1.5, z0 + 1.5, 2.0)
        geo.add_instance(port_types.Instance(geo.add_mesh(
            port_types.Mesh(vertices=v, indices=i, material_ids=mat))))
    img_geo, _ = _render(geo, intersector=intersector)
    np.testing.assert_allclose(img_cut, img_geo, atol=2e-3)

