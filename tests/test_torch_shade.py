"""The staged loop's shade kernel (S1, ``csrc/shade.cu``) and the rule
that chooses it (``kernels.shade``).

On the CPU: which accel, texture filter, shading mode and device give
the kernel path ("cuda") or the PyTorch path ("plain", with a reason);
the host-side packing of the kernel's scene arguments; the CPU render
on the PyTorch path, unchanged, with no wave shaded by the kernel.

On the card: the kernel against ``StagedRenderer._shade`` (the PyTorch
path) on made-up waves of every material family (Lambert, Blinn-Phong,
mirror with and without fuzz, dielectric front and back with total
internal reflection), emissive hits, misses, dead rays, both
``allow_emission`` values, NEE on and off, every bounce up to
``max_bounces`` and a nearest-textured record, and the same on the
two-level instantiation (object-space records through an instance
table: material overrides, one emissive, a mirrored instance, misses
at instance −1 with an override on instance 0, a textured mesh with an
overridden instance): the masks and counters
equal, the floats within 1e-5 relative and 1e-6 absolute on at least
99.9% of rays (the kernel repeats the PyTorch path's f32 operations in
its order, that of torch's CUDA sums included, and came out bit-equal on
an H100; the tolerance leaves another torch build room to sum
otherwise); on a Lambert wave whose normal is +z the next directions are
bit-equal, so the draws are PixelSampler's bits. Bunny,
Cornell and two-level sponza renders with graphs on hold the kernel path
to the PyTorch path by the benchmark's accumulation check (``perfbench/check.py``:
channels off by over 1e-4 relative, 1e-6 absolute; at most 5% of them).

This file imports neither jax nor tpurt: the card tests run where only
the port's dependencies are installed,

    python -m pytest --noconftest -q tests/test_torch_shade.py
"""

import dataclasses
import types

import pytest
import torch

from tpurt_torch import kernels, materials
from tpurt_torch.bvh.paircluster import SHADE_LANES
from tpurt_torch.core.prng import PixelSampler
from tpurt_torch.kernels import shade as sk
from tpurt_torch.render import build_accel, render_scene, scene_meta
from tpurt_torch.render.intersectors import Hit
from tpurt_torch.render.staged import StagedRenderer, WaveState
from tpurt_torch.scene.device import to_device
from tpurt_torch.scene.procedural import (bunny_standin, cornell_box,
                                          sponza_standin)
from tpurt_torch.scene.types import BLINN_PHONG, DIELECTRIC, LAMBERT, MIRROR
from tpurt_torch.utils.config import get_config

SMALL = dict(width=32, height=24, spp=2, spp_per_batch=2, max_bounces=2)
N_RAYS = 4096
REL, ABS, SHARE = 1e-5, 1e-6, 0.999  # a ray's floats, the rays that hold
OFF_REL, OFF_ABS, OFF_LIMIT = 1e-4, 1e-6, 0.05  # perfbench's accumulation


def _context(scene, device="cpu", **over):
    cfg = get_config("bunny", **{**SMALL, **over})
    ds = to_device(scene, device=device)
    meta = scene_meta(scene)
    accel = build_accel(cfg, ds, meta, scene=scene, device=device)
    return cfg, ds, meta, accel


@pytest.fixture(scope="module")
def bunny():
    return bunny_standin(subdivisions=3)


# --- the rule, on the CPU ----------------------------------------------------

CUDA = torch.device("cuda", 0)  # a device name: nothing is put there


def _textured(ds):
    """The scene with a 2-texture pool beside its white fallback."""
    data = torch.rand((1 + 4 * 4 + 2 * 3, 3), generator=torch.Generator()
                      .manual_seed(5))
    data[0] = 1.0
    meta = torch.tensor([[1.0, 4.0, 4.0, 0.0], [17.0, 2.0, 3.0, 0.0]])
    return ds._replace(tex_data=data, tex_meta=meta)


@pytest.mark.parametrize("case,path,reason", [
    ("flat_accel", "cuda", ""),
    ("flat_accel_nearest_textures", "cuda", ""),
    ("flat_accel_bilinear_untextured", "cuda", ""),
    ("cpu", "plain", "the CPU"),
    ("two_level", "cuda", ""),
    ("two_level_bilinear_textures", "plain", "bilinear textures"),
    ("two_level_cpu", "plain", "the CPU"),
    ("packet", "plain", "no shade records"),
    ("bilinear_textures", "plain", "bilinear textures"),
    ("flat_shading", "plain", "flat shading"),
])
def test_shade_path_rule(bunny, case, path, reason):
    """Which accel, texture filter, shading mode and device give the
    kernel path, and the reason of each plain one."""
    over, device = {}, CUDA
    if case.startswith("two_level"):
        over = dict(instancing="two_level")
    if case == "packet":
        over = dict(intersector="bvh_packet")
    elif case.endswith("bilinear_textures") or \
            case == "flat_accel_bilinear_untextured":
        over = dict(over, texture_filter="bilinear")
    elif case == "flat_shading":
        over = dict(shading_mode="flat")
    elif case.endswith("cpu"):
        device = "cpu"
    cfg, ds, meta, accel = _context(bunny, **over)
    two_level = getattr(accel, "inst_table", None) is not None
    assert two_level == case.startswith("two_level")
    if case in ("flat_accel_nearest_textures", "bilinear_textures",
                "two_level_bilinear_textures"):
        ds = _textured(ds)
    got, why = sk.shade_path(ds, accel, cfg, device)
    assert got == path
    assert why.startswith(reason) and (why == "") == (path == "cuda")


@pytest.mark.parametrize("instancing", ["auto", "two_level"],
                         ids=["flat", "two_level"])
def test_renderer_records_its_shade_path_on_the_cpu(bunny, instancing):
    cfg, ds, meta, accel = _context(bunny, instancing=instancing)
    r = StagedRenderer(ds, accel, meta=meta, config=cfg, device="cpu")
    assert (r.shade_path, r.shade_tables) == ("plain", None)
    assert r.shade_reason == sk.shade_path(ds, accel, cfg, "cpu")[1] != ""


@pytest.mark.parametrize("textured", [False, True],
                         ids=["untextured", "textured"])
def test_shade_tables_pack_the_scene(bunny, textured):
    """The kernel's light rows and scalars, field by field from the
    DeviceScene; the texture pool only where the scene has textures."""
    cfg, ds, meta, accel = _context(bunny)
    if textured:
        ds = _textured(ds)
    t = sk.shade_tables(ds, accel)
    assert t.lights.shape == (ds.light_v0.shape[0], sk.LIGHT_LANES)
    for lanes, field in ((slice(0, 3), ds.light_v0),
                         (slice(3, 6), ds.light_v1),
                         (slice(6, 9), ds.light_v2),
                         (slice(9, 12), ds.light_emission),
                         (12, ds.light_area)):
        assert torch.equal(t.lights[:, lanes], field)
    assert not t.lights[:, 13:].any()
    assert t.num_lights == int(ds.num_lights) == 2
    assert t.background == tuple(ds.background.tolist())
    assert torch.equal(t.shade_rows, accel.shade_rows)
    assert t.shade_rows.shape[1] == SHADE_LANES == 32
    if textured:
        assert torch.equal(t.tex_data, ds.tex_data)
        assert torch.equal(t.tex_meta, ds.tex_meta)
    else:
        assert t.tex_data is None and t.tex_meta is None


@pytest.mark.parametrize("instancing", ["auto", "two_level"],
                         ids=["flat", "two_level"])
def test_shade_tables_pack_the_instance_table(bunny, instancing):
    """The two-level accel's instance rows go to the kernel as they are:
    (I, 24) f32, contiguous, 16-byte aligned (read as float4 rows); the
    flat accel has none."""
    cfg, ds, meta, accel = _context(bunny, instancing=instancing)
    t = sk.shade_tables(ds, accel)
    if instancing == "auto":
        assert getattr(accel, "inst_table", None) is None
        assert t.inst_table is None
        return
    it = t.inst_table
    assert it.dtype == torch.float32 and it.is_contiguous()
    assert it.shape == (accel.inst_table.shape[0], 24) and it.shape[0] >= 1
    assert it.data_ptr() % 16 == 0
    assert torch.equal(it, accel.inst_table)


@pytest.mark.parametrize("over", [{}, dict(sorted_wave=True),
                                  dict(use_nee=False)],
                         ids=["fused", "sorted", "no_nee"])
def test_cpu_render_takes_the_pytorch_shade(bunny, over):
    """The CPU render is the PyTorch shade's, bit for bit: the stage
    programs against the loop's stages called by hand with the batch's
    sampler, and no wave shaded by the kernel."""
    cfg = get_config("bunny", **{**SMALL, **over})
    state, stats = render_scene(cfg, scene=bunny, device="cpu")
    assert stats["shade_waves_cuda"] == 0
    _, ds, meta, accel = _context(bunny, **over)
    r = StagedRenderer(ds, accel, meta=meta, config=cfg, device="cpu")
    r.set_inputs(bunny.camera, cfg.seed, 0)
    wave = r.raygen(r.camera(), r.seed_buf, r.sample0_buf)
    sampler = PixelSampler.make(r.seed_buf, r.sample0_buf + r.ds_r, r.pid)
    for b in range(cfg.max_bounces + 1):
        hit, wave = r.trace(wave, b)
        wave, shadow = r._shade(wave, hit, sampler, b)
        if shadow is not None:
            wave = r.occlude(wave, shadow, b)
    img, _ = r.resolve(wave)
    assert torch.equal(img.reshape(-1), state.accum.reshape(-1))


def test_shade_with_the_batch_streams_equals_the_batch_sampler(bunny):
    """``shade(..., None, b)`` (the batch's own streams, as the kernel
    hashes them) is ``shade`` with the batch's PixelSampler."""
    cfg, ds, meta, accel = _context(bunny)
    r = StagedRenderer(ds, accel, meta=meta, config=cfg, device="cpu")
    r.set_inputs(bunny.camera, 2**31 + 77, 3)
    hit, wave = r.raygen_trace0()
    a = r.shade(wave, hit, None, 0)
    b = r.shade(wave, hit, r.sampler(r.seed_buf, r.sample0_buf), 0)
    for x, y in zip((*a[0], *a[1]), (*b[0], *b[1])):
        # a miss's contribution is NaN (its hit point lies at infinity)
        assert torch.equal(x, y) or torch.allclose(x, y, rtol=0, atol=0,
                                                   equal_nan=True)


# --- made-up waves ------------------------------------------------------------

FAMILIES = ("lambert", "blinn_phong", "mirror", "mirror_fuzz", "dielectric",
            "mixed")


def made_up_records(family: str, n_rows: int, gen, textured=False,
                    flat_z=False):
    """(n_rows, 32) shade records of one family ("mixed": all of them),
    every fourth emissive; textured: texture ids -1, 0 and 1, UVs over
    [-2, 3] (REPEAT wrap). ``flat_z``: Lambert records whose normals are
    exactly +z."""
    rnd = lambda *s: torch.rand(s, generator=gen)
    rec = torch.zeros((n_rows, SHADE_LANES))
    normal = lambda: torch.randn((n_rows, 3), generator=gen)
    rec[:, 0:3] = normal() * 2.0  # geometric normal, unnormalized
    for k in (3, 6, 9):
        rec[:, k:k + 3] = normal()
    kinds = dict(lambert=LAMBERT, blinn_phong=BLINN_PHONG, mirror=MIRROR,
                 mirror_fuzz=MIRROR, dielectric=DIELECTRIC)
    if family == "mixed":
        kind = torch.arange(n_rows) % 4
    else:
        kind = torch.full((n_rows,), kinds[family])
    rec[:, 12] = kind.float()
    rec[:, 13:16] = 0.2 + 0.7 * rnd(n_rows, 3)
    rec[::4, 16:19] = 5.0 * rnd((n_rows + 3) // 4, 3)
    p0 = torch.where(kind == BLINN_PHONG, 1.0 + 199.0 * rnd(n_rows),
                     torch.where(kind == DIELECTRIC, 1.5, 0.0))
    if family in ("mirror_fuzz", "mixed"):
        p0 = torch.where(kind == MIRROR, 0.3 * rnd(n_rows), p0)
    rec[:, 19] = p0
    rec[:, 20] = torch.where(kind == BLINN_PHONG, rnd(n_rows), 0.0)
    rec[:, 21] = kind.float()
    rec[:, 22:28] = -2.0 + 5.0 * rnd(n_rows, 6)
    rec[:, 28] = (torch.arange(n_rows) % 3 - 1).float() if textured else -1.0
    if flat_z:
        rec[:, 0:12] = torch.tensor([0.0, 0.0, 1.0] * 4)
        rec[:, 12] = float(LAMBERT)
        rec[:, 16:19] = 0.0
    return rec


def made_up_wave(r, n: int, n_rows: int, gen, flat_z=False):
    """A wave of ``n`` rays on renderer ``r``'s device with hits on
    ``n_rows`` records: about 10% dead, 15% misses (slot −1), half
    ``allow_emission``, throughputs down to below 1e-6, large pixel ids
    and samples. ``flat_z``: every ray hits at u = v = 0."""
    dev = r.device
    rnd = lambda *s: torch.rand(s, generator=gen)
    ints = lambda hi: torch.randint(0, hi, (n,), generator=gen)
    dirn = torch.randn((n, 3), generator=gen)
    dirn = dirn / dirn.norm(dim=1, keepdim=True)
    thr = rnd(n, 3)
    thr[::37] = 5e-7
    valid = rnd(n) > 0.15
    slot = torch.where(valid, ints(n_rows), -1).to(torch.int32)
    u, v = rnd(n), rnd(n)
    u, v = torch.where(u + v > 1.0, 1.0 - u, u), torch.where(
        u + v > 1.0, 1.0 - v, v)
    if flat_z:
        u, v = torch.zeros(n), torch.zeros(n)
    ncount = r.ncount
    state = WaveState(
        org=torch.randn((n, 3), generator=gen) * 2.0, dirn=dirn,
        radiance=rnd(n, 3), throughput=thr, alive=rnd(n) > 0.1,
        allow_emission=rnd(n) > 0.5, pix=ints(2**31 - 1) * 3,
        sample=ints(64), rays=torch.arange(ncount, dtype=torch.float64))
    hit = Hit(t=0.1 + 5.0 * rnd(n), u=u, v=v,
              tri=torch.zeros(n, dtype=torch.int32),
              inst=torch.zeros(n, dtype=torch.int32), valid=valid,
              slot=slot)
    to = lambda x: x.to(dev)
    return (WaveState(*(to(f) for f in state)),
            Hit(*(to(f) for f in hit)))


N_INST = 6


def made_up_inst_table(gen):
    """(N_INST, 24) instance rows (``PairAccelTL.inst_table``): normal
    matrices near the identity; instance 1 mirrored (det sign −1);
    material overrides on instance 0 (a fuzzy mirror, so a miss, which
    resolves at instance 0, takes a specular kind), 2 (an emissive
    Lambert) and 4 (Blinn-Phong); the rest keep their records'
    materials."""
    table = torch.zeros((N_INST, 24))
    nm = torch.eye(3) + 0.3 * torch.randn((N_INST, 3, 3), generator=gen)
    nm[1] = nm[1] @ torch.diag(torch.tensor([-1.0, 1.0, 1.0]))
    table[:, 0:9] = nm.reshape(N_INST, 9)
    table[:, 9] = torch.sign(torch.linalg.det(nm))
    assert table[1, 9] == -1.0 and (table[:, 9] != 0).all()
    for i, kind, albedo, emission, p0, p1 in (
            (0, MIRROR, (0.9, 0.8, 0.7), (0.0, 0.0, 0.0), 0.1, 0.0),
            (2, LAMBERT, (0.3, 0.6, 0.2), (4.0, 3.0, 2.0), 0.0, 0.0),
            (4, BLINN_PHONG, (0.5, 0.5, 0.8), (0.0, 0.0, 0.0), 40.0, 0.6)):
        table[i, 10:21] = torch.tensor([1.0, float(kind), *albedo,
                                        *emission, p0, p1, float(kind)])
    return table


def with_instances(hit, gen):
    """``hit`` with every hit's instance drawn from the table's and −1 on
    every miss, as the two-level intersector gives them."""
    inst = torch.randint(0, N_INST, hit.valid.shape, generator=gen)
    inst = torch.where(hit.valid.cpu(), inst, -1).to(torch.int32)
    return hit._replace(inst=inst.to(hit.valid.device))


def use_records(r, rec, ds=None, inst_table=None, **config):
    """Point both of ``r``'s shade paths at the records ``rec`` (and the
    scene ``ds``, an instance table, which makes the records object
    space, and config changes such as ``use_nee``)."""
    ds = r.ds if ds is None else ds
    accel = types.SimpleNamespace(
        shade_rows=rec.to(r.device),
        inst_table=None if inst_table is None else inst_table.to(r.device))
    r.ds = ds
    r.config = dataclasses.replace(r.config, **config)
    r.resolver = materials.make_resolver(
        ds, accel, texture_filter=r.config.texture_filter)
    r.shade_tables = sk.shade_tables(ds, accel)


def compare_shades(got, want, state, hit):
    """The masks and counters equal; a ray's floats within REL/ABS on at
    least SHARE of the rays (the contribution where a shadow ray is
    wanted: elsewhere no caller reads it). Returns the share that
    held."""
    (g, gs), (w, ws) = got, want
    hv = (hit.valid & state.alive).cpu()
    assert torch.equal(g.alive, w.alive)
    assert torch.equal(g.allow_emission, w.allow_emission)
    assert torch.equal(g.rays, w.rays)
    assert torch.equal(g.pix, w.pix) and torch.equal(g.sample, w.sample)
    floats = [(g.org, w.org), (g.dirn, w.dirn), (g.radiance, w.radiance),
              (g.throughput, w.throughput)]
    assert (gs is None) == (ws is None)
    if ws is not None:
        assert torch.equal(gs[4], ws[4])
        want_ = ws[4][:, None]
        floats += [(gs[0], ws[0]), (gs[1], ws[1]),
                   (gs[2][:, None], ws[2][:, None]),
                   (torch.where(want_, gs[3], 0.0),
                    torch.where(want_, ws[3], 0.0))]
    ok = torch.ones(hv.shape[0], dtype=torch.bool)
    for a, b in floats:
        a, b = a.cpu(), b.cpu()
        close = (a - b).abs() <= ABS + REL * b.abs()
        ok &= close.all(dim=1)
    share = float(ok.float().mean())
    assert share >= SHARE, share
    return share


def shade_both(r, state, hit, bounce):
    """(the kernel's shade, the PyTorch path's) of one wave, each with
    the renderer's batch streams."""
    got = r.shade(state, hit, None, bounce)
    sampler = PixelSampler.make(r.seed_buf, r.sample0_buf + state.sample,
                                state.pix)
    want = r._shade(state, hit, sampler, bounce)
    return got, want


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch finds none)")
    return torch.device("cuda", 0)


@pytest.fixture
def cuda_renderer(cuda_device, bunny):
    cfg, ds, meta, accel = _context(bunny, device=cuda_device)
    r = StagedRenderer(ds, accel, meta=meta, config=cfg, device=cuda_device)
    assert r.shade_path == "cuda" and r.shade_reason == ""
    r.set_inputs(bunny.camera, 2**31 + 12345, 17)
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("nee", [True, False], ids=["nee", "no_nee"])
@pytest.mark.parametrize("bounce", [0, 1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_shade_kernel_matches_pytorch_on_made_up_waves(cuda_renderer,
                                                       family, bounce, nee):
    r = cuda_renderer
    gen = torch.Generator().manual_seed(100 * bounce + len(family))
    use_records(r, made_up_records(family, 61, gen), use_nee=nee)
    state, hit = made_up_wave(r, N_RAYS, 61, gen)
    kernels.reset_launch_counts()
    got, want = shade_both(r, state, hit, bounce)
    assert kernels.launch_counts()["shade"] == 1
    compare_shades(got, want, state, hit)
    g = got[0]
    hv = hit.valid & state.alive
    assert bool((~g.alive | hv).all())  # only a shaded hit lives on
    if bounce == r.config.max_bounces:
        assert not bool(g.alive.any())
    if nee and family in ("lambert", "blinn_phong", "mixed"):
        assert int(got[1][4].sum()) > 0  # some shadow rays wanted
    if family == "dielectric":  # both sides, and total internal reflection
        d, rec = state.dirn, r.shade_tables.shade_rows
        ng = rec[hit.slot.clamp_min(0).long(), 0:3]
        front = (ng * d).sum(1) < 0
        assert bool((hv & front).any()) and bool((hv & ~front).any())
        back_sin2 = 1.0 - (ng * d).sum(1) ** 2 / (ng * ng).sum(1)
        assert bool((hv & ~front & (2.25 * back_sin2 > 1.0)).any())


@pytest.mark.cuda
def test_shade_kernel_matches_pytorch_on_a_textured_wave(cuda_renderer):
    r = cuda_renderer
    gen = torch.Generator().manual_seed(9)
    ds = _textured(r.ds)
    ds = ds._replace(tex_data=ds.tex_data.to(r.device),
                     tex_meta=ds.tex_meta.to(r.device))
    use_records(r, made_up_records("mixed", 61, gen, textured=True), ds=ds)
    assert r.shade_tables.tex_data is not None
    state, hit = made_up_wave(r, N_RAYS, 61, gen)
    compare_shades(*shade_both(r, state, hit, 0), state, hit)


@pytest.mark.cuda
def test_shade_kernel_takes_a_samplers_base(cuda_renderer):
    """Given a PixelSampler (a caller's own streams), the kernel reads
    its base instead of hashing the batch's."""
    r = cuda_renderer
    gen = torch.Generator().manual_seed(4)
    use_records(r, made_up_records("mixed", 61, gen))
    state, hit = made_up_wave(r, N_RAYS, 61, gen)
    sampler = PixelSampler.make(7, state.sample + 5, state.pix)
    got = r.shade(state, hit, sampler, 1)
    want = r._shade(state, hit, sampler, 1)
    compare_shades(got, want, state, hit)


@pytest.mark.cuda
def test_shade_kernel_draws_are_pixel_sampler_bits(cuda_renderer):
    """A Lambert wave with +z normals hit at u = v = 0: the next
    direction is (r cos phi, r sin phi, z) of the two diffuse draws on
    both paths, so equal bits there are equal draws."""
    r = cuda_renderer
    gen = torch.Generator().manual_seed(11)
    use_records(r, made_up_records("lambert", 61, gen, flat_z=True))
    state, hit = made_up_wave(r, N_RAYS, 61, gen, flat_z=True)
    (g, _), (w, _) = shade_both(r, state, hit, 1)
    hv = hit.valid & state.alive
    assert int(hv.sum()) > N_RAYS // 2
    assert torch.equal(g.dirn[hv], w.dirn[hv])
    assert torch.equal(g.dirn, w.dirn)


@pytest.mark.cuda
@pytest.mark.parametrize("nee", [True, False], ids=["nee", "no_nee"])
@pytest.mark.parametrize("bounce", [0, 2])
@pytest.mark.parametrize("family", ["mixed", "blinn_phong", "dielectric"])
def test_two_level_shade_kernel_matches_pytorch(cuda_renderer, family,
                                                bounce, nee):
    """S1's two-level instantiation against ``_shade`` on the two-level
    resolve: overridden, emissive and mirrored instances, misses at
    instance −1 whose kind comes from instance 0's override."""
    r = cuda_renderer
    gen = torch.Generator().manual_seed(300 + 10 * bounce + len(family))
    table = made_up_inst_table(gen)
    use_records(r, made_up_records(family, 61, gen), inst_table=table,
                use_nee=nee)
    state, hit = made_up_wave(r, N_RAYS, 61, gen)
    hit = with_instances(hit, gen)
    kernels.reset_launch_counts()
    got, want = shade_both(r, state, hit, bounce)
    counts = kernels.launch_counts()
    assert (counts["shade_tl"], counts["shade"]) == (1, 0)
    compare_shades(got, want, state, hit)
    hv = (hit.valid & state.alive).cpu()
    inst = hit.inst.cpu().long()
    for i in (0, 1, 2, 4):  # each special instance is shaded
        assert bool((hv & (inst == i)).any())
    # a miss resolves at instance 0, a mirror override: allow_emission
    # set on every miss, with NEE on too
    miss = ~hit.valid.cpu()
    assert bool(got[0].allow_emission.cpu()[miss].all())
    if bounce == 0 and nee:  # an emissive override adds its emission
        em = hv & (inst == 2) & state.allow_emission.cpu()
        assert bool(em.any())


@pytest.mark.cuda
def test_two_level_shade_kernel_matches_pytorch_on_a_textured_wave(
        cuda_renderer):
    """A textured mesh whose instance 2 overrides its material: the
    override samples the white fallback texel, the others their texture
    at the record's UVs."""
    r = cuda_renderer
    gen = torch.Generator().manual_seed(19)
    ds = _textured(r.ds)
    ds = ds._replace(tex_data=ds.tex_data.to(r.device),
                     tex_meta=ds.tex_meta.to(r.device))
    use_records(r, made_up_records("mixed", 61, gen, textured=True), ds=ds,
                inst_table=made_up_inst_table(gen))
    assert r.shade_tables.tex_data is not None
    assert r.shade_tables.inst_table is not None
    state, hit = made_up_wave(r, N_RAYS, 61, gen)
    hit = with_instances(hit, gen)
    compare_shades(*shade_both(r, state, hit, 1), state, hit)


def _off_share(a, b):
    """perfbench's accumulation check: the share of channels off by over
    OFF_REL relative (or OFF_ABS)."""
    d = (a - b).abs()
    return float((d > OFF_ABS + OFF_REL * b.abs()).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["bunny", "cornell", "sponza_small"])
def test_kernel_renders_match_the_pytorch_shade_with_graphs(cuda_device,
                                                            preset):
    """A render with graphs on through the kernel against the same
    renderer's PyTorch shade: within the benchmark's accumulation limit,
    every wave of the batches shaded by the kernel (its two-level
    instantiation on sponza_small's two-level accel)."""
    scene = dict(bunny=lambda: bunny_standin(subdivisions=3),
                 cornell=cornell_box,
                 sponza_small=lambda: sponza_standin(8, 3))[preset]()
    cfg = get_config(preset.split("_")[0], width=96, height=64, spp=4,
                     spp_per_batch=2, max_bounces=2)
    ds = to_device(scene, device=cuda_device)
    meta = scene_meta(scene)
    accel = build_accel(cfg, ds, meta, scene=scene, device=cuda_device)
    out = {}
    for path in ("cuda", "plain"):
        r = StagedRenderer(ds, accel, meta=meta, config=cfg,
                           device=cuda_device)
        assert r.shade_path == "cuda"
        r.shade_path = path
        assert r.prewarm(scene.camera, cfg.seed, 0) > 0 and r.graphs
        kernels.reset_launch_counts()
        img = sum(r(scene.camera, cfg.seed, s0)[0] for s0 in (0, 2))
        out[path] = (img, kernels.launch_counts())
    key, other = (("shade_tl", "shade") if preset == "sponza_small"
                  else ("shade", "shade_tl"))
    assert (accel.inst_table is not None if preset == "sponza_small"
            else getattr(accel, "inst_table", None) is None)
    (img, got), (ref, plain) = out["cuda"], out["plain"]
    waves = 2 * (cfg.max_bounces + 1)
    assert (got[key], got.get(other, 0), got.get("shade.plain", 0)) == (
        waves, 0, 0)
    assert (plain.get(key, 0), plain["shade.plain"]) == (0, waves)
    assert bool(torch.isfinite(img).all())
    assert _off_share(img, ref) <= OFF_LIMIT


@pytest.mark.cuda
def test_render_scene_counts_kernel_waves(cuda_device, bunny):
    cfg = get_config("bunny", **SMALL)
    _, stats = render_scene(cfg, scene=bunny, device=cuda_device)
    assert stats["shade_waves_cuda"] > 0
