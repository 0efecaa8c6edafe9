"""The staged loop's shade of one wave as one CUDA kernel (S1,
``csrc/shade.cu``): resolve, emission, NEE setup, BRDF, bounce sampling
and the per-pixel hash, one thread a ray.

The reference has no kernel here (it leaves its shading to XLA); the
plain version is ``StagedRenderer._shade`` (``render/staged.py``), the
materials and ``core.prng`` code the staged loop runs on the CPU and on
every path the kernel does not take. ``shade_path`` is the rule, decided
when a renderer is built, from what the renderer can observe: the kernel
resolves a pair-cluster accel's shade records with the nearest texel, so
it takes a CUDA device, shade records (not the packet BVH's per-field
resolve), no bilinear textures, and a shading mode that shades (not
flat). The flat accel's records are world space (``PairAccel``); the
two-level accel's are object space beside an instance table
(``PairAccelTL``), which the kernel's two-level instantiation reads
(launch key ``shade_tl``). ``shade_tables`` packs the scene's side of the
kernel's arguments once a renderer; ``shade_cuda`` launches it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpurt_torch import kernels
from tpurt_torch.core.vecmath import EPS_RAY
from tpurt_torch.kernels.tilewave import _check

LIGHT_LANES = 16  # floats a light row: v0, v1, v2, emission, area, pad


def shade_path(ds, accel, config, device) -> tuple:
    """("cuda", "") where the shade kernel shades the staged loop's waves,
    else ("plain", why)."""
    if config.shading_mode == "flat":
        return "plain", "flat shading: the hit's albedo, no shade"
    if getattr(accel, "shade_rows", None) is None:
        return "plain", ("no shade records: the packet BVH's hits resolve "
                         "per field")
    if config.texture_filter == "bilinear" and ds.tex_data.shape[0] > 1:
        return "plain", "bilinear textures: four texels a hit"
    if torch.device(device).type != "cuda":
        return "plain", "the CPU: the shade kernel runs on the card"
    return "cuda", ""


class ShadeTables(NamedTuple):
    """The scene's side of the kernel's arguments."""

    shade_rows: torch.Tensor  # (S, 32) f32 shade records
    lights: torch.Tensor  # (L, LIGHT_LANES) f32
    num_lights: int  # ds.num_lights (the light rows past it are padding)
    tex_data: Optional[torch.Tensor]  # (P, 3) f32, None: untextured
    tex_meta: Optional[torch.Tensor]  # (Ntex, 4) f32, None: untextured
    background: tuple  # (3,) floats
    # (I, 24) f32 instance rows of the two-level accel (its records are
    # object space), None: the flat accel
    inst_table: Optional[torch.Tensor] = None


def shade_tables(ds, accel) -> ShadeTables:
    """Pack the light rows (v0, v1, v2, emission, area) and read the
    scalars the kernel takes by value (one host read, when a renderer is
    built). A scene whose pool holds only the white fallback texel is
    untextured, as for ``materials.make_resolver``."""
    n_l = ds.light_v0.shape[0]
    lights = torch.zeros((n_l, LIGHT_LANES), dtype=torch.float32,
                         device=ds.light_v0.device)
    lights[:, 0:3] = ds.light_v0
    lights[:, 3:6] = ds.light_v1
    lights[:, 6:9] = ds.light_v2
    lights[:, 9:12] = ds.light_emission
    lights[:, 12] = ds.light_area
    textured = ds.tex_data.shape[0] > 1
    inst_table = getattr(accel, "inst_table", None)
    return ShadeTables(
        shade_rows=accel.shade_rows.contiguous(),
        lights=lights,
        num_lights=int(ds.num_lights),
        tex_data=ds.tex_data.contiguous() if textured else None,
        tex_meta=ds.tex_meta.contiguous() if textured else None,
        background=tuple(float(c) for c in ds.background.cpu()),
        inst_table=None if inst_table is None else inst_table.contiguous(),
    )


def shade_cuda(tables: ShadeTables, state, hit, *, bounce: int,
               max_bounces: int, use_nee: bool, shadow_eps: float, seed,
               sample0, base=None):
    """Shade one wave on the current stream. ``state``: the staged loop's
    WaveState; ``hit``: its closest hits. ``seed`` and ``sample0``: one
    int64 each on the device (the renderer's input buffers); ``base``:
    an (N,) int64 stream base (a PixelSampler's) in their place, or None.
    Returns (the next wave: ``state`` with its fields replaced and the
    live count added to its counters at 4 + bounce; with ``use_nee`` the
    shadow tuple (org, dir, tmax, contrib, want), else None). With an
    instance table the two-level instantiation shades the wave from the
    hit's instance (launch key ``shade_tl``), else the flat one
    (``shade``)."""
    dev = state.org.device
    if dev.type != "cuda":
        raise ValueError(f"shade_cuda needs CUDA tensors, got {dev}")
    n = state.org.shape[0]
    f32, i64 = torch.float32, torch.int64
    c = lambda t: t.contiguous()
    org, dirn, rad, thr = (c(t) for t in (state.org, state.dirn,
                                          state.radiance, state.throughput))
    t, u, v = c(hit.t), c(hit.u), c(hit.v)
    slot = c(hit.slot.to(torch.int32))
    for name, x in (("org", org), ("dirn", dirn), ("radiance", rad),
                    ("throughput", thr)):
        _check(name, x, f32, (n, 3), dev)
    for name, x in (("t", t), ("u", u), ("v", v)):
        _check(name, x, f32, (n,), dev)
    for name, x in (("alive", state.alive), ("allow_emission",
                                             state.allow_emission),
                    ("valid", hit.valid)):
        _check(name, x, torch.bool, (n,), dev)
    _check("pix", state.pix, i64, (n,), dev)
    _check("sample", state.sample, i64, (n,), dev)
    _check("seed", seed, i64, (), dev)
    _check("sample0", sample0, i64, (), dev)
    if base is not None:
        _check("base", base, i64, (n,), dev)
    n_slots = tables.shade_rows.shape[0]
    _check("shade_rows", tables.shade_rows, f32, (n_slots, 32), dev)
    _check("lights", tables.lights, f32,
           (tables.lights.shape[0], LIGHT_LANES), dev)
    if tables.num_lights > tables.lights.shape[0]:
        raise ValueError(f"{tables.num_lights} lights, "
                         f"{tables.lights.shape[0]} light rows")
    n_tex = 0
    if tables.tex_data is not None:
        n_tex = tables.tex_meta.shape[0]
        _check("tex_data", tables.tex_data, f32,
               (tables.tex_data.shape[0], 3), dev)
        _check("tex_meta", tables.tex_meta, f32, (n_tex, 4), dev)
    key, inst, n_inst = "shade", None, 0
    if tables.inst_table is not None:
        key, inst = "shade_tl", c(hit.inst.to(torch.int32))
        n_inst = tables.inst_table.shape[0]
        _check("inst", inst, torch.int32, (n,), dev)
        _check("inst_table", tables.inst_table, f32, (n_inst, 24), dev)
    for name, x in (("shade_rows", tables.shade_rows),
                    ("lights", tables.lights), ("tex_meta", tables.tex_meta),
                    ("inst_table", tables.inst_table)):
        if x is not None and x.data_ptr() % 16:  # read as float4 rows
            raise ValueError(f"{name}: not 16-byte aligned")
    rays = state.rays.clone()
    _check("rays", rays, torch.float64, (rays.shape[0],), dev)
    if not 4 + bounce < rays.shape[0]:
        raise ValueError(f"no counter slot for bounce {bounce}")

    empty3 = lambda: torch.empty((n, 3), dtype=f32, device=dev)
    flag = lambda: torch.empty(n, dtype=torch.bool, device=dev)
    out = (empty3(), empty3(), empty3(), empty3(), flag(), flag())
    shadow = ((empty3(), empty3(), torch.empty(n, dtype=f32, device=dev),
               empty3(), flag()) if use_nee else None)
    ptr = lambda x: None if x is None else x.data_ptr()
    kernels.launch(
        key, dev,
        *(x.data_ptr() for x in (org, dirn, rad, thr, state.alive,
                                 state.allow_emission, state.pix,
                                 state.sample, t, u, v, slot, hit.valid,
                                 tables.shade_rows)),
        n_slots, tables.lights.data_ptr(), tables.num_lights,
        ptr(tables.tex_data), ptr(tables.tex_meta), n_tex,
        *tables.background, seed.data_ptr(), sample0.data_ptr(), ptr(base),
        bounce, int(bounce >= max_bounces), int(use_nee), EPS_RAY,
        1.0 - shadow_eps, n, *(x.data_ptr() for x in out),
        *(ptr(x) for x in (shadow or (None,) * 5)),
        rays[4 + bounce:].data_ptr(), ptr(inst), ptr(tables.inst_table),
        n_inst, work=n > 0)
    org, dirn, rad, thr, alive, allow = out
    return state._replace(org=org, dirn=dirn, radiance=rad, throughput=thr,
                          alive=alive, allow_emission=allow,
                          rays=rays), shadow
