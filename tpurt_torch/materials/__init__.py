"""Material shading — port of ``tpurt.materials`` (packed flat path).

Every material family's response is computed densely for every hit and
selected by material kind. Families (``scene.types``): LAMBERT,
BLINN_PHONG (param0 = shininess, param1 = specular strength), MIRROR
(param0 = fuzz), DIELECTRIC (param0 = ior); any material may add
``emission``.

Hit attributes come from the baked shade records of the pair-cluster
accel (one row gather per hit): world-space records for the flat accel,
object-space records plus a per-instance table for the two-level accel.
The packet BVH has no records: its hits resolve per field from the
DeviceScene (``resolve_hit``). Base-color textures multiply the albedo
(``sample_base_color``: nearest or bilinear, REPEAT wrap, the white
fallback texel at pool row 0); ``sample_alpha`` is the alpha-cutout probe
of ``render.integrator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tpurt_torch.core import prng, sampling
from tpurt_torch.core.vecmath import (
    EPS_RAY,
    build_onb,
    cross,
    dot,
    normalize,
    reflect,
    refract,
    schlick_fresnel,
)
from tpurt_torch.scene.types import BLINN_PHONG, DIELECTRIC, LAMBERT, MIRROR


class HitAttrs(NamedTuple):
    """Resolved per-hit surface attributes (all world space)."""

    pos: torch.Tensor  # (N, 3) hit position
    n_geom: torch.Tensor  # (N, 3) geometric normal, flipped to face the ray
    n_shade: torch.Tensor  # (N, 3) shading normal, same side as n_geom
    front_face: torch.Tensor  # (N,) bool — ray hit the winding-front side
    mat_id: torch.Tensor  # (N,) i32
    kind: torch.Tensor  # (N,) i32
    albedo: torch.Tensor  # (N, 3)
    emission: torch.Tensor  # (N, 3)
    param0: torch.Tensor  # (N,)
    param1: torch.Tensor  # (N,)


def _where3(mask, a, b):
    return torch.where(mask[:, None], a, b)


def _texel_frame(tex_meta, tex_id, tu, tv):
    """Pool row offset, size (f32 and i32) and the wrapped UV of each
    lookup; ``tex_id`` < 0 reads texture 0's meta (the caller then reads
    pool row 0)."""
    tid = torch.clamp(tex_id, 0, tex_meta.shape[0] - 1).long()
    meta = tex_meta[tid]  # (N, 4)
    off = meta[:, 0].to(torch.int32)
    w = torch.clamp_min(meta[:, 1], 1.0)
    h = torch.clamp_min(meta[:, 2], 1.0)
    return (off, w, h, w.to(torch.int32), h.to(torch.int32),
            tu - torch.floor(tu), tv - torch.floor(tv))


def _nearest_index(tex_meta, tex_id, tu, tv):
    off, w, h, wi, hi, fu, fv = _texel_frame(tex_meta, tex_id, tu, tv)
    tx = torch.minimum((fu * w).to(torch.int32), wi - 1)
    ty = torch.minimum((fv * h).to(torch.int32), hi - 1)
    idx = torch.where(tex_id >= 0, off + ty * wi + tx, 0)
    return idx.long()


def sample_base_color(tex_data, tex_meta, tex_id, tu, tv,
                      bilinear: bool = False):
    """Base-color fetch from the flattened texture pool.

    ``tex_id`` < 0 (untextured) reads pool row 0, the white fallback, so
    textured and untextured hits shade together. REPEAT wrapping; glTF's
    v-down convention (image row 0 is v = 0). Nearest is one row gather;
    ``bilinear`` (glTF's LINEAR) averages the four texels around the
    sample point at half-texel-centered coordinates."""
    if not bilinear:
        return tex_data[_nearest_index(tex_meta, tex_id, tu, tv)]
    off, w, h, wi, hi, fu, fv = _texel_frame(tex_meta, tex_id, tu, tv)
    # texel centers at (i + 0.5) / w: the sample point in texel units
    px = fu * w - 0.5
    py = fv * h - 0.5
    x0f = torch.floor(px)
    y0f = torch.floor(py)
    ax = (px - x0f)[:, None]
    ay = (py - y0f)[:, None]

    def fetch(xf, yf):
        # REPEAT wrap per axis (once is enough: xf lies in [-1, w])
        x = torch.where(xf < 0, xf + w, torch.where(xf >= w, xf - w, xf))
        y = torch.where(yf < 0, yf + h, torch.where(yf >= h, yf - h, yf))
        x = torch.minimum(torch.clamp_min(x.to(torch.int32), 0), wi - 1)
        y = torch.minimum(torch.clamp_min(y.to(torch.int32), 0), hi - 1)
        idx = torch.where(tex_id >= 0, off + y * wi + x, 0)
        return tex_data[idx.long()]

    c00 = fetch(x0f, y0f)
    c10 = fetch(x0f + 1.0, y0f)
    c01 = fetch(x0f, y0f + 1.0)
    c11 = fetch(x0f + 1.0, y0f + 1.0)
    top = c00 * (1.0 - ax) + c10 * ax
    bot = c01 * (1.0 - ax) + c11 * ax
    return top * (1.0 - ay) + bot * ay


def sample_alpha(tex_alpha, tex_meta, tex_id, tu, tv):
    """Base-color alpha (nearest) from the pool's alpha channel: the
    alpha-cutout probe, one (N,) gather. ``tex_id`` < 0 reads row 0
    (opaque 1.0)."""
    return tex_alpha[_nearest_index(tex_meta, tex_id, tu, tv)]


def _interp_uv(rec, w, u, v):
    """Corner UVs of shade-record columns 22:28 interpolated at the hit."""
    return (w[:, None] * rec[:, 22:24] + u[:, None] * rec[:, 24:26]
            + v[:, None] * rec[:, 26:28])


def resolve_hit_packed(shade_rows, org, dirn, t, u, v, slot, tex_data=None,
                       tex_meta=None, bilinear: bool = False) -> HitAttrs:
    """Hit attributes from ONE row gather of the world-space shade table
    (``PairAccel.shade_rows``, layout in ``bvh.paircluster``); a textured
    pool (``tex_data``) multiplies the albedo by the base color at the
    record's UVs (columns 22:28) and texture id (column 28)."""
    rec = shade_rows[torch.clamp_min(slot, 0).long()]  # (N, SHADE_LANES)
    w = 1.0 - u - v
    n_geom = normalize(rec[:, 0:3])
    ns = (w[:, None] * rec[:, 3:6] + u[:, None] * rec[:, 6:9]
          + v[:, None] * rec[:, 9:12])
    n_shade = normalize(ns)
    pos = org + t[:, None] * dirn
    front_face = dot(n_geom, dirn) < 0.0
    n_geom = _where3(front_face, n_geom, -n_geom)
    n_shade = _where3(dot(n_shade, n_geom) >= 0.0, n_shade, -n_shade)
    albedo = rec[:, 13:16]
    if tex_data is not None:
        uvi = _interp_uv(rec, w, u, v)
        albedo = albedo * sample_base_color(
            tex_data, tex_meta, rec[:, 28].to(torch.int32), uvi[:, 0],
            uvi[:, 1], bilinear=bilinear)
    return HitAttrs(
        pos=pos,
        n_geom=n_geom,
        n_shade=n_shade,
        front_face=front_face,
        mat_id=rec[:, 21].to(torch.int32),
        kind=rec[:, 12].to(torch.int32),
        albedo=albedo,
        emission=rec[:, 16:19],
        param0=rec[:, 19],
        param1=rec[:, 20],
    )


def _mat3_vec(m, x):
    """(N, 3, 3) · (N, 3), summed left to right."""
    return (m[:, :, 0] * x[:, 0:1] + m[:, :, 1] * x[:, 1:2]
            + m[:, :, 2] * x[:, 2:3])


def resolve_hit_packed_tl(shade_rows, inst_table, org, dirn, t, u, v, slot,
                          inst, tex_data=None, tex_meta=None,
                          bilinear: bool = False) -> HitAttrs:
    """Two-level twin of resolve_hit_packed (PairAccelTL): the shade
    record is object space and shared across instances; the hit's
    instance selects a normal matrix and an optional material override
    from the (I, 24) instance table (one row gather per hit). A material
    override carries no texture, so an overridden hit shades untextured."""
    rec = shade_rows[torch.clamp_min(slot, 0).long()]  # (N, SHADE_LANES)
    i_c = torch.clamp(inst, 0, inst_table.shape[0] - 1).long()
    feats = inst_table[i_c]  # (N, 24)
    nm = feats[:, 0:9].reshape(-1, 3, 3)
    det_sign = feats[:, 9:10]
    w = 1.0 - u - v
    n_geom = normalize(_mat3_vec(nm, rec[:, 0:3]) * det_sign)
    ns_obj = (w[:, None] * rec[:, 3:6] + u[:, None] * rec[:, 6:9]
              + v[:, None] * rec[:, 9:12])
    n_shade = normalize(_mat3_vec(nm, ns_obj))
    pos = org + t[:, None] * dirn
    front_face = dot(n_geom, dirn) < 0.0
    n_geom = _where3(front_face, n_geom, -n_geom)
    n_shade = _where3(dot(n_shade, n_geom) >= 0.0, n_shade, -n_shade)
    over = feats[:, 10:11] > 0.5
    sel = lambda a, b: torch.where(over, a, b)
    albedo = sel(feats[:, 12:15], rec[:, 13:16])
    if tex_data is not None:
        uvi = _interp_uv(rec, w, u, v)
        tex_id = torch.where(over[:, 0], -1, rec[:, 28].to(torch.int32))
        albedo = albedo * sample_base_color(
            tex_data, tex_meta, tex_id, uvi[:, 0], uvi[:, 1],
            bilinear=bilinear)
    return HitAttrs(
        pos=pos,
        n_geom=n_geom,
        n_shade=n_shade,
        front_face=front_face,
        mat_id=sel(feats[:, 20:21], rec[:, 21:22])[:, 0].to(torch.int32),
        kind=sel(feats[:, 11:12], rec[:, 12:13])[:, 0].to(torch.int32),
        albedo=albedo,
        emission=sel(feats[:, 15:18], rec[:, 16:19]),
        param0=sel(feats[:, 18:19], rec[:, 19:20])[:, 0],
        param1=sel(feats[:, 19:20], rec[:, 20:21])[:, 0],
    )


def resolve_hit(ds, org, dirn, t, u, v, tri, inst,
                bilinear: bool = False) -> HitAttrs:
    """Per-field resolver for accels without shade records (the packet
    BVH): gathers the triangle, its instance's normal matrix and
    material override from the DeviceScene, and samples the base color
    where the scene has textures. Misses may pass any (clamped) ids;
    callers gate on the hit mask."""
    tri = torch.clamp(tri, 0, ds.tri_v0.shape[0] - 1).long()
    inst = torch.clamp(inst, 0, ds.inst_mesh.shape[0] - 1).long()
    w = 1.0 - u - v
    v0, v1, v2 = ds.tri_v0[tri], ds.tri_v1[tri], ds.tri_v2[tri]
    n_obj = cross(v1 - v0, v2 - v0)
    nrm_mat = ds.inst_nrm[inst]  # (N, 3, 3)
    n_geom = normalize(_mat3_vec(nrm_mat, n_obj))
    ns_obj = (w[:, None] * ds.tri_n0[tri] + u[:, None] * ds.tri_n1[tri]
              + v[:, None] * ds.tri_n2[tri])
    n_shade = normalize(_mat3_vec(nrm_mat, ns_obj))
    pos = org + t[:, None] * dirn
    front_face = dot(n_geom, dirn) < 0.0
    n_geom = _where3(front_face, n_geom, -n_geom)
    n_shade = _where3(dot(n_shade, n_geom) >= 0.0, n_shade, -n_shade)
    override = ds.inst_mat_override[inst]
    mat_id = torch.where(override >= 0, override, ds.tri_mat[tri])
    mat_id = torch.clamp(mat_id, 0, ds.mat_kind.shape[0] - 1)
    m = mat_id.long()
    albedo = ds.mat_albedo[m]
    if ds.tex_data.shape[0] > 1:  # only the white fallback: no gather
        uv = (w[:, None] * ds.tri_uv0[tri] + u[:, None] * ds.tri_uv1[tri]
              + v[:, None] * ds.tri_uv2[tri])
        albedo = albedo * sample_base_color(
            ds.tex_data, ds.tex_meta, ds.mat_texture[m], uv[:, 0], uv[:, 1],
            bilinear=bilinear)
    return HitAttrs(
        pos=pos,
        n_geom=n_geom,
        n_shade=n_shade,
        front_face=front_face,
        mat_id=mat_id,
        kind=ds.mat_kind[m],
        albedo=albedo,
        emission=ds.mat_emission[m],
        param0=ds.mat_param0[m],
        param1=ds.mat_param1[m],
    )


def make_resolver(ds, accel, texture_filter: str = "nearest"):
    """The hit-attribute resolver for an accel: the two-level path
    (object-space records + instance table) for a PairAccelTL, the
    world-space record path for a PairAccel, and the per-field path for
    an accel without shade records (PacketAccel). ``texture_filter``:
    "nearest" (one row gather a hit) or "bilinear" (glTF's LINEAR, four).
    A scene without textures holds only the white fallback texel and
    skips the texel gather."""
    shade_rows = getattr(accel, "shade_rows", None)
    inst_table = getattr(accel, "inst_table", None)
    textured = ds.tex_data.shape[0] > 1
    tex_data = ds.tex_data if textured else None
    tex_meta = ds.tex_meta if textured else None
    bilinear = texture_filter == "bilinear"

    if shade_rows is not None and inst_table is not None:
        def resolve(org, dirn, t, u, v, tri, inst, slot) -> HitAttrs:
            del tri
            return resolve_hit_packed_tl(
                shade_rows, inst_table, org, dirn, t, u, v, slot, inst,
                tex_data=tex_data, tex_meta=tex_meta, bilinear=bilinear)
    elif shade_rows is not None:
        def resolve(org, dirn, t, u, v, tri, inst, slot) -> HitAttrs:
            del tri, inst
            return resolve_hit_packed(
                shade_rows, org, dirn, t, u, v, slot, tex_data=tex_data,
                tex_meta=tex_meta, bilinear=bilinear)
    else:
        def resolve(org, dirn, t, u, v, tri, inst, slot) -> HitAttrs:
            del slot
            return resolve_hit(ds, org, dirn, t, u, v, tri, inst,
                               bilinear=bilinear)

    return resolve


def eval_brdf(attrs: HitAttrs, wo: torch.Tensor,
              wi: torch.Tensor) -> torch.Tensor:
    """Evaluate the non-delta BRDF families for (wo, wi); wo points toward
    the viewer, wi toward the light. Delta families evaluate to 0."""
    n = attrs.n_shade
    diffuse = attrs.albedo / math.pi
    h = normalize(wo + wi)
    shin = torch.clamp_min(attrs.param0, 1.0)
    spec_norm = (shin + 2.0) / (2.0 * math.pi)
    ndh = torch.clamp_min(dot(n, h), 0.0)
    spec = (attrs.param1 * spec_norm * ndh ** shin)[:, None]
    kind = attrs.kind
    brdf = _where3(kind == LAMBERT, diffuse,
                   _where3(kind == BLINN_PHONG, diffuse + spec,
                           torch.zeros_like(diffuse)))
    above = (dot(n, wi) > 0.0) & (dot(n, wo) > 0.0)
    return _where3(above, brdf, torch.zeros_like(brdf))


class BounceSample(NamedTuple):
    wi: torch.Tensor  # (N, 3) sampled next direction
    weight: torch.Tensor  # (N, 3) throughput multiplier (brdf·cos/pdf)
    is_specular: torch.Tensor  # (N,) bool — delta bounce (NEE skips these)
    offset_sign: torch.Tensor  # (N,) +1 reflect side / -1 transmit side


def sample_bounce(attrs: HitAttrs, wo: torch.Tensor, sampler,
                  bounce: int) -> BounceSample:
    """Sample the next bounce for every material family densely, then
    select by kind. ``sampler``: a PixelSampler; ``bounce`` indexes the
    static draw-site tags."""
    n = attrs.n_shade
    d_in = -wo
    u_diff = sampler.u2(prng.bounce_tag(bounce, prng.SITE_DIFFUSE))
    u_sphere = sampler.u2(prng.bounce_tag(bounce, prng.SITE_SPHERE))
    u_fres = sampler.u01(prng.bounce_tag(bounce, prng.SITE_FRESNEL))

    # diffuse family: cosine hemisphere about the shading normal
    t, b = build_onb(n)
    d_local, pdf = sampling.cosine_hemisphere(u_diff)
    wi_diffuse = sampling.to_world(d_local, t, b, n)
    brdf = eval_brdf(attrs, wo, wi_diffuse)
    cos_i = torch.clamp_min(dot(n, wi_diffuse), 0.0)
    w_diffuse = brdf * (cos_i / torch.clamp_min(pdf, 1e-8))[:, None]

    # mirror with fuzz = param0 (0 ⇒ perfect mirror, >0 ⇒ glossy)
    refl = normalize(reflect(d_in, n))
    fuzz = attrs.param0[:, None]
    wi_mirror = normalize(refl + fuzz * sampling.uniform_sphere(u_sphere))
    mirror_ok = dot(wi_mirror, attrs.n_geom) > 0.0
    w_mirror = attrs.albedo * mirror_ok[:, None]

    # dielectric (ior = param0); normals face the ray, so the side bit
    # picks the index ratio
    ior = torch.clamp_min(attrs.param0, 1.0001)
    eta = torch.where(attrs.front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp(-dot(d_in, n), 0.0, 1.0)
    wi_refr, tir = refract(d_in, n, eta)
    fresnel = schlick_fresnel(cos_theta, torch.ones_like(ior), 1.0 / eta)
    reflect_choice = tir | (u_fres < fresnel)
    wi_diel = _where3(reflect_choice, refl, wi_refr)
    w_diel = attrs.albedo  # choice-by-Fresnel ⇒ weight cancels the pdf
    diel_sign = torch.where(reflect_choice, 1.0, -1.0)

    is_mirror = attrs.kind == MIRROR
    is_diel = attrs.kind == DIELECTRIC
    wi = _where3(is_mirror, wi_mirror, _where3(is_diel, wi_diel, wi_diffuse))
    weight = _where3(is_mirror, w_mirror,
                     _where3(is_diel, w_diel, w_diffuse))
    return BounceSample(
        wi=wi, weight=weight, is_specular=is_mirror | is_diel,
        offset_sign=torch.where(is_diel, diel_sign, 1.0))


def bounce_origin(attrs: HitAttrs, offset_sign) -> torch.Tensor:
    """Offset the next-ray origin off the surface (self-intersection
    guard), scale-aware so the offset survives f32 cancellation."""
    eps = EPS_RAY * torch.clamp_min(attrs.pos.abs().amax(dim=-1), 1.0)
    return attrs.pos + (offset_sign * eps)[:, None] * attrs.n_geom


def sample_light(ds, pos: torch.Tensor, sampler, bounce: int):
    """Next-event estimation: sample one point on one emissive triangle.

    Returns (wi, dist, radiance_over_pdf, valid); ``radiance_over_pdf``
    folds emission · G / pdf, so the caller multiplies by BRDF · cos and
    the shadow-ray visibility."""
    n_lights = torch.clamp_min(ds.num_lights, 1)
    u_pick = sampler.u01(prng.bounce_tag(bounce, prng.SITE_LIGHT_PICK))
    pick = torch.minimum((u_pick * n_lights).to(torch.int32), n_lights - 1)
    u = sampler.u2(prng.bounce_tag(bounce, prng.SITE_LIGHT_BARY))
    # uniform barycentric via the sqrt trick
    su = torch.sqrt(u[:, 0])
    b0 = 1.0 - su
    b1 = u[:, 1] * su
    b2 = 1.0 - b0 - b1
    pick = pick.long()
    lv0, lv1, lv2 = ds.light_v0[pick], ds.light_v1[pick], ds.light_v2[pick]
    lp = b0[:, None] * lv0 + b1[:, None] * lv1 + b2[:, None] * lv2
    ln = normalize(cross(lv1 - lv0, lv2 - lv0))

    to_light = lp - pos
    dist2 = torch.clamp_min(dot(to_light, to_light), 1e-12)
    dist = torch.sqrt(dist2)
    wi = to_light / dist[:, None]

    cos_light = torch.abs(dot(ln, wi))  # lights emit from both faces
    area = ds.light_area[pick]
    emission = ds.light_emission[pick]
    # pdf over area → solid angle: dist² / (cos_light · area · n_lights)
    g = cos_light * area * n_lights.to(torch.float32) / dist2
    radiance_over_pdf = emission * g[:, None]
    valid = (ds.num_lights > 0) & (area > 0.0) & (cos_light > 1e-6)
    return wi, dist, radiance_over_pdf, valid
