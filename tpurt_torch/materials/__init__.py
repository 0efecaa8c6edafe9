"""Material shading — port of ``tpurt.materials`` (packed flat path).

Every material family's response is computed densely for every hit and
selected by material kind. Families (``scene.types``): LAMBERT,
BLINN_PHONG (param0 = shininess, param1 = specular strength), MIRROR
(param0 = fuzz), DIELECTRIC (param0 = ior); any material may add
``emission``.

Hit attributes come from the baked world-space shade records of the flat
pair-cluster accel (one row gather per hit). Base-color textures, alpha
cutout and the two-level record path are not ported yet (ROADMAP §1
items 10 and 11).
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


def resolve_hit_packed(shade_rows, org, dirn, t, u, v, slot) -> HitAttrs:
    """Hit attributes from ONE row gather of the world-space shade table
    (``PairAccel.shade_rows``, layout in ``bvh.paircluster``)."""
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
    return HitAttrs(
        pos=pos,
        n_geom=n_geom,
        n_shade=n_shade,
        front_face=front_face,
        mat_id=rec[:, 21].to(torch.int32),
        kind=rec[:, 12].to(torch.int32),
        albedo=rec[:, 13:16],
        emission=rec[:, 16:19],
        param0=rec[:, 19],
        param1=rec[:, 20],
    )


def make_resolver(ds, accel):
    """The hit-attribute resolver for a flat pair-cluster accel."""
    shade_rows = getattr(accel, "shade_rows", None)
    if shade_rows is None or getattr(accel, "inst_table", None) is not None:
        raise NotImplementedError(
            "only the flat packed shade-record resolver is ported "
            "(ROADMAP §1 item 10: two-level records)")
    if ds.tex_data.shape[0] > 1:
        raise NotImplementedError(
            "base-color textures are not ported yet (ROADMAP §1 item 11)")

    def resolve(org, dirn, t, u, v, tri, inst, slot) -> HitAttrs:
        del tri, inst
        return resolve_hit_packed(shade_rows, org, dirn, t, u, v, slot)

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
