"""Plain reference renderer of the benchmark.

The estimator is the renderer's published one: per pixel sample, a camera
ray jittered inside the pixel, up to ``max_bounces`` bounces with next-event
estimation (one point on one uniformly picked emissive triangle a vertex,
its shadow ray stopping 0.1% short), emission counted on camera rays and
after specular bounces, Lambert, Blinn-Phong, mirror and dielectric lobes,
and paths cut where their throughput falls under 1e-6. Every random number
is a counter-based hash (lowbias32) of (seed, sample index, pixel id,
draw-site tag), so a pixel's samples can be recomputed alone.

The intersection is brute force: every ray against every world-space
triangle (instances flattened). A dense pass writes the Möller–Trumbore
determinant and numerators of every (ray, triangle) pair as one matrix
product, keeps the pairs within a margin of the triangle, and the exact
Möller–Trumbore test decides those. ``dtype`` sets the float precision of
everything but the random bits (the control runs it in bfloat16).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.scenedata import BLINN_PHONG, DIELECTRIC, LAMBERT, MIRROR

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
EPS_RAY = 1e-4  # bounce-origin offset, relative to the hit's magnitude
SHADOW_EPS = 1e-3  # shadow rays stop this share short of the light point
CUTOFF = 1e-6  # a path whose throughput falls under this ends
MARGIN = 0.05  # candidate margin of the dense pass, in barycentric units
PAIR_BUDGET = 1 << 25  # (ray, triangle) pairs a dense pass holds at once

# draw-site tags: the jitter uses 0-1; bounce b uses 8 + 8 b + site
TAG_JITTER = 0
SITE_LIGHT_PICK, SITE_LIGHT_BARY, SITE_DIFFUSE, SITE_SPHERE, SITE_FRESNEL = \
    0, 1, 3, 5, 7


def _tag(bounce: int, site: int) -> int:
    return 8 + 8 * bounce + site


# ---------------------------------------------------------------------------
# random numbers: uint32 lanes in int64
# ---------------------------------------------------------------------------


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32): the 32-bit product taken as
    two 16-bit halves of x so no int64 product overflows."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def lowbias32(x):
    x = x & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class Stream:
    """The per-(seed, sample, pixel) random stream."""

    def __init__(self, seed: int, sample, pixel, dtype):
        s = lowbias32(torch.full_like(pixel, int(seed) & M32))
        s = lowbias32(s + sample)
        self.base = lowbias32(s + _mul32(pixel & M32, GOLDEN))
        self.dtype = dtype

    def u(self, tag: int):
        bits = lowbias32(self.base + ((tag * GOLDEN) & M32))
        return ((bits >> 8).to(torch.float32) / 16777216.0).to(self.dtype)


# ---------------------------------------------------------------------------
# vector helpers over (..., 3)
# ---------------------------------------------------------------------------


def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    return v / torch.sqrt(torch.clamp_min(dot(v, v), 1e-20))[..., None]


def _sel(mask, a, b):
    return torch.where(mask[..., None], a, b)


# ---------------------------------------------------------------------------
# the scene, flattened to world space
# ---------------------------------------------------------------------------


class WorldScene:
    """Every instance's triangles in world space, with their world shading
    normals at the corners, material records and the area lights."""

    def __init__(self, scene, device, dtype=torch.float32):
        v0, v1, v2, n0, n1, n2, mid = ([] for _ in range(7))
        lv0, lv1, lv2, lem = [], [], [], []
        for inst in scene.instances:
            m = scene.meshes[inst.mesh_id]
            xf = np.asarray(inst.transform, np.float32)
            rot, off = xf[:, :3], xf[:, 3]
            nrm = np.linalg.inv(rot).T.astype(np.float32)
            world = m.vertices @ rot.T + off
            wn = m.normals @ nrm.T
            tri = m.indices
            for out, arr in ((v0, world[tri[:, 0]]), (v1, world[tri[:, 1]]),
                             (v2, world[tri[:, 2]]), (n0, wn[tri[:, 0]]),
                             (n1, wn[tri[:, 1]]), (n2, wn[tri[:, 2]])):
                out.append(arr)
            mid.append(m.material_ids)
            emissive = np.array([any(e > 0 for e in
                                     scene.materials[k].emission)
                                 for k in m.material_ids], bool)
            if emissive.any():
                t = tri[emissive]
                lv0.append(world[t[:, 0]])
                lv1.append(world[t[:, 1]])
                lv2.append(world[t[:, 2]])
                lem.append(np.asarray([scene.materials[k].emission for k in
                                       m.material_ids[emissive]], np.float32))
        f = lambda xs: torch.as_tensor(
            np.concatenate(xs).astype(np.float32), device=device).to(dtype)
        self.dtype = dtype
        self.v0, self.v1, self.v2 = f(v0), f(v1), f(v2)
        self.n0, self.n1, self.n2 = f(n0), f(n1), f(n2)
        self.mat = torch.as_tensor(np.concatenate(mid).astype(np.int64),
                                   device=device)
        mats = scene.materials
        self.kind = torch.as_tensor([m.kind for m in mats], device=device)
        self.albedo = torch.as_tensor([m.albedo for m in mats],
                                      dtype=torch.float32, device=device
                                      ).to(dtype)
        self.emission = torch.as_tensor([m.emission for m in mats],
                                        dtype=torch.float32, device=device
                                        ).to(dtype)
        self.param0 = torch.as_tensor([m.param0 for m in mats],
                                      dtype=torch.float32, device=device
                                      ).to(dtype)
        self.param1 = torch.as_tensor([m.param1 for m in mats],
                                      dtype=torch.float32, device=device
                                      ).to(dtype)
        self.background = torch.as_tensor(scene.background,
                                          dtype=torch.float32,
                                          device=device).to(dtype)
        self.lv0, self.lv1, self.lv2 = f(lv0), f(lv1), f(lv2)
        self.l_emission = f(lem)
        self.l_area = 0.5 * torch.linalg.vector_norm(
            cross(self.lv1 - self.lv0, self.lv2 - self.lv0), dim=-1)
        self.n_lights = self.lv0.shape[0]
        # the dense pass's constants: with e1, e2 the edges and N = e1 x e2,
        # det = -d.N, u_num = d.(v0 x e2) - (d x o).e2,
        # v_num = (d x o).e1 - d.(v0 x e1), t_num = o.N - v0.N
        e1, e2 = self.v1 - self.v0, self.v2 - self.v0
        nrm = cross(e1, e2)
        a, b = cross(self.v0, e2), cross(self.v0, e1)
        zero = torch.zeros_like(nrm)
        # rows: d (3), d x o (3), o (3); column blocks: det, u, v, t
        self.dense = torch.cat([
            torch.cat([-nrm, a, -b, zero], 0).T,
            torch.cat([zero, -e2, e1, zero], 0).T,
            torch.cat([zero, zero, zero, nrm], 0).T], 0).contiguous()
        self.plane = dot(self.v0, nrm)
        lo = torch.minimum(torch.minimum(self.v0, self.v1), self.v2)
        hi = torch.maximum(torch.maximum(self.v0, self.v1), self.v2)
        self.diag = float(torch.linalg.vector_norm(
            hi.amax(0).float() - lo.amin(0).float()))
        self.n_tri = self.v0.shape[0]

    # --- intersection -------------------------------------------------------

    def _pairs(self, org, dirn, tmax):
        """Candidate (ray, triangle) pairs of the dense pass."""
        n_tri = self.n_tri
        chunk = max(1, PAIR_BUDGET // n_tri)
        none = torch.zeros(0, dtype=torch.int64, device=org.device)
        rays, tris = [none], [none]
        slack = 1e-3 * self.diag
        for s in range(0, org.shape[0], chunk):
            o, d, tm = org[s:s + chunk], dirn[s:s + chunk], tmax[s:s + chunk]
            x = torch.cat([d, cross(d, o), o], 1)
            out = (x @ self.dense).view(x.shape[0], 4, n_tri)
            det, un, vn, tn = out.unbind(1)
            tn = tn - self.plane
            sgn = torch.where(det < 0, -1.0, 1.0).to(det.dtype)
            ad = det.abs()
            un, vn, tn = un * sgn, vn * sgn, tn * sgn
            lim = MARGIN * ad
            keep = ((ad > 0) & (un >= -lim) & (vn >= -lim)
                    & (un + vn <= ad + lim) & (tn >= -slack * ad)
                    & (tn <= (tm[:, None] * (1 + MARGIN) + slack) * ad))
            r, t = keep.nonzero(as_tuple=True)
            rays.append(r + s)
            tris.append(t)
        return torch.cat(rays), torch.cat(tris)

    def _exact(self, org, dirn, tmax, r, t):
        """Möller–Trumbore, double-sided, on the pairs (r, t)."""
        o, d = org[r], dirn[r]
        v0 = self.v0[t]
        e1, e2 = self.v1[t] - v0, self.v2[t] - v0
        pvec = cross(d, e2)
        det = dot(e1, pvec)
        ok = det.abs() > 1e-9
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        tvec = o - v0
        u = dot(tvec, pvec) * inv
        qvec = cross(tvec, e1)
        v = dot(d, qvec) * inv
        tt = dot(e2, qvec) * inv
        hit = (ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt > 0)
               & (tt < tmax[r]))
        return tt, u, v, hit

    def closest(self, org, dirn):
        """(t, u, v, triangle, hit) of each ray's closest hit (ties: the
        lower triangle index)."""
        n = org.shape[0]
        tmax = torch.full((n,), math.inf, dtype=org.dtype, device=org.device)
        r, t = self._pairs(org, dirn, tmax)
        tt, u, v, hit = self._exact(org, dirn, tmax, r, t)
        r, t, tt, u, v = r[hit], t[hit], tt[hit], u[hit], v[hit]
        best = torch.full((n,), math.inf, dtype=org.dtype, device=org.device)
        best = best.scatter_reduce(0, r, tt, "amin")
        at_best = tt == best[r]
        big = torch.full((n,), self.n_tri, dtype=torch.int64,
                         device=org.device)
        tri = big.scatter_reduce(0, r[at_best], t[at_best], "amin")
        pick = at_best & (t == tri[r])
        out_u = torch.zeros(n, dtype=org.dtype, device=org.device)
        out_v = torch.zeros_like(out_u)
        out_u[r[pick]] = u[pick]
        out_v[r[pick]] = v[pick]
        ok = tri < self.n_tri
        return best, out_u, out_v, torch.where(ok, tri, 0), ok

    def occluded(self, org, dirn, tmax):
        r, t = self._pairs(org, dirn, tmax)
        _, _, _, hit = self._exact(org, dirn, tmax, r, t)
        occ = torch.zeros(org.shape[0], dtype=torch.bool, device=org.device)
        occ[r[hit]] = True
        return occ


# ---------------------------------------------------------------------------
# shading
# ---------------------------------------------------------------------------


class Surface:
    """Hit attributes (world space) of hits on triangles ``tri``."""

    def __init__(self, ws: WorldScene, org, dirn, t, u, v, tri):
        w = 1.0 - u - v
        n_geom = normalize(cross(ws.v1[tri] - ws.v0[tri],
                                 ws.v2[tri] - ws.v0[tri]))
        n_shade = normalize(w[:, None] * ws.n0[tri] + u[:, None] * ws.n1[tri]
                            + v[:, None] * ws.n2[tri])
        self.pos = org + t[:, None] * dirn
        self.front = dot(n_geom, dirn) < 0
        self.n_geom = _sel(self.front, n_geom, -n_geom)
        self.n = _sel(dot(n_shade, self.n_geom) >= 0, n_shade, -n_shade)
        m = ws.mat[tri]
        self.kind = ws.kind[m]
        self.albedo = ws.albedo[m]
        self.emission = ws.emission[m]
        self.p0 = ws.param0[m]
        self.p1 = ws.param1[m]

    def offset(self, sign):
        eps = EPS_RAY * torch.clamp_min(self.pos.abs().amax(-1), 1.0)
        return self.pos + (sign * eps)[:, None] * self.n_geom

    def brdf(self, wo, wi):
        """The non-delta lobes (Lambert, Blinn-Phong) for (wo, wi)."""
        n = self.n
        diffuse = self.albedo / math.pi
        h = normalize(wo + wi)
        shin = torch.clamp_min(self.p0, 1.0)
        ndh = torch.clamp_min(dot(n, h), 0.0)
        spec = (self.p1 * (shin + 2.0) / (2.0 * math.pi) * ndh ** shin)
        out = torch.where((self.kind == LAMBERT)[:, None], diffuse,
                          torch.where((self.kind == BLINN_PHONG)[:, None],
                                      diffuse + spec[:, None],
                                      torch.zeros_like(diffuse)))
        above = (dot(n, wi) > 0) & (dot(n, wo) > 0)
        return _sel(above, out, torch.zeros_like(out))


def _onb(n):
    """Orthonormal tangents of unit ``n`` (Duff et al. 2017)."""
    nx, ny, nz = n.unbind(-1)
    sign = torch.where(nz >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return t, bt


def _light(ws: WorldScene, pos, rng: Stream, bounce: int):
    """One point on one uniformly picked light: (wi, dist, L cos / pdf,
    valid)."""
    n_l = ws.n_lights
    pick = torch.clamp_max((rng.u(_tag(bounce, SITE_LIGHT_PICK)) * n_l
                            ).to(torch.int64), n_l - 1)
    su = torch.sqrt(rng.u(_tag(bounce, SITE_LIGHT_BARY)))
    b0 = 1.0 - su
    b1 = rng.u(_tag(bounce, SITE_LIGHT_BARY + 1)) * su
    b2 = 1.0 - b0 - b1
    l0, l1, l2 = ws.lv0[pick], ws.lv1[pick], ws.lv2[pick]
    point = b0[:, None] * l0 + b1[:, None] * l1 + b2[:, None] * l2
    ln = normalize(cross(l1 - l0, l2 - l0))
    to = point - pos
    d2 = torch.clamp_min(dot(to, to), 1e-12)
    dist = torch.sqrt(d2)
    wi = to / dist[:, None]
    cos_l = dot(ln, wi).abs()  # lights emit from both faces
    area = ws.l_area[pick]
    weight = ws.l_emission[pick] * (cos_l * area * n_l / d2)[:, None]
    return wi, dist, weight, (area > 0) & (cos_l > 1e-6)


def _bounce(s: Surface, wo, rng: Stream, bounce: int):
    """Next direction, throughput weight, specular flag, offset side."""
    n = s.n
    d_in = -wo
    # diffuse lobe: cosine-weighted about the shading normal
    u0 = rng.u(_tag(bounce, SITE_DIFFUSE))
    u1 = rng.u(_tag(bounce, SITE_DIFFUSE + 1))
    r = torch.sqrt(u0)
    phi = 2.0 * math.pi * u1
    z = torch.sqrt(torch.clamp_min(1.0 - u0, 0.0))
    t, b = _onb(n)
    wi_d = ((r * torch.cos(phi))[:, None] * t
            + (r * torch.sin(phi))[:, None] * b + z[:, None] * n)
    pdf = z / math.pi
    cos_i = torch.clamp_min(dot(n, wi_d), 0.0)
    w_d = s.brdf(wo, wi_d) * (cos_i / torch.clamp_min(pdf, 1e-8))[:, None]
    # mirror, fuzzed by param0 towards a uniform sphere direction
    refl = normalize(d_in - 2.0 * dot(d_in, n)[:, None] * n)
    zs = 1.0 - 2.0 * rng.u(_tag(bounce, SITE_SPHERE))
    rs = torch.sqrt(torch.clamp_min(1.0 - zs * zs, 0.0))
    ps = 2.0 * math.pi * rng.u(_tag(bounce, SITE_SPHERE + 1))
    sphere = torch.stack([rs * torch.cos(ps), rs * torch.sin(ps), zs], -1)
    wi_m = normalize(refl + s.p0[:, None] * sphere)
    w_m = s.albedo * (dot(wi_m, s.n_geom) > 0)[:, None]
    # dielectric: Fresnel (Schlick) picks reflection or refraction
    ior = torch.clamp_min(s.p0, 1.0001)
    eta = torch.where(s.front, 1.0 / ior, ior)
    cos_t0 = torch.clamp(-dot(d_in, n), 0.0, 1.0)
    cos_in = -dot(d_in, n)
    sin2 = eta * eta * torch.clamp_min(1.0 - cos_in * cos_in, 0.0)
    tir = sin2 > 1.0
    cos_tr = torch.sqrt(torch.clamp_min(1.0 - sin2, 0.0))
    refr = normalize(eta[:, None] * d_in + (eta * cos_in - cos_tr)[:, None] * n)
    r0 = ((1.0 - 1.0 / eta) / (1.0 + 1.0 / eta)) ** 2
    fresnel = r0 + (1.0 - r0) * (1.0 - cos_t0.abs()) ** 5
    reflect = tir | (rng.u(_tag(bounce, SITE_FRESNEL)) < fresnel)
    wi_x = _sel(reflect, refl, refr)
    mirror, diel = s.kind == MIRROR, s.kind == DIELECTRIC
    wi = _sel(mirror, wi_m, _sel(diel, wi_x, wi_d))
    weight = _sel(mirror, w_m, _sel(diel, s.albedo, w_d))
    sign = torch.where(diel & ~reflect, -1.0, 1.0).to(n.dtype)
    return wi, weight, mirror | diel, sign


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------


def camera_rays(cam, px, py, width, height, jx, jy, dtype):
    dev = px.device
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).to(dtype)
    pos, look, up = f(cam.position), f(cam.look_at), f(cam.up)
    forward = normalize(look - pos)
    right = normalize(cross(forward, up))
    up2 = cross(right, forward)
    tan_half = torch.tan(f(cam.vfov_deg) * (math.pi / 180.0) * 0.5)
    ndc_x = ((px.to(dtype) + jx) / width * 2.0 - 1.0) * tan_half * (
        width / height)
    ndc_y = (1.0 - (py.to(dtype) + jy) / height * 2.0) * tan_half
    d = normalize(forward + ndc_x[:, None] * right + ndc_y[:, None] * up2)
    return pos.expand(d.shape).contiguous(), d


def trace_paths(ws: WorldScene, org, dirn, rng: Stream, max_bounces: int,
                use_nee: bool):
    """Radiance of each path started at (org, dirn)."""
    n, dev, dt = org.shape[0], org.device, ws.dtype
    radiance = torch.zeros((n, 3), dtype=dt, device=dev)
    thr = torch.ones((n, 3), dtype=dt, device=dev)
    alive = torch.arange(n, device=dev)  # indices of the live paths
    allow = torch.ones(n, dtype=torch.bool, device=dev)
    for bounce in range(max_bounces + 1):
        if alive.numel() == 0:
            break
        o, d = org[alive], dirn[alive]
        t, u, v, tri, ok = ws.closest(o, d)
        miss = alive[~ok]
        radiance[miss] += thr[miss] * ws.background
        h = alive[ok]
        o, d, t, u, v, tri = o[ok], d[ok], t[ok], u[ok], v[ok], tri[ok]
        sub = _SubStream(rng, h)
        s = Surface(ws, o, d, t, u, v, tri)
        th = thr[h]
        radiance[h] += _sel(allow[h], th * s.emission,
                            torch.zeros_like(th))
        if use_nee:
            so = s.offset(torch.ones_like(t))
            wi, dist, weight, valid = _light(ws, so, sub, bounce)
            contrib = th * s.brdf(-d, wi) * torch.clamp_min(
                dot(s.n, wi), 0.0)[:, None] * weight
            want = valid & (contrib.amax(-1) > 0)
            w_idx = want.nonzero(as_tuple=True)[0]
            occ = ws.occluded(so[w_idx], wi[w_idx],
                              dist[w_idx] * (1.0 - SHADOW_EPS))
            lit = w_idx[~occ]
            radiance[h[lit]] += contrib[lit]
        wi, weight, specular, sign = _bounce(s, -d, sub, bounce)
        th = th * weight
        thr[h] = th
        org = org.clone()
        dirn = dirn.clone()
        org[h] = s.offset(sign)
        dirn[h] = wi
        allow[h] = specular | (not use_nee)
        keep = (th.amax(-1) > CUTOFF) if bounce < max_bounces else \
            torch.zeros(h.shape[0], dtype=torch.bool, device=dev)
        alive = h[keep]
    return radiance


class _SubStream:
    """A Stream restricted to the paths ``idx``."""

    def __init__(self, rng: Stream, idx):
        self.base = rng.base[idx]
        self.dtype = rng.dtype

    u = Stream.u


def render_pixels(ws: WorldScene, cam, seed: int, n_samples: int, px, py,
                  width: int, height: int, max_bounces: int, use_nee: bool,
                  path_budget: int = 1 << 16):
    """(P, 3) radiance sums of pixels (px, py) over the samples
    [0, n_samples), in ``ws.dtype``."""
    dev, dt = px.device, ws.dtype
    total = torch.zeros((px.shape[0], 3), dtype=torch.float32, device=dev)
    per = max(1, path_budget // max(n_samples, 1))
    for s in range(0, px.shape[0], per):
        x = px[s:s + per].to(torch.int64)
        y = py[s:s + per].to(torch.int64)
        k = x.shape[0]
        sample = torch.arange(n_samples, device=dev).repeat_interleave(k)
        xr, yr = x.repeat(n_samples), y.repeat(n_samples)
        rng = Stream(seed, sample, yr * width + xr, dt)
        jx, jy = rng.u(TAG_JITTER), rng.u(TAG_JITTER + 1)
        org, dirn = camera_rays(cam, xr, yr, width, height, jx, jy, dt)
        rad = trace_paths(ws, org, dirn, rng, max_bounces, use_nee)
        total[s:s + k] = rad.float().view(n_samples, k, 3).sum(0)
    return total


def to_u8(mean):
    """Display bytes of a mean radiance: clamp, gamma 2.2, round half up."""
    x = torch.clamp(mean, 0.0, 1.0) ** (1.0 / 2.2)
    return torch.clamp(x * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
