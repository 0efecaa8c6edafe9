"""Tile-wavefront traversal — port of the flat entry-row path of
``tpurt.kernels.tilewave`` (``make_tile_intersector``).

A wave of rays is cut into 1024-ray tiles. Each tile gets a front-to-back
row of entry words ``(tn_q << 16) | cluster`` — the clusters some ray of
the tile may hit, keyed by a floor-quantized lower bound of their slab
entry distance — and the traversal kernel walks that row, testing the
clusters' triangles against the tile's rays:

  1. bounce and shadow waves are octant-sorted (direction sign first,
     origin Morton second) so tiles are coherent, and their entry rows
     come from the exact per-ray slab reduction (K2, ``exact_entries``);
     primary waves keep the screen-tile order and take their rows from
     the conservative interval-frustum mask ``_tile_mask``;
  2. each row is sorted (``torch.sort`` along the cluster axis);
  3. the traversal loop (K1, ``tileloop``) runs per tile, closest-hit or
     lean any-hit;
  4. results are un-permuted to the caller's ray order.

Both kernels are hand-written CUDA (``tpurt_torch/csrc``) launched by
``entries_cuda``/``tileloop_cuda``; ``entries_plain``/``tileloop_plain``
are their plain PyTorch versions. The dispatching wrappers take the plain
version only for CPU tensors: a CUDA tensor launches the kernel or raises.

Not ported yet (ROADMAP §1): the all-pairs segment mode for scenes with at
most 8 clusters (item 10a), the two-level and supercluster modes (item
10), the exact-mask kernel of the budget path (K3, item 10b) and the
grid-over-pairs kernel (K4, item 15).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpurt_torch.bvh.paircluster import ROWS_PER_CLUSTER
from tpurt_torch.core.vecmath import safe_inv_dir as _safe_inv
from tpurt_torch.kernels.packet import BIG, DEAD_KEY, EPS_DENOM, \
    _expand_bits7, _quantize
from tpurt_torch.render.intersectors import Hit

TILE = 1024  # rays per tile (= threads per traversal block)
LANES = 128  # entry-slab columns pad to a multiple of this
INT32_MAX = 2 ** 31 - 1
TN_LEVELS = 32766  # largest quantized entry distance
# scenes with at most this many clusters take the reference's all-pairs
# segment mode, which is not ported yet
ALLPAIRS_MAX_CLUSTERS = 8


def _padded_lanes(n_clusters: int) -> int:
    return ((n_clusters + LANES - 1) // LANES) * LANES


def tn_scale_of(lo, hi) -> float:
    """Entry-distance quantization step: scene box diagonal / 32766, in
    f32 arithmetic as the reference computes it."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    d = hi.max(0) - lo.min(0)
    diag = np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return float(np.maximum(diag, np.float32(1e-12)) / np.float32(32766.0))


def _octant_sort_keys(org, dirn, t_max_vec, scene_lo, scene_hi):
    """Direction-octant-major, origin-Morton-minor coherence keys (uint32
    values in int64): sign-pure direction cones first, spatial locality
    second. Dead rays sort to the back."""
    ext = torch.clamp_min(scene_hi - scene_lo, 1e-12)
    q = torch.clamp((org - scene_lo) / ext, 0.0, 1.0)
    g = _quantize(q, 64)
    morton_o = ((_expand_bits7(g[:, 0]) << 2)
                | (_expand_bits7(g[:, 1]) << 1)
                | _expand_bits7(g[:, 2]))  # 18 bits
    octant = ((dirn[:, 0] >= 0.0).to(torch.int64)
              | ((dirn[:, 1] >= 0.0).to(torch.int64) << 1)
              | ((dirn[:, 2] >= 0.0).to(torch.int64) << 2))
    key = (octant << 18) | morton_o
    return torch.where(t_max_vec < 0.0, torch.full_like(key, DEAD_KEY), key)


def _tile_mask(org, dirn, t_max_vec, lo, hi, n_tiles, return_tn=False):
    """(T, C) bool, CONSERVATIVE: may cluster c's box be hit by some ray
    of tile t? With ``return_tn`` also the (T, C) f32 lower bound of the
    slab entry distance (the front-to-back key).

    Interval-arithmetic frustum test: each tile is summarized per axis
    and per direction-sign group by its alive-ray origin box and inverse
    direction interval, and the slab test runs on intervals. The per-axis
    interval is the union over present groups before the cross-axis
    max/min (a ray's group can differ per axis)."""
    o = org.reshape(n_tiles, TILE, 3)
    d = dirn.reshape(n_tiles, TILE, 3)
    tm = t_max_vec.reshape(n_tiles, TILE)
    alive = (tm >= 0.0)[..., None]
    inv = _safe_inv(d)
    tm_t = tm.amax(dim=1)  # (T,) max alive tmax (dead are -1)
    lo_b = lo[None]
    hi_b = hi[None]

    near_lo = None  # (T, C, 3) lower bound of per-axis slab entry
    far_hi = None  # (T, C, 3) upper bound of per-axis slab exit
    for g_mask in ((d >= 0.0) & alive, (d < 0.0) & alive):
        olo = torch.where(g_mask, o, BIG).amin(dim=1)  # (T, 3)
        ohi = torch.where(g_mask, o, -BIG).amax(dim=1)
        ivlo = torch.where(g_mask, inv, BIG).amin(dim=1)
        ivhi = torch.where(g_mask, inv, -BIG).amax(dim=1)
        present = g_mask.any(dim=1)[:, None]  # (T, 1, 3)

        def plane(b):  # interval of (b - o) * iv; b: (1, C, 3)
            alo = b - ohi[:, None]
            ahi = b - olo[:, None]
            p1 = alo * ivlo[:, None]
            p2 = alo * ivhi[:, None]
            p3 = ahi * ivlo[:, None]
            p4 = ahi * ivhi[:, None]
            return (
                torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)),
            )

        t0_lo, t0_hi = plane(lo_b)
        t1_lo, t1_hi = plane(hi_b)
        g_near = torch.where(present, torch.minimum(t0_lo, t1_lo), BIG)
        g_far = torch.where(present, torch.maximum(t0_hi, t1_hi), -BIG)
        near_lo = g_near if near_lo is None else torch.minimum(near_lo,
                                                               g_near)
        far_hi = g_far if far_hi is None else torch.maximum(far_hi, g_far)
    tn_lower = near_lo.amax(dim=-1)  # (T, C)
    tf_upper = far_hi.amin(dim=-1)
    mask = ((tn_lower <= tf_upper)
            & (tf_upper >= 0.0)
            & (tn_lower <= tm_t[:, None])
            & (tm_t[:, None] >= 0.0))
    if return_tn:
        return mask, tn_lower
    return mask


def _pack_entries(mask, tn, scale: float):
    """(T, C) hit mask + min entry distance → (T, cp) i32 entry words
    ``clamp(trunc(max(tn, 0) / scale), 0, 32766) << 16 | c``, INT32_MAX
    where nothing hits and on lane padding. Clamped in float before the
    cast: an out-of-range float→int cast is undefined."""
    n_tiles, n_c = mask.shape
    scale_t = torch.full((1, 1), scale, dtype=torch.float32,
                         device=tn.device)
    q = torch.clamp(torch.clamp_min(tn, 0.0) / scale_t, 0.0, TN_LEVELS)
    cl = torch.arange(n_c, dtype=torch.int32, device=tn.device)[None, :]
    word = torch.where(mask, (q.to(torch.int32) << 16) | cl,
                       torch.full_like(cl, INT32_MAX))
    cp = _padded_lanes(n_c)
    if cp != n_c:
        word = torch.nn.functional.pad(word, (0, cp - n_c),
                                       value=INT32_MAX)
    return word


# --------------------------------------------------------------------------
# K2: exact entry build
# --------------------------------------------------------------------------


def entries_plain(org, inv_d, tmax, lo, hi, scale: float):
    """Plain PyTorch version of the exact entry build: per (tile,
    cluster), slab-test every live ray, keep hit-any and the minimum
    entry distance over hitting rays, pack the entry word.
    Returns the unsorted (T, cp) int32 slab."""
    n_tiles = org.shape[0] // TILE
    n_c = lo.shape[0]
    budget = 1 << (26 if org.device.type == "cuda" else 22)
    tiles_per_chunk = max(1, budget // (TILE * n_c))
    hits, tns = [], []
    for a in range(0, n_tiles, tiles_per_chunk):
        b = min(a + tiles_per_chunk, n_tiles)
        o = org[a * TILE:b * TILE].reshape(b - a, TILE, 1, 3)
        iv = inv_d[a * TILE:b * TILE].reshape(b - a, TILE, 1, 3)
        tm = tmax[a * TILE:b * TILE].reshape(b - a, TILE, 1)
        tn = torch.zeros((b - a, TILE, n_c), dtype=torch.float32,
                         device=org.device)
        tf = torch.clamp_min(tm, 0.0).expand(b - a, TILE, n_c)
        for ax in range(3):
            t0 = (lo[None, None, :, ax] - o[..., ax]) * iv[..., ax]
            t1 = (hi[None, None, :, ax] - o[..., ax]) * iv[..., ax]
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        hit = (tn <= tf) & (tm >= 0.0)
        hits.append(hit.any(dim=1))
        tns.append(torch.where(hit, tn, BIG).amin(dim=1))
    return _pack_entries(torch.cat(hits), torch.cat(tns), scale)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def entries_cuda(org, inv_d, tmax, lo, hi, scale: float):
    """Launch the CUDA entry-build kernel (csrc/entries.cu) on the
    current stream. Returns the unsorted (T, cp) int32 slab."""
    from tpurt_torch.kernels import cuda_build

    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"entries_cuda needs CUDA tensors, got {dev}")
    n = org.shape[0]
    if n % TILE:
        raise ValueError(f"ray count {n} is not a multiple of {TILE}")
    n_tiles, n_c = n // TILE, lo.shape[0]
    if not 0 < n_c < 65536:
        raise ValueError(f"{n_c} clusters: entry words hold 16-bit ids")
    f32 = torch.float32
    _check("org", org, f32, (n, 3), dev)
    _check("inv_d", inv_d, f32, (n, 3), dev)
    _check("tmax", tmax, f32, (n,), dev)
    _check("lo", lo, f32, (n_c, 3), dev)
    _check("hi", hi, f32, (n_c, 3), dev)
    cp = _padded_lanes(n_c)
    out = torch.empty((n_tiles, cp), dtype=torch.int32, device=dev)
    lib = cuda_build.load().lib
    err = lib.tpurt_entries(
        org.data_ptr(), inv_d.data_ptr(), tmax.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), n_tiles, n_c, cp, scale, out.data_ptr(),
        _stream(dev))
    if err:
        raise RuntimeError(f"entries kernel launch failed: cudaError {err}")
    entries_cuda.launches += 1
    return out


entries_cuda.launches = 0


def exact_entries(org, inv_d, tmax, lo, hi, scale: float):
    """K2 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if org.device.type == "cpu":
        return entries_plain(org, inv_d, tmax, lo, hi, scale)
    return entries_cuda(org, inv_d, tmax, lo, hi, scale)


# --------------------------------------------------------------------------
# K1: traversal loop over sorted entry rows
# --------------------------------------------------------------------------


def _slab_pass(o, iv, lo, hi, far):
    """Conservative per-ray slab test: the box is padded by 1e-5 of its
    coordinate magnitude and the far limit by 1e-5 relative, so float
    rounding at a box face never prunes a true hit. o/iv/far broadcast
    against lo/hi (..., 3)."""
    pad = 1e-5 * torch.clamp_min(torch.maximum(lo.abs(), hi.abs()), 1.0)
    t0 = (lo - pad - o) * iv
    t1 = (hi + pad - o) * iv
    tn = torch.clamp_min(torch.minimum(t0, t1).amax(dim=-1), 0.0)
    tf = torch.minimum(torch.maximum(t0, t1).amin(dim=-1),
                       far * (1.0 + 1e-5))
    return tn <= tf


def _row_tests(rows, o, d, window, lean):
    """12 Möller–Trumbore tests of each gathered row (K, 128) against its
    ray (K, 3), in the kernel's op order. Closest: (t, u, v, slot, ok)
    each (K, 12). Lean: (K, 12) bool hits of the division-free window
    test with per-row window ``window`` (K,)."""
    tri = rows[:, :120].reshape(-1, 12, 10)
    v0x, v0y, v0z = tri[..., 0], tri[..., 1], tri[..., 2]
    e1x, e1y, e1z = tri[..., 3], tri[..., 4], tri[..., 5]
    e2x, e2y, e2z = tri[..., 6], tri[..., 7], tri[..., 8]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    if lean:
        sg = torch.where(det >= 0.0, 1.0, -1.0)
        ad = det * sg
        su = (tx * px + ty * py + tz * pz) * sg
        sv = (dx * qx + dy * qy + dz * qz) * sg
        st = (e2x * qx + e2y * qy + e2z * qz) * sg
        return ((ad > EPS_DENOM) & (su >= 0.0) & (sv >= 0.0)
                & (su + sv <= ad) & (st > 0.0)
                & (st < window[:, None] * ad))
    ok_det = torch.abs(det) > EPS_DENOM
    inv = 1.0 / torch.where(ok_det, det, 1.0)
    u = (tx * px + ty * py + tz * pz) * inv
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return t, u, v, tri[..., 9], ok


def tileloop_plain(org, dirn, inv_d, tmax, tri_rows, entries, counts,
                   scale: float, any_hit: bool):
    """Plain PyTorch version of the traversal loop.

    Per ray, every triangle of every cluster in its tile's live entries is
    a candidate; the closest variant keeps the minimal t below tmax with
    ties going to the earliest (entry, row, lane), which is what the
    kernel's strict-'<' fold in that order gives; the lean any-hit
    variant ORs the division-free window test. The far break and the box
    tests only prune, so this version replaces them with conservative
    per-ray box tests (``_slab_pass``) and ignores ``scale``.
    Returns (bt, bu, bv, bs) per ray, as the kernel does.
    """
    del scale
    dev = org.device
    n = org.shape[0]
    n_tiles = entries.shape[0]
    alive = tmax >= 0.0
    bt = torch.where(alive, tmax, -1.0)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    bs = torch.full_like(bu, -1.0)
    best_k = torch.full((n,), 2 ** 62, dtype=torch.int64, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    clusters = tri_rows.reshape(-1, ROWS_PER_CLUSTER, 128)
    # the boxes the kernel reads: cluster AABB in lanes 126–127 of rows
    # 0–2, row sub-boxes in lanes 120–125
    c_lo = torch.stack([clusters[:, 0, 126], clusters[:, 0, 127],
                        clusters[:, 1, 126]], dim=-1)
    c_hi = torch.stack([clusters[:, 1, 127], clusters[:, 2, 126],
                        clusters[:, 2, 127]], dim=-1)
    row_box = clusters[..., 120:126].contiguous()  # (C, 8, 6)
    p_all = int(counts.max()) if n_tiles else 0
    if p_all == 0:
        return bt, bu, bv, bs
    # chunk tiles so the (tiles, TILE, entries) slab temporaries and the
    # gathered candidate rows stay bounded
    budget = 1 << (26 if dev.type == "cuda" else 22)
    tiles_per_chunk = max(1, budget // (TILE * p_all))
    rows_per_chunk = budget // 128
    lanes = torch.arange(p_all, device=dev)
    for a in range(0, n_tiles, tiles_per_chunk):
        b = min(a + tiles_per_chunk, n_tiles)
        ent = entries[a:b, :p_all].to(torch.int64)
        live_e = lanes[None, :] < counts[a:b, None]
        cl = torch.where(live_e, ent & 0xFFFF, 0)  # (Tc, P)
        ray0 = a * TILE
        o = org[ray0:b * TILE].reshape(b - a, TILE, 1, 3)
        iv = inv_d[ray0:b * TILE].reshape(b - a, TILE, 1, 3)
        tm = tmax[ray0:b * TILE].reshape(b - a, TILE, 1)
        pair = (_slab_pass(o, iv, c_lo[cl][:, None], c_hi[cl][:, None], tm)
                & (tm >= 0.0) & live_e[:, None, :])
        ti, ri, pi = torch.nonzero(pair, as_tuple=True)
        ray = ray0 + ti * TILE + ri  # global ray ids of the pairs
        pc = cl[ti, pi]
        rb = row_box[pc]  # (M, 8, 6)
        rpass = _slab_pass(org[ray][:, None], inv_d[ray][:, None],
                           rb[..., 0:3], rb[..., 3:6], tmax[ray][:, None])
        mi, row = torch.nonzero(rpass, as_tuple=True)
        for c0 in range(0, mi.shape[0], rows_per_chunk):
            m = mi[c0:c0 + rows_per_chunk]
            rr = row[c0:c0 + rows_per_chunk]
            rg = ray[m]
            rows = clusters[pc[m], rr]  # (K, 128)
            if any_hit:
                hit = _row_tests(rows, org[rg], dirn[rg], tmax[rg], True)
                occ[rg[hit.any(dim=1)]] = True
                continue
            t, u, v, sl, ok = _row_tests(rows, org[rg], dirn[rg], None,
                                         False)
            key = ((pi[m] * 96 + rr * 12)[:, None]
                   + torch.arange(12, device=dev)[None, :])
            ok = ok & (t < tmax[rg][:, None])
            k_i, j_i = torch.nonzero(ok, as_tuple=True)
            _merge_closest(rg[k_i], t[k_i, j_i], key[k_i, j_i],
                           u[k_i, j_i], v[k_i, j_i], sl[k_i, j_i],
                           bt, best_k, bu, bv, bs)
    if any_hit:
        return (torch.where(occ, -1.0, bt), bu, bv,
                torch.where(occ, 0.0, bs))
    return bt, bu, bv, bs


def _merge_closest(rg, t, key, u, v, sl, bt, best_k, bu, bv, bs):
    """Fold candidates into the per-ray best in place: smaller t wins,
    equal t goes to the smaller (entry, row, lane) key."""
    if rg.numel() == 0:
        return
    n = bt.shape[0]
    tmin = torch.full((n,), math.inf, dtype=torch.float32,
                      device=bt.device)
    tmin = tmin.scatter_reduce(0, rg, t, "amin")
    at_min = t == tmin[rg]
    kmin = torch.full((n,), 2 ** 62, dtype=torch.int64, device=bt.device)
    kmin = kmin.scatter_reduce(0, rg[at_min], key[at_min], "amin")
    win = at_min & (key == kmin[rg])  # one candidate per ray
    rw, tw, kw = rg[win], t[win], key[win]
    better = (tw < bt[rw]) | ((tw == bt[rw]) & (kw < best_k[rw]))
    rw = rw[better]
    bt[rw] = tw[better]
    best_k[rw] = kw[better]
    bu[rw] = u[win][better]
    bv[rw] = v[win][better]
    bs[rw] = sl[win][better]


def tileloop_cuda(org, dirn, inv_d, tmax, tri_rows, entries, counts,
                  scale: float, any_hit: bool):
    """Launch the CUDA traversal kernel (csrc/tileloop.cu) on the current
    stream: closest-hit, or the lean any-hit variant when ``any_hit``.
    Returns (bt, bu, bv, bs) per ray."""
    from tpurt_torch.kernels import cuda_build

    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"tileloop_cuda needs CUDA tensors, got {dev}")
    n = org.shape[0]
    if n % TILE:
        raise ValueError(f"ray count {n} is not a multiple of {TILE}")
    n_tiles = n // TILE
    cp = entries.shape[1]
    f32 = torch.float32
    _check("org", org, f32, (n, 3), dev)
    _check("dirn", dirn, f32, (n, 3), dev)
    _check("inv_d", inv_d, f32, (n, 3), dev)
    _check("tmax", tmax, f32, (n,), dev)
    _check("tri_rows", tri_rows, f32, (tri_rows.shape[0], 128), dev)
    _check("entries", entries, torch.int32, (n_tiles, cp), dev)
    _check("counts", counts, torch.int32, (n_tiles,), dev)
    if tri_rows.shape[0] % ROWS_PER_CLUSTER:
        raise ValueError("tri_rows must hold whole clusters of 8 rows")
    out = torch.empty((4, n), dtype=f32, device=dev)
    lib = cuda_build.load().lib
    err = lib.tpurt_tileloop(
        org.data_ptr(), dirn.data_ptr(), inv_d.data_ptr(), tmax.data_ptr(),
        tri_rows.data_ptr(), entries.data_ptr(), counts.data_ptr(),
        n_tiles, cp, scale, int(bool(any_hit)), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(),
        _stream(dev))
    if err:
        raise RuntimeError(f"tileloop kernel launch failed: cudaError {err}")
    tileloop_cuda.launches += 1
    return out[0], out[1], out[2], out[3]


tileloop_cuda.launches = 0


def tileloop(org, dirn, inv_d, tmax, tri_rows, entries, counts,
             scale: float, any_hit: bool):
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    fn = tileloop_plain if org.device.type == "cpu" else tileloop_cuda
    return fn(org, dirn, inv_d, tmax, tri_rows, entries, counts, scale,
              any_hit)


def reset_launch_counts() -> None:
    entries_cuda.launches = 0
    tileloop_cuda.launches = 0


# --------------------------------------------------------------------------
# the intersector
# --------------------------------------------------------------------------


def _scene_exit_cap(org, dirn, tmv, lo_all, hi_all, diag):
    """Scene-exit tmax cap (exact, not heuristic): every primitive lies
    inside the accel bounds, so a lane's closest hit is no farther than
    its scene-box slab exit. Miss lanes then get a finite best t (the far
    break can fire) and rays that miss the box become dead. +1e-4
    relative and +1e-4·diag absolute padding keep it conservative."""
    inv_c = _safe_inv(dirn)
    t_lo = (lo_all[None, :] - org) * inv_c
    t_hi = (hi_all[None, :] - org) * inv_c
    texit = torch.maximum(t_lo, t_hi).amin(dim=1)
    cap = texit * (1.0 + 1e-4) + 1e-4 * diag
    return torch.where(tmv >= 0.0, torch.minimum(tmv, cap), tmv)


def _trace_entry_rows(org, dirn, tmv, lo, hi, tri_rows, scale, *,
                      any_hit, exact):
    """One wave through the entry-row path: entry slab (exact K2 build on
    sorted waves, interval frustum mask on primary waves), per-row sort,
    traversal. Returns (bt, bu, bv, bs, n_pairs)."""
    n_tiles = org.shape[0] // TILE
    inv_d = _safe_inv(dirn)
    if exact:
        entry = exact_entries(org, inv_d, tmv, lo, hi, scale)
        counts = (entry != INT32_MAX).sum(dim=1, dtype=torch.int32)
    else:
        mask, tn_lower = _tile_mask(org, dirn, tmv, lo, hi, n_tiles,
                                    return_tn=True)
        counts = mask.sum(dim=1, dtype=torch.int32)
        entry = _pack_entries(mask, tn_lower, scale)
    entry = torch.sort(entry, dim=1).values  # per-row front-to-back
    bt, bu, bv, bs = tileloop(org, dirn, inv_d, tmv, tri_rows, entry,
                              counts, scale, any_hit)
    return bt, bu, bv, bs, counts.sum(dtype=torch.float32)


def make_tile_intersector(ds, accel, *, ray_sort: str = "none",
                          shadow_ray_sort: str = "octant",
                          lean: bool = False, live_cap: int = 0,
                          shadow_live_cap: int = 0):
    """Closest/any-hit pair over the flat pair-cluster accel (same
    interface as ``make_brute_force``); ``accel`` is a PairAccel of
    tensors on the rays' device.

    ``ray_sort``/``shadow_ray_sort``: "none" (keep the caller's order,
    interval-frustum entries — primary waves) or "octant" (coherence sort
    + exact entries — bounce and shadow waves). ``lean``: Hit.tri/inst
    come back as −1 (renderers shade through ``Hit.slot``).
    ``live_cap``/``shadow_live_cap``: live-wave truncation of the sorted
    closest/shadow waves (rays); alive rays past the cap are counted in
    stats[2] so the caller can re-render uncapped."""
    del ds
    n_clusters = int(accel.cluster_lo.shape[0])
    if n_clusters <= ALLPAIRS_MAX_CLUSTERS:
        raise NotImplementedError(
            f"{n_clusters} clusters: the all-pairs segment mode of the "
            "traversal kernel is not ported yet (ROADMAP §1 item 10a)")
    if getattr(accel, "pair_meta", None) is not None:
        raise NotImplementedError(
            "two-level accel: not ported yet (ROADMAP §1 item 10)")
    for s in (ray_sort, shadow_ray_sort):
        if s not in ("none", "octant"):
            raise NotImplementedError(
                f"ray sort {s!r}: only 'none' and 'octant' are ported")
    lo = accel.cluster_lo
    hi = accel.cluster_hi
    tri_rows = accel.tri_rows
    prim_tri = accel.prim_tri
    prim_inst = accel.prim_inst
    n_prims = prim_tri.shape[0]
    lo_h, hi_h = lo.cpu().numpy(), hi.cpu().numpy()
    scale = tn_scale_of(lo_h, hi_h)
    lo_all = lo.amin(dim=0)
    hi_all = hi.amax(dim=0)
    ext = hi_all - lo_all
    diag = torch.sqrt(ext[0] * ext[0] + ext[1] * ext[1] + ext[2] * ext[2])

    def _run(org, dirn, t_max, any_hit=False, sort=None, live_trunc=0):
        sort = ray_sort if sort is None else sort
        n = org.shape[0]
        dev = org.device
        tmv = torch.as_tensor(t_max, dtype=torch.float32,
                              device=dev).expand(n)
        tmv = torch.where(torch.isfinite(tmv), tmv, BIG)
        pad = (-n) % TILE
        if pad:
            org = torch.cat([org, torch.zeros((pad, 3), device=dev)])
            dirn = torch.cat([dirn, torch.ones((pad, 3), device=dev)])
            tmv = torch.cat([tmv, torch.full((pad,), -1.0, device=dev)])
        n_tiles = (n + pad) // TILE
        tmv = _scene_exit_cap(org, dirn, tmv, lo_all, hi_all, diag)
        perm = None
        if sort == "octant":
            keys = _octant_sort_keys(org, dirn, tmv, lo_all, hi_all)
            perm = torch.sort(keys, stable=True).indices
            org, dirn, tmv = org[perm], dirn[perm], tmv[perm]
        live_over = torch.zeros((), dtype=torch.float32, device=dev)
        n_full = n_tiles * TILE
        if live_trunc and perm is not None:
            kt = min(n_tiles, -(-int(live_trunc) // TILE))
            if kt < n_tiles:
                live_over = (tmv[kt * TILE:] >= 0.0).sum(dtype=torch.float32)
                org, dirn, tmv = (org[:kt * TILE], dirn[:kt * TILE],
                                  tmv[:kt * TILE])
        bt, bu, bv, bs, n_pairs = _trace_entry_rows(
            org, dirn, tmv, lo, hi, tri_rows, scale, any_hit=any_hit,
            exact=perm is not None)
        if bt.shape[0] < n_full:
            # truncated wave: the dropped tail gets the kernel's dead-lane
            # values before the un-permute
            tail = n_full - bt.shape[0]
            bt = torch.cat([bt, torch.full((tail,), -1.0, device=dev)])
            bu = torch.cat([bu, torch.zeros(tail, device=dev)])
            bv = torch.cat([bv, torch.zeros(tail, device=dev)])
            bs = torch.cat([bs, torch.full((tail,), -1.0, device=dev)])
        if perm is not None:
            fields = (bs,) if any_hit else (bt, bu, bv, bs)
            restored = []
            for f in fields:
                r = torch.empty_like(f)
                r[perm] = f
                restored.append(r)
            if any_hit:
                (bs,) = restored
            else:
                bt, bu, bv, bs = restored
        stats = torch.stack([n_pairs, torch.zeros_like(n_pairs), live_over])
        return bt[:n], bu[:n], bv[:n], bs[:n], stats

    def _hit_from(bt, bu, bv, bs):
        slot = bs.to(torch.int32)
        valid = slot >= 0
        slot_c = torch.clamp(slot, 0, n_prims - 1)
        if lean:
            tri = torch.full_like(slot_c, -1)
            inst = torch.full_like(slot_c, -1)
        else:
            tri = prim_tri[slot_c.long()]
            inst = prim_inst[slot_c.long()]
        return Hit(
            t=torch.where(valid, bt, math.inf), u=bu, v=bv, tri=tri,
            inst=inst, valid=valid,
            slot=torch.where(valid, slot_c, -1),
        )

    def closest_with_stats(org, dirn, t_min, t_max):
        del t_min
        bt, bu, bv, bs, stats = _run(org, dirn, t_max, live_trunc=live_cap)
        return _hit_from(bt, bu, bv, bs), stats

    def any_hit_with_stats(org, dirn, t_min, t_max):
        del t_min
        _, _, _, bs, stats = _run(org, dirn, t_max, any_hit=True,
                                  sort=shadow_ray_sort,
                                  live_trunc=shadow_live_cap)
        return bs >= 0.0, stats

    def closest(org, dirn, t_min, t_max) -> Hit:
        return closest_with_stats(org, dirn, t_min, t_max)[0]

    def any_hit(org, dirn, t_min, t_max):
        return any_hit_with_stats(org, dirn, t_min, t_max)[0]

    closest.with_stats = closest_with_stats
    any_hit.with_stats = any_hit_with_stats
    return closest, any_hit

