"""Tile-wavefront traversal — port of the entry-row path of
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

With a per-tile clamp (``pairs_per_tile > 0``, the budget path) the
entry rows come unpacked instead: the exact mask and minimum entry
distance (K3, ``exact_mask``) on sorted waves, the interval mask on
primary waves; each tile keeps its first ``min(pairs_per_tile − 1, C)``
hit clusters in cluster order, the overflow flag goes to stats[1], and the
kept entries are packed, sorted and traversed as above.

The kernels are hand-written CUDA (``tpurt_torch/csrc``: K2 and K3 share
``entries.cu``) launched by ``entries_cuda``/``exact_mask_cuda``/
``tileloop_cuda``; ``entries_plain``/``exact_mask_plain``/
``tileloop_plain`` are their plain PyTorch versions. The dispatching
wrappers take the plain version only for CPU tensors: a CUDA tensor
launches the kernel or raises.

K1's modes, as the reference picks them: entry rows per cluster (flat or
two-level), entry rows per supercluster at C ≥ SC_AUTO_MIN_CLUSTERS
(sponza) unless a per-tile clamp is set, and the all-pairs row for scenes
of at most 8 clusters (the hello and Cornell presets), which ignores the
clamp. A two-level accel transforms the ray into each instance-cluster's
object space inside K1.

Entry rows are used at every wave size: device memory holds the (T, Cp)
slab where the reference's VMEM budget did not, so the reference's
pair-segment fallback past that budget (K1's ``off``/``pair_cl`` mode) is
not carried. Not ported yet (ROADMAP §1 item 15): that segment mode and
the grid-over-pairs kernel (K4).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpurt_torch.bvh.paircluster import ROWS_PER_CLUSTER, SC_SIZE
from tpurt_torch.core.vecmath import safe_inv_dir as _safe_inv
from tpurt_torch.kernels.packet import BIG, DEAD_KEY, EPS_DENOM, \
    _expand_bits7, _quantize
from tpurt_torch.render.intersectors import Hit

TILE = 1024  # rays per tile (= threads per traversal block)
LANES = 128  # entry-slab columns pad to a multiple of this
INT32_MAX = 2 ** 31 - 1
TN_LEVELS = 32766  # largest quantized entry distance
# scenes with at most this many clusters take the all-pairs row (every
# tile walks every cluster; no sort, no entry build)
ALLPAIRS_MAX_CLUSTERS = 8
# accels with superclusters and at least this many clusters build their
# entry rows over the superboxes (the reference's auto rule; its second
# trigger, a TPU VMEM budget, has no counterpart in device memory)
SC_AUTO_MIN_CLUSTERS = 2000


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


def exact_mask_plain(org, inv_d, tmax, lo, hi):
    """Plain PyTorch version of the exact mask (K3): per (tile, cluster),
    slab-test every live ray and keep hit-any and the minimum entry
    distance over the hitting rays. Returns ((T, C) bool mask, (T, C) f32
    tn_min, BIG where no ray hits)."""
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
    return torch.cat(hits), torch.cat(tns)


def entries_plain(org, inv_d, tmax, lo, hi, scale: float):
    """Plain PyTorch version of the exact entry build (K2): the exact
    mask's slab reduction, packed into entry words. Returns the unsorted
    (T, cp) int32 slab."""
    return _pack_entries(*exact_mask_plain(org, inv_d, tmax, lo, hi), scale)


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


def _slab_args(name, org, inv_d, tmax, lo, hi):
    """Checks shared by the K2 and K3 launchers; returns (device, n_tiles,
    n_clusters, cp)."""
    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
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
    return dev, n_tiles, n_c, _padded_lanes(n_c)


def entries_cuda(org, inv_d, tmax, lo, hi, scale: float):
    """Launch the CUDA entry-build kernel (csrc/entries.cu) on the
    current stream. Returns the unsorted (T, cp) int32 slab."""
    from tpurt_torch.kernels import cuda_build

    dev, n_tiles, n_c, cp = _slab_args("entries_cuda", org, inv_d, tmax, lo,
                                       hi)
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


def exact_mask_cuda(org, inv_d, tmax, lo, hi):
    """Launch the CUDA exact-mask kernel (csrc/entries.cu, the K2 body
    without the pack) on the current stream. Returns ((T, C) bool mask,
    (T, C) f32 tn_min, BIG where no ray hits)."""
    from tpurt_torch.kernels import cuda_build

    dev, n_tiles, n_c, cp = _slab_args("exact_mask_cuda", org, inv_d, tmax,
                                       lo, hi)
    mask = torch.empty((n_tiles, n_c), dtype=torch.bool, device=dev)
    tn = torch.empty((n_tiles, n_c), dtype=torch.float32, device=dev)
    lib = cuda_build.load().lib
    err = lib.tpurt_exact_mask(
        org.data_ptr(), inv_d.data_ptr(), tmax.data_ptr(), lo.data_ptr(),
        hi.data_ptr(), n_tiles, n_c, cp, mask.data_ptr(), tn.data_ptr(),
        _stream(dev))
    if err:
        raise RuntimeError(f"exact_mask kernel launch failed: cudaError {err}")
    exact_mask_cuda.launches += 1
    return mask, tn


exact_mask_cuda.launches = 0


def exact_mask(org, inv_d, tmax, lo, hi):
    """K3 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if org.device.type == "cpu":
        return exact_mask_plain(org, inv_d, tmax, lo, hi)
    return exact_mask_cuda(org, inv_d, tmax, lo, hi)


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


def _to_object(o, d, m):
    """World ray → object space of a (..., 12) world→object 3×4 matrix,
    in the kernel's term order (m0·x + m1·y + m2·z + m3, left to right).
    d is not renormalized, so t stays in world units."""
    def row(k, x, y, z):
        return m[..., 4 * k] * x + m[..., 4 * k + 1] * y + \
            m[..., 4 * k + 2] * z

    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    no = torch.stack([row(k, ox, oy, oz) + m[..., 4 * k + 3]
                      for k in range(3)], dim=-1)
    nd = torch.stack([row(k, dx, dy, dz) for k in range(3)], dim=-1)
    return no, nd


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
                   scale: float, any_hit: bool, pair_meta=None,
                   inv_xform=None, sc_meta=None):
    """Plain PyTorch version of the traversal loop.

    Per ray, every triangle of every cluster in its tile's live entries is
    a candidate; the closest variant keeps the minimal t below tmax with
    ties going to the earliest (entry, row, lane), which is what the
    kernel's strict-'<' fold in that order gives; the lean any-hit
    variant ORs the division-free window test. The far break and the box
    tests only prune, so this version replaces them with conservative
    per-ray box tests (``_slab_pass``) and ignores ``scale``.

    ``pair_meta``/``inv_xform`` (two-level accel): a cluster's rows start
    at ``pair_meta[c] & 0xFFFFF`` and each (ray, cluster) pair is tested
    in the cluster's object space (box tests included); a closest win
    records the instance ``pair_meta[c] >> 20``. ``sc_meta``: entries are
    superclusters, each expanded into its ``v >> 16`` consecutive
    children from ``v & 0xFFFF``, with the tie key
    ((entry·8 + child)·8 + row)·12 + lane.
    Returns (bt, bu, bv, bs) per ray, plus bi (instance as f32, −1 where
    none) when ``pair_meta`` is given, as the kernel does.
    """
    del scale
    dev = org.device
    n = org.shape[0]
    n_tiles = entries.shape[0]
    two_level = pair_meta is not None
    kids = SC_SIZE if sc_meta is not None else 1
    alive = tmax >= 0.0
    bt = torch.where(alive, tmax, -1.0)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    bs = torch.full_like(bu, -1.0)
    bi = torch.full_like(bu, -1.0) if two_level else None
    best_k = torch.full((n,), 2 ** 62, dtype=torch.int64, device=dev)
    occ = torch.zeros(n, dtype=torch.bool, device=dev)

    def result():
        if any_hit:
            out = (torch.where(occ, -1.0, bt), bu, bv,
                   torch.where(occ, 0.0, bs))
        else:
            out = (bt, bu, bv, bs)
        return out + (bi,) if two_level else out

    blocks = tri_rows.reshape(-1, ROWS_PER_CLUSTER, 128)
    # the boxes the kernel reads: cluster AABB in lanes 126–127 of rows
    # 0–2, row sub-boxes in lanes 120–125 (object space when two-level)
    b_lo = torch.stack([blocks[:, 0, 126], blocks[:, 0, 127],
                        blocks[:, 1, 126]], dim=-1)
    b_hi = torch.stack([blocks[:, 1, 127], blocks[:, 2, 126],
                        blocks[:, 2, 127]], dim=-1)
    row_box = blocks[..., 120:126].contiguous()  # (blocks, 8, 6)
    p_all = int(counts.max()) if n_tiles else 0
    if p_all == 0:
        return result()
    n_units = p_all * kids  # unit = entry · kids + child
    # chunk tiles so the (tiles, TILE, units) slab temporaries and the
    # gathered candidate rows stay bounded
    budget = 1 << (26 if dev.type == "cuda" else 22)
    tiles_per_chunk = max(1, budget // (TILE * n_units))
    rows_per_chunk = budget // 128
    lanes = torch.arange(p_all, device=dev)
    child = torch.arange(kids, device=dev)
    meta = pair_meta.to(torch.int64) if two_level else None
    for a in range(0, n_tiles, tiles_per_chunk):
        b = min(a + tiles_per_chunk, n_tiles)
        ent = entries[a:b, :p_all].to(torch.int64)
        live_e = lanes[None, :] < counts[a:b, None]
        eid = torch.where(live_e, ent & 0xFFFF, 0)  # (Tc, P)
        if sc_meta is not None:
            mv = sc_meta[eid].to(torch.int64)
            first = mv & 0xFFFF
            live_u = live_e[..., None] & (child < (mv >> 16)[..., None])
            cl = torch.where(live_u, first[..., None] + child, 0)
            xcl = first[..., None].expand_as(cl)  # the transform's cluster
            live_u, cl, xcl = (x.reshape(b - a, n_units)
                               for x in (live_u, cl, xcl))
        else:
            live_u, cl, xcl = live_e, eid, eid
        if two_level:
            blk = (meta[cl] & 0xFFFFF) // ROWS_PER_CLUSTER
        else:
            blk = cl
        ray0 = a * TILE
        o = org[ray0:b * TILE].reshape(b - a, TILE, 1, 3)
        d = dirn[ray0:b * TILE].reshape(b - a, TILE, 1, 3)
        iv = inv_d[ray0:b * TILE].reshape(b - a, TILE, 1, 3)
        tm = tmax[ray0:b * TILE].reshape(b - a, TILE, 1)
        if two_level:
            o, d = _to_object(o, d, inv_xform[xcl][:, None])
            iv = _safe_inv(d)
        pair = (_slab_pass(o, iv, b_lo[blk][:, None], b_hi[blk][:, None],
                           tm)
                & (tm >= 0.0) & live_u[:, None, :])
        ti, ri, ui = torch.nonzero(pair, as_tuple=True)
        ray = ray0 + ti * TILE + ri  # global ray ids of the pairs
        pc = blk[ti, ui]
        po, pd = org[ray], dirn[ray]
        if two_level:
            px = xcl[ti, ui]
            po, pd = _to_object(po, pd, inv_xform[px])
            inst_f = (meta[px] >> 20).to(torch.float32)
        rb = row_box[pc]  # (M, 8, 6)
        rpass = _slab_pass(po[:, None], _safe_inv(pd)[:, None],
                           rb[..., 0:3], rb[..., 3:6], tmax[ray][:, None])
        mi, row = torch.nonzero(rpass, as_tuple=True)
        for c0 in range(0, mi.shape[0], rows_per_chunk):
            m = mi[c0:c0 + rows_per_chunk]
            rr = row[c0:c0 + rows_per_chunk]
            rg = ray[m]
            rows = blocks[pc[m], rr]  # (K, 128)
            if any_hit:
                hit = _row_tests(rows, po[m], pd[m], tmax[rg], True)
                occ[rg[hit.any(dim=1)]] = True
                continue
            t, u, v, sl, ok = _row_tests(rows, po[m], pd[m], None, False)
            key = ((ui[m] * 96 + rr * 12)[:, None]
                   + torch.arange(12, device=dev)[None, :])
            ok = ok & (t < tmax[rg][:, None])
            k_i, j_i = torch.nonzero(ok, as_tuple=True)
            _merge_closest(
                rg[k_i], t[k_i, j_i], key[k_i, j_i], u[k_i, j_i],
                v[k_i, j_i], sl[k_i, j_i], bt, best_k, bu, bv, bs,
                inst_f[m][k_i] if two_level else None, bi)
    return result()


def _merge_closest(rg, t, key, u, v, sl, bt, best_k, bu, bv, bs,
                   inst=None, bi=None):
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
    if inst is not None:
        bi[rw] = inst[win][better]


def _variant(pair_meta, sc_meta, scale: float) -> str:
    """Launch-count name of a K1 mode: scale 0 is the all-pairs row (its
    entries carry no distance), sc_meta the supercluster entries,
    pair_meta the two-level accel."""
    name = "tileloop"
    if pair_meta is not None:
        name += "_tl"
    if sc_meta is not None:
        name += "_sc"
    elif scale == 0.0:
        name += "_allpairs"
    return name


def tileloop_cuda(org, dirn, inv_d, tmax, tri_rows, entries, counts,
                  scale: float, any_hit: bool, pair_meta=None,
                  inv_xform=None, sc_meta=None):
    """Launch the CUDA traversal kernel (csrc/tileloop.cu) on the current
    stream: closest-hit, or the lean any-hit variant when ``any_hit``;
    two-level with ``pair_meta``/``inv_xform``, supercluster entries with
    ``sc_meta``. Returns (bt, bu, bv, bs[, bi]) per ray."""
    from tpurt_torch.kernels import cuda_build

    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"tileloop_cuda needs CUDA tensors, got {dev}")
    n = org.shape[0]
    if n % TILE:
        raise ValueError(f"ray count {n} is not a multiple of {TILE}")
    n_tiles = n // TILE
    cp = entries.shape[1]
    f32, i32 = torch.float32, torch.int32
    _check("org", org, f32, (n, 3), dev)
    _check("dirn", dirn, f32, (n, 3), dev)
    _check("inv_d", inv_d, f32, (n, 3), dev)
    _check("tmax", tmax, f32, (n,), dev)
    _check("tri_rows", tri_rows, f32, (tri_rows.shape[0], 128), dev)
    _check("entries", entries, i32, (n_tiles, cp), dev)
    _check("counts", counts, i32, (n_tiles,), dev)
    if tri_rows.shape[0] % ROWS_PER_CLUSTER:
        raise ValueError("tri_rows must hold whole clusters of 8 rows")
    two_level = pair_meta is not None
    if two_level != (inv_xform is not None):
        raise ValueError("pair_meta and inv_xform come together")
    if two_level:
        _check("pair_meta", pair_meta, i32, (pair_meta.shape[0],), dev)
        _check("inv_xform", inv_xform, f32, (pair_meta.shape[0], 12), dev)
    if sc_meta is not None:
        _check("sc_meta", sc_meta, i32, (sc_meta.shape[0],), dev)
    out = torch.empty((5 if two_level else 4, n), dtype=f32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = cuda_build.load().lib
    err = lib.tpurt_tileloop(
        org.data_ptr(), dirn.data_ptr(), inv_d.data_ptr(), tmax.data_ptr(),
        tri_rows.data_ptr(), entries.data_ptr(), counts.data_ptr(),
        n_tiles, cp, scale, int(bool(any_hit)), ptr(pair_meta),
        ptr(inv_xform), ptr(sc_meta), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), out[3].data_ptr(),
        out[4].data_ptr() if two_level else None, _stream(dev))
    if err:
        raise RuntimeError(f"tileloop kernel launch failed: cudaError {err}")
    tileloop_cuda.launches += 1
    name = _variant(pair_meta, sc_meta, scale)
    tileloop_cuda.variant_launches[name] = \
        tileloop_cuda.variant_launches.get(name, 0) + 1
    return tuple(out)


tileloop_cuda.launches = 0
tileloop_cuda.variant_launches = {}


def tileloop(org, dirn, inv_d, tmax, tri_rows, entries, counts,
             scale: float, any_hit: bool, pair_meta=None, inv_xform=None,
             sc_meta=None):
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    fn = tileloop_plain if org.device.type == "cpu" else tileloop_cuda
    return fn(org, dirn, inv_d, tmax, tri_rows, entries, counts, scale,
              any_hit, pair_meta=pair_meta, inv_xform=inv_xform,
              sc_meta=sc_meta)


def reset_launch_counts() -> None:
    entries_cuda.launches = 0
    exact_mask_cuda.launches = 0
    tileloop_cuda.launches = 0
    tileloop_cuda.variant_launches = {}


def launch_counts() -> dict:
    """Launches since the last reset: K2, K3, and K1 by mode."""
    return {"entries": entries_cuda.launches,
            "exact_mask": exact_mask_cuda.launches,
            **tileloop_cuda.variant_launches}


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


def _clamp_rows(mask, pairs_per_tile: int):
    """The budget path's per-tile clamp: each tile keeps its first
    ``min(pairs_per_tile − 1, C)`` hit clusters in cluster order (the
    reference counts a grid-mode sentinel slot in the budget). Returns the
    clamped mask, the kept counts and whether any tile had more."""
    n_c = mask.shape[1]
    keep = min(pairs_per_tile - 1, n_c)
    counts_raw = mask.sum(dim=1, dtype=torch.int32)
    if keep < n_c:
        rank = torch.cumsum(mask, dim=1, dtype=torch.int32)
        mask = mask & (rank <= keep)
        overflow = (counts_raw > keep).any()
    else:
        overflow = torch.zeros((), dtype=torch.bool, device=mask.device)
    return mask, torch.clamp_max(counts_raw, keep), overflow


def _trace_entry_rows(org, dirn, tmv, lo, hi, tri_rows, scale, *,
                      any_hit, exact, tl, pairs_per_tile=0):
    """One wave through the entry-row path: entry slab over the boxes
    lo/hi (exact K2 build on sorted waves, interval frustum mask on
    primary waves; with ``pairs_per_tile > 0`` the unpacked exact mask K3
    or the interval mask, clamped per tile, then packed), per-row sort,
    traversal. ``tl``: the two-level and supercluster tables for K1.
    Returns ((bt, bu, bv, bs[, bi]), n_pairs, overflow)."""
    n_tiles = org.shape[0] // TILE
    inv_d = _safe_inv(dirn)
    overflow = torch.zeros((), dtype=torch.bool, device=org.device)
    if exact and pairs_per_tile <= 0:
        entry = exact_entries(org, inv_d, tmv, lo, hi, scale)
        counts = (entry != INT32_MAX).sum(dim=1, dtype=torch.int32)
    else:
        if exact:
            mask, tn = exact_mask(org, inv_d, tmv, lo, hi)
        else:
            mask, tn = _tile_mask(org, dirn, tmv, lo, hi, n_tiles,
                                  return_tn=True)
        if pairs_per_tile > 0:
            mask, counts, overflow = _clamp_rows(mask, pairs_per_tile)
        else:
            counts = mask.sum(dim=1, dtype=torch.int32)
        entry = _pack_entries(mask, tn, scale)
    entry = torch.sort(entry, dim=1).values  # per-row front-to-back
    out = tileloop(org, dirn, inv_d, tmv, tri_rows, entry, counts, scale,
                   any_hit, **tl)
    return out, counts.sum(dtype=torch.float32), overflow


def _trace_all_pairs(org, dirn, tmv, tri_rows, n_clusters, *, any_hit, tl):
    """One wave of a scene with at most ALLPAIRS_MAX_CLUSTERS clusters:
    every tile walks every cluster in index order. The entry row is
    [0, 1, …, C−1] (no distance bits) and the scale 0, so the far break
    fires only once every lane is dead or occluded. Returns
    ((bt, bu, bv, bs[, bi]), n_pairs)."""
    n_tiles = org.shape[0] // TILE
    dev = org.device
    entry = torch.arange(n_clusters, dtype=torch.int32, device=dev)
    entry = entry[None].expand(n_tiles, n_clusters).contiguous()
    counts = torch.full((n_tiles,), n_clusters, dtype=torch.int32,
                        device=dev)
    out = tileloop(org, dirn, _safe_inv(dirn), tmv, tri_rows, entry, counts,
                   0.0, any_hit, **tl)
    return out, torch.tensor(float(n_tiles * n_clusters), device=dev)


def make_tile_intersector(ds, accel, *, pairs_per_tile: int = 0,
                          ray_sort: str = "none",
                          shadow_ray_sort: str = "octant",
                          lean: bool = False, live_cap: int = 0,
                          shadow_live_cap: int = 0):
    """Closest/any-hit pair over a pair-cluster accel (same interface as
    ``make_brute_force``); ``accel`` is a PairAccel or PairAccelTL of
    tensors on the rays' device.

    Modes, as the reference picks them: at most ALLPAIRS_MAX_CLUSTERS
    clusters take the all-pairs row (no sort, no restore, no live
    truncation); an accel with superclusters and at least
    SC_AUTO_MIN_CLUSTERS clusters builds its entry rows over the
    superboxes and K1 expands each into its children; otherwise entries
    are per cluster. A two-level accel (``pair_meta``) runs K1 in object
    space per instance-cluster and reports the hit instance.

    ``pairs_per_tile`` > 0 clamps every tile's entry row to its first
    ``min(pairs_per_tile − 1, C)`` hit clusters in cluster order (a
    clamped tile drops hits) and reports the overflow in stats[1]; it
    switches superclusters off and leaves the all-pairs row alone, as in
    the reference. 0 = no clamp.

    ``ray_sort``/``shadow_ray_sort``: "none" (keep the caller's order,
    interval-frustum entries — primary waves) or "octant" (coherence sort
    + exact entries — bounce and shadow waves). ``lean``: Hit.tri comes
    back as −1 (and Hit.inst too on a flat accel; renderers shade through
    ``Hit.slot`` and, two-level, ``Hit.inst``).
    ``live_cap``/``shadow_live_cap``: live-wave truncation of the sorted
    closest/shadow waves (rays); alive rays past the cap are counted in
    stats[2] so the caller can re-render uncapped."""
    del ds
    for s in (ray_sort, shadow_ray_sort):
        if s not in ("none", "octant"):
            raise NotImplementedError(
                f"ray sort {s!r}: only 'none' and 'octant' are ported")
    n_clusters = int(accel.cluster_lo.shape[0])
    lo = accel.cluster_lo
    hi = accel.cluster_hi
    tri_rows = accel.tri_rows
    prim_tri = accel.prim_tri
    prim_inst = accel.prim_inst
    n_prims = prim_tri.shape[0]
    pair_meta = getattr(accel, "pair_meta", None)
    two_level = pair_meta is not None
    tl = dict(pair_meta=pair_meta,
              inv_xform=getattr(accel, "inv_xform", None))
    all_pairs = n_clusters <= ALLPAIRS_MAX_CLUSTERS
    sc_active = (not all_pairs and accel.sc_meta is not None
                 and pairs_per_tile <= 0
                 and n_clusters >= SC_AUTO_MIN_CLUSTERS)
    if sc_active:
        # entry rows over the superboxes; K1 expands the children
        e_lo, e_hi = accel.sc_lo, accel.sc_hi
        tl["sc_meta"] = accel.sc_meta
    else:
        e_lo, e_hi = lo, hi
    scale = tn_scale_of(e_lo.cpu().numpy(), e_hi.cpu().numpy())
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
        live_over = torch.zeros((), dtype=torch.float32, device=dev)
        if all_pairs:
            out, n_pairs = _trace_all_pairs(org, dirn, tmv, tri_rows,
                                            n_clusters, any_hit=any_hit,
                                            tl=tl)
            stats = torch.stack([n_pairs, torch.zeros_like(n_pairs),
                                 live_over])
            return tuple(f[:n] for f in out), stats
        perm = None
        if sort == "octant":
            keys = _octant_sort_keys(org, dirn, tmv, lo_all, hi_all)
            perm = torch.sort(keys, stable=True).indices
            org, dirn, tmv = org[perm], dirn[perm], tmv[perm]
        n_full = n_tiles * TILE
        if live_trunc and perm is not None:
            kt = min(n_tiles, -(-int(live_trunc) // TILE))
            if kt < n_tiles:
                live_over = (tmv[kt * TILE:] >= 0.0).sum(dtype=torch.float32)
                org, dirn, tmv = (org[:kt * TILE], dirn[:kt * TILE],
                                  tmv[:kt * TILE])
        out, n_pairs, overflow = _trace_entry_rows(
            org, dirn, tmv, e_lo, e_hi, tri_rows, scale, any_hit=any_hit,
            exact=perm is not None, tl=tl, pairs_per_tile=pairs_per_tile)
        if out[0].shape[0] < n_full:
            # truncated wave: the dropped tail gets the kernel's dead-lane
            # values (bt −1, bu bv 0, bs −1, bi −1) before the un-permute
            tail = n_full - out[0].shape[0]
            out = tuple(
                torch.cat([f, torch.full((tail,), 0.0 if k in (1, 2)
                                         else -1.0, device=dev)])
                for k, f in enumerate(out))
        if perm is not None:
            # un-permute only what the caller reads: any-hit waves only bs
            keep = (3,) if any_hit else range(len(out))
            restored = list(out)
            for k in keep:
                r = torch.empty_like(out[k])
                r[perm] = out[k]
                restored[k] = r
            out = tuple(restored)
        stats = torch.stack([n_pairs, overflow.to(torch.float32), live_over])
        return tuple(f[:n] for f in out), stats

    def _hit_from(bt, bu, bv, bs, bi=None):
        slot = bs.to(torch.int32)
        valid = slot >= 0
        slot_c = torch.clamp(slot, 0, n_prims - 1)
        tri = (torch.full_like(slot_c, -1) if lean
               else prim_tri[slot_c.long()])
        if two_level:
            # the instance comes from K1's fifth output (the slot is a
            # shared mesh slot): the two-level resolver needs both
            inst = torch.where(valid, bi.to(torch.int32), -1)
        elif lean:
            inst = torch.full_like(slot_c, -1)
        else:
            inst = prim_inst[slot_c.long()]
        return Hit(
            t=torch.where(valid, bt, math.inf), u=bu, v=bv, tri=tri,
            inst=inst, valid=valid,
            slot=torch.where(valid, slot_c, -1),
        )

    def closest_with_stats(org, dirn, t_min, t_max):
        del t_min
        out, stats = _run(org, dirn, t_max, live_trunc=live_cap)
        return _hit_from(*out), stats

    def any_hit_with_stats(org, dirn, t_min, t_max):
        del t_min
        out, stats = _run(org, dirn, t_max, any_hit=True,
                          sort=shadow_ray_sort, live_trunc=shadow_live_cap)
        return out[3] >= 0.0, stats

    def closest(org, dirn, t_min, t_max) -> Hit:
        return closest_with_stats(org, dirn, t_min, t_max)[0]

    def any_hit(org, dirn, t_min, t_max):
        return any_hit_with_stats(org, dirn, t_min, t_max)[0]

    closest.with_stats = closest_with_stats
    any_hit.with_stats = any_hit_with_stats
    return closest, any_hit
