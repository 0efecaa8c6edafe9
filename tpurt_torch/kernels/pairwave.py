"""Pair-wavefront traversal — port of ``tpurt.kernels.pairwave``
(``make_pair_intersector``, the ``bvh_pair`` intersector).

Every ray is matched to exactly the clusters whose boxes it pierces, and
only those (ray, cluster) pairs are tested:

  1. cull (plain torch): the per-ray slab mask (N, C), in ray chunks of
     RAY_CHUNK rows;
  2. expand (plain torch): per chunk, the mask's cluster-major nonzeros
     become a pair list of static capacity, each cluster's segment padded
     to SEG_ALIGN slots so a BLOCK-slot block spans at most MAX_SPAN
     clusters; per-block cluster ranges by ``searchsorted``; a chunk with
     more pairs than its capacity drops its trailing clusters' pairs and
     sets the overflow flag;
  3. test (K6, ``pair_test``): every slot against its cluster's 96
     triangles;
  4. reduce (plain torch): per ray the minimum t, then the minimum slot
     among the rays' winners, then u/v.

The kernel is hand-written CUDA (``tpurt_torch/csrc/pairwave.cu``)
launched by ``pair_test_cuda``; ``pair_test_plain`` is its plain PyTorch
version, and the wrapper takes it only for CPU tensors.

The any-hit closure runs the same closest trace and reports no stats,
as in the reference: a caller that reads overflow only through
``with_stats`` sees none from shadow waves.
"""

from __future__ import annotations

import math

import torch

from tpurt_torch import kernels
from tpurt_torch.bvh.paircluster import ROWS_PER_CLUSTER
from tpurt_torch.core.vecmath import safe_inv_dir as _safe_inv
from tpurt_torch.kernels.packet import BIG
from tpurt_torch.kernels.tilewave import _check, _row_tests
from tpurt_torch.render.intersectors import Hit

BLOCK = 1024  # pair slots per kernel block of the list
SEG_ALIGN = 64  # cluster segments pad to this → a block spans ≤ 16
MAX_SPAN = BLOCK // SEG_ALIGN
RAY_CHUNK = 1 << 17  # cull-phase ray rows per mask chunk


def _cull_mask(org, inv, tmax, lo, hi):
    """(m, C) bool: does ray i's slab interval against box c start within
    [0, tmax] (the reference's cull, axis by axis)."""
    tn = tf = None
    for ax in range(3):
        t0 = (lo[None, :, ax] - org[:, ax, None]) * inv[:, ax, None]
        t1 = (hi[None, :, ax] - org[:, ax, None]) * inv[:, ax, None]
        near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = near if tn is None else torch.maximum(tn, near)
        tf = far if tf is None else torch.minimum(tf, far)
    tm = tmax[:, None]
    return (tn <= tf) & (tf >= 0.0) & (tn <= tm) & (tm >= 0.0)


def _cull_expand(org, dirn, t_max_vec, lo, hi, *, n_clusters, pair_cap):
    """Phases 1–2: per-ray box cull and cluster-major pair expansion.

    Returns (pair_ray, pair_cluster, block_cmin, block_cmax, n_pairs,
    overflow): int32 slot lists with pair_ray < 0 on padding, int32
    per-block cluster ranges (−1 past the last segment of a chunk), the
    real pair count and the overflow flag (0-d tensors)."""
    n = org.shape[0]
    dev = org.device
    i64 = torch.int64
    inv = _safe_inv(dirn)
    n_chunks = max(1, math.ceil(n / RAY_CHUNK))
    chunk = math.ceil(n / n_chunks)
    cap_chunk = -(-pair_cap // n_chunks)
    cap_chunk = -(-cap_chunk // BLOCK) * BLOCK
    # aligned capacity per chunk: every cluster may pad up to SEG_ALIGN − 1
    acap_chunk = cap_chunk + n_clusters * SEG_ALIGN
    acap_chunk = -(-acap_chunk // BLOCK) * BLOCK
    starts = torch.arange(acap_chunk // BLOCK, dtype=i64, device=dev) * BLOCK
    zero = torch.zeros(1, dtype=i64, device=dev)
    rays, clusters, cmins, cmaxs = [], [], [], []
    total = torch.zeros((), dtype=i64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for ci in range(n_chunks):
        s = ci * chunk
        e = min(n, s + chunk)
        m = e - s
        mask = _cull_mask(org[s:e], inv[s:e], t_max_vec[s:e], lo, hi)
        counts = mask.sum(dim=0)  # (C,) int64
        u_off = torch.cat([zero, torch.cumsum(counts, 0)])
        a_off = torch.cat([zero, torch.cumsum(
            -(-counts // SEG_ALIGN) * SEG_ALIGN, 0)])
        # the first cap_chunk pairs in cluster-major order
        idx = torch.nonzero(mask.t().reshape(-1)).reshape(-1)[:cap_chunk]
        c_of = idx // m
        r_of = idx - c_of * m
        pos = a_off[c_of] + torch.arange(idx.shape[0], device=dev) \
            - u_off[c_of]
        fits = pos < acap_chunk
        pos = pos[fits]
        pr = torch.full((acap_chunk,), -1, dtype=torch.int32, device=dev)
        pr[pos] = (r_of[fits] + s).to(torch.int32)
        pcl = torch.full((acap_chunk,), -1, dtype=torch.int32, device=dev)
        pcl[pos] = c_of[fits].to(torch.int32)
        rays.append(pr)
        clusters.append(pcl)
        total = total + u_off[-1]
        overflow = overflow | (u_off[-1] > cap_chunk)
        # per-block cluster ranges from the aligned offsets
        live = starts < a_off[-1]
        for lst, ends in ((cmins, starts), (cmaxs, starts + BLOCK - 1)):
            c = torch.searchsorted(a_off, ends, right=True) - 1
            lst.append(torch.where(live, torch.clamp(c, 0, n_clusters - 1),
                                   -1).to(torch.int32))
    return (torch.cat(rays), torch.cat(clusters), torch.cat(cmins),
            torch.cat(cmaxs), total, overflow)


# --------------------------------------------------------------------------
# K6: the pair test
# --------------------------------------------------------------------------


def pair_test_plain(pair_ray, pair_cluster, block_cmin, org, dirn, tmax,
                    tri_rows):
    """Plain PyTorch version of the pair test: every live slot against its
    own cluster's 96 triangles, folded as the reference folds them (within
    a row the lowest lane at the minimum, failed tests counting as BIG;
    across rows strict '<' from bt = tmax). Dead slots give
    (−1, 0, 0, −1). ``block_cmin`` only lets the kernel skip padding
    blocks, which hold dead slots alone. Returns (bt, bu, bv, bs), each
    (P,) f32."""
    del block_cmin
    dev = org.device
    p = pair_ray.shape[0]
    bt = torch.full((p,), -1.0, dtype=torch.float32, device=dev)
    bu = torch.zeros_like(bt)
    bv = torch.zeros_like(bt)
    bs = torch.full_like(bt, -1.0)
    slot = torch.nonzero(pair_ray >= 0).reshape(-1)
    ray = pair_ray[slot].long()
    tm = tmax[ray]
    slot, ray, tm = slot[tm >= 0.0], ray[tm >= 0.0], tm[tm >= 0.0]
    bt[slot] = tm
    blocks = tri_rows.reshape(-1, ROWS_PER_CLUSTER, 128)
    lanes = torch.arange(12, device=dev)
    step = 1 << (18 if dev.type == "cuda" else 14)
    for a in range(0, slot.shape[0], step):
        sl, ry = slot[a:a + step], ray[a:a + step]
        o, d = org[ry], dirn[ry]
        cl = pair_cluster[sl].long()
        best_t, best_u = tm[a:a + step], torch.zeros_like(tm[a:a + step])
        best_v, best_s = torch.zeros_like(best_u), torch.full_like(best_u,
                                                                   -1.0)
        for row in range(ROWS_PER_CLUSTER):
            t, u, v, ids, ok = _row_tests(blocks[cl, row], o, d, None, False)
            cand = torch.where(ok, t, BIG)
            rt = cand.amin(dim=1)
            j = torch.where(cand == rt[:, None], lanes, 12).amin(dim=1,
                                                                 keepdim=True)
            win = rt < best_t
            best_t = torch.where(win, rt, best_t)
            best_u = torch.where(win, u.gather(1, j)[:, 0], best_u)
            best_v = torch.where(win, v.gather(1, j)[:, 0], best_v)
            best_s = torch.where(win, ids.gather(1, j)[:, 0], best_s)
        bt[sl], bu[sl], bv[sl], bs[sl] = best_t, best_u, best_v, best_s
    return bt, bu, bv, bs


def pair_test_cuda(pair_ray, pair_cluster, block_cmin, org, dirn, tmax,
                   tri_rows):
    """Launch the CUDA pair-test kernel (csrc/pairwave.cu) on the current
    stream. Returns (bt, bu, bv, bs), each (P,) f32."""
    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"pair_test_cuda needs CUDA tensors, got {dev}")
    p, n = pair_ray.shape[0], org.shape[0]
    if p % BLOCK:
        raise ValueError(f"{p} pair slots is not a multiple of {BLOCK}")
    if tri_rows.shape[0] % ROWS_PER_CLUSTER:
        raise ValueError("tri_rows must hold whole clusters of 8 rows")
    f32, i32 = torch.float32, torch.int32
    _check("pair_ray", pair_ray, i32, (p,), dev)
    _check("pair_cluster", pair_cluster, i32, (p,), dev)
    _check("block_cmin", block_cmin, i32, (p // BLOCK,), dev)
    _check("org", org, f32, (n, 3), dev)
    _check("dirn", dirn, f32, (n, 3), dev)
    _check("tmax", tmax, f32, (n,), dev)
    _check("tri_rows", tri_rows, f32, (tri_rows.shape[0], 128), dev)
    out = torch.empty((4, p), dtype=f32, device=dev)
    kernels.launch(
        "pair", dev, pair_ray.data_ptr(), pair_cluster.data_ptr(),
        block_cmin.data_ptr(), org.data_ptr(), dirn.data_ptr(),
        tmax.data_ptr(), tri_rows.data_ptr(), p, out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), out[3].data_ptr(), work=p > 0)
    return tuple(out)


def pair_test(pair_ray, pair_cluster, block_cmin, org, dirn, tmax, tri_rows):
    """K6 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = pair_test_plain if org.device.type == "cpu" else pair_test_cuda
    return fn(pair_ray, pair_cluster, block_cmin, org, dirn, tmax, tri_rows)


# --------------------------------------------------------------------------
# the intersector
# --------------------------------------------------------------------------


def _trace_pairs(org, dirn, t_max_vec, lo, hi, tri_rows, *, n_clusters,
                 pair_cap):
    """Cull → expand → K6 → per-ray reduce. Returns (bt, bu, bv, bs,
    stats) with bt = BIG and bs = −1 where the ray hit nothing and stats
    = [n_pairs, overflow]."""
    n = org.shape[0]
    dev = org.device
    org, dirn, t_max_vec = (x.contiguous() for x in (org, dirn, t_max_vec))
    pair_ray, pair_cluster, block_cmin, _, n_pairs, overflow = _cull_expand(
        org, dirn, t_max_vec, lo, hi, n_clusters=n_clusters,
        pair_cap=pair_cap)
    bt, bu, bv, bs = pair_test(pair_ray, pair_cluster, block_cmin, org, dirn,
                               t_max_vec, tri_rows)
    # per-ray reduction over the live slots: closest t, then the minimum
    # slot among the winners, then its u/v
    live = torch.nonzero(pair_ray >= 0).reshape(-1)
    ray = pair_ray[live].long()
    bt, bu, bv, bs = bt[live], bu[live], bv[live], bs[live]
    hit = bs >= 0.0

    def scatter(values, init, how):
        out = torch.full((n,), init, dtype=torch.float32, device=dev)
        return out.scatter_reduce(0, ray, values, how)

    best_t = scatter(torch.where(hit, bt, BIG), BIG, "amin")
    win1 = hit & (bt <= best_t[ray])
    best_s = scatter(torch.where(win1, bs, BIG), BIG, "amin")
    win2 = win1 & (bs == best_s[ray])
    u_best = scatter(torch.where(win2, bu, -BIG), 0.0, "amax")
    v_best = scatter(torch.where(win2, bv, -BIG), 0.0, "amax")
    found = best_t < BIG
    u_best = torch.where(found, torch.clamp_min(u_best, 0.0), 0.0)
    v_best = torch.where(found, torch.clamp_min(v_best, 0.0), 0.0)
    slot = torch.where(found, best_s, -1.0)
    stats = torch.stack([n_pairs.to(torch.float32),
                         overflow.to(torch.float32)])
    return best_t, u_best, v_best, slot, stats


def make_pair_intersector(ds, accel, *, pairs_per_ray: int = 8):
    """Closest/any-hit pair over a flat pair-cluster accel of tensors on
    the rays' device (same interface as ``make_brute_force``).

    ``pairs_per_ray`` sizes the static pair capacity (N × pairs_per_ray
    slots per trace, block-aligned); an overflow drops the trailing
    clusters' pairs of the affected ray chunk and is reported in
    ``closest.with_stats`` stats[1]. ``any_hit`` has no ``with_stats``.
    ``host_read(n)`` on both names the expand's host read (its pair
    lists come from ``torch.nonzero``)."""
    del ds
    lo = accel.cluster_lo
    hi = accel.cluster_hi
    tri_rows = accel.tri_rows
    prim_tri = accel.prim_tri
    prim_inst = accel.prim_inst
    n_clusters = int(lo.shape[0])
    n_prims = prim_tri.shape[0]

    def _run(org, dirn, t_max):
        n = org.shape[0]
        tm = torch.as_tensor(t_max, dtype=torch.float32,
                             device=org.device).expand(n)
        tm = torch.where(torch.isfinite(tm), tm, BIG)
        cap = -(-(n * pairs_per_ray) // BLOCK) * BLOCK
        return _trace_pairs(org, dirn, tm, lo, hi, tri_rows,
                            n_clusters=n_clusters, pair_cap=cap)

    def _hit_from(bt, bu, bv, bs):
        slot = bs.to(torch.int32)
        valid = slot >= 0
        slot_c = torch.clamp(slot, 0, n_prims - 1).long()
        return Hit(
            t=torch.where(valid, bt, math.inf), u=bu, v=bv,
            tri=prim_tri[slot_c], inst=prim_inst[slot_c], valid=valid,
            slot=torch.where(valid, slot_c.to(torch.int32), -1),
        )

    def closest_with_stats(org, dirn, t_min, t_max):
        del t_min
        bt, bu, bv, bs, stats = _run(org, dirn, t_max)
        return _hit_from(bt, bu, bv, bs), stats

    def closest(org, dirn, t_min, t_max) -> Hit:
        return closest_with_stats(org, dirn, t_min, t_max)[0]

    def any_hit(org, dirn, t_min, t_max):
        del t_min
        return _run(org, dirn, t_max)[3] >= 0.0

    closest.with_stats = closest_with_stats
    closest.host_read = any_hit.host_read = lambda n: (
        "bvh_pair's expand lists its pairs with torch.nonzero")
    return closest, any_hit
