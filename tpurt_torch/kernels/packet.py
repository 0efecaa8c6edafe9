"""Packet-BVH traversal — port of ``tpurt.kernels.packet``, the
``bvh_packet`` intersector.

The reference's Pallas kernel (``_packet_kernel``) walks the packet BVH of
``bvh.cluster.build_packet_accel`` with a 2048-ray packet behind one node
pointer. The port walks it per ray (K5, ``csrc/packet.cu``): stackless,
in preorder with skip links, a ray entering a node when its own slab test
passes, the lanes of a warp sharing out the triangle tests of the leaf
rows they reach. ``packet_cuda`` launches the kernel over the node tables
packed two 16-byte words a node (``pack_nodes``, once per accel by
``packet_tables``), ``packet_plain`` is its plain PyTorch version with the
same descent rule (bit-equal on the card), and ``packet`` takes the plain
version only for CPU tensors: a CUDA tensor launches the kernel or raises.

Per ray the result is the reference's — a row's 12 candidates reduce to
the first one at the minimal t, which beats the running best with a strict
``<``; dead lanes (tmax < 0) never hit; any-hit reports the first hit's
slot and normalises bt to 0 or BIG — up to slab-test rounding at grazing
boxes, where the packet's union may enter a leaf the ray's own test
rejects. The walk's counters (node steps, leaf rows) are per-ray sums over
each 2048-ray group, not the steps of the reference's one packet walk.

The module also holds the constants and ray sort keys the tile
intersector shares. Keys are uint32 values held in int64 tensors.
"""

from __future__ import annotations

import math

import torch

from tpurt_torch import kernels
from tpurt_torch.core.vecmath import safe_inv_dir as _safe_inv
from tpurt_torch.render.intersectors import Hit

EPS_DENOM = 1e-12
BIG = 3.4e38
DEAD_KEY = 0xFFFFFFFF
PACKET = 2048  # rays per counter group (the reference's packet width)


def _expand_bits7(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 7 bits so there are 2 zero bits between each."""
    v = v.to(torch.int64)
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _quantize(x: torch.Tensor, levels: int) -> torch.Tensor:
    """min(trunc(x * levels), levels - 1) for x in [0, 1], as int64."""
    return torch.clamp((x * float(levels)).to(torch.int64), max=levels - 1)


def _ray_sort_keys(org, dirn, t_max_vec, scene_lo, scene_hi):
    """Origin-major, direction-minor coherence keys: 18-bit Morton of the
    origin (quantized to the scene box) above a 12-bit Morton of the
    direction. Dead rays (t_max < 0) get the max key."""
    ext = torch.clamp_min(scene_hi - scene_lo, 1e-12)
    q = torch.clamp((org - scene_lo) / ext, 0.0, 1.0)
    g = _quantize(q, 64)
    morton_o = ((_expand_bits7(g[:, 0]) << 2)
                | (_expand_bits7(g[:, 1]) << 1)
                | _expand_bits7(g[:, 2]))  # 18 bits
    d = torch.clamp(dirn * 0.5 + 0.5, 0.0, 1.0)
    gd = _quantize(d, 16)
    morton_d = ((_expand_bits7(gd[:, 0]) << 2)
                | (_expand_bits7(gd[:, 1]) << 1)
                | _expand_bits7(gd[:, 2]))  # 12 bits
    key = (morton_o << 12) | morton_d
    return torch.where(t_max_vec < 0.0, torch.full_like(key, DEAD_KEY), key)


def _octant_partition(dirn, t_max_vec):
    """Stable 9-bin partition by direction octant (x sign the high bit),
    dead rays in the trailing bin. Returns (perm, pos): ``perm`` gathers
    rays into partitioned order, ``pos`` is its inverse."""
    octant = ((dirn[:, 0] >= 0).to(torch.int64) * 4
              + (dirn[:, 1] >= 0).to(torch.int64) * 2
              + (dirn[:, 2] >= 0).to(torch.int64))
    bins = torch.where(t_max_vec < 0.0, 8, octant)
    perm = torch.sort(bins, stable=True).indices
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, pos


# --------------------------------------------------------------------------
# K5: the per-ray skip-link walk
# --------------------------------------------------------------------------


def packet_plain(tables, org, dirn, tmax, any_hit: bool):
    """Plain PyTorch version of the walk: every live ray advances one node
    per step, in the kernel's op order (box test ``bmin·iv − o·iv``, far
    limit the ray's best t; a leaf's rows in order, each row's first
    candidate at the minimal t against the best with strict '<').
    ``tables`` = (bminx, bminy, bminz, bmaxx, bmaxy, bmaxz, first, count,
    skip, tri_rows[, packed nodes]); the ray count is a multiple of
    PACKET. Returns (bt, bu, bv, bs, (G, 2) f32 counters: node steps, leaf
    rows)."""
    from tpurt_torch.kernels.tilewave import _row_tests

    (bminx, bminy, bminz, bmaxx, bmaxy, bmaxz, first, count, skip,
     tri_rows) = tables[:10]
    n_nodes = first.shape[0]
    dev = org.device
    n = org.shape[0]
    iv = _safe_inv(dirn)
    oi = org * iv
    bt = torch.where(tmax >= 0.0, tmax, -1.0)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    bs = torch.full_like(bu, -1.0)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    steps = torch.zeros(n, dtype=torch.int64, device=dev)
    rows = torch.zeros_like(steps)
    idx = torch.arange(n, device=dev)  # rays still walking
    while idx.numel():
        nd = node[idx]
        ivr, oir = iv[idx], oi[idx]

        def slab(lo, hi, ax):
            return lo[nd] * ivr[:, ax] - oir[:, ax], \
                hi[nd] * ivr[:, ax] - oir[:, ax]

        t0x, t1x = slab(bminx, bmaxx, 0)
        t0y, t1y = slab(bminy, bmaxy, 1)
        t0z, t1z = slab(bminz, bmaxz, 2)
        tn = torch.maximum(
            torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
            torch.clamp_min(torch.minimum(t0z, t1z), 0.0))
        tf = torch.minimum(
            torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
            torch.minimum(torch.maximum(t0z, t1z), bt[idx]))
        hit = tn <= tf
        cnt = count[nd].to(torch.int64)
        leaf = hit & (cnt > 0)
        steps[idx] += 1
        rows[idx] += torch.where(leaf, cnt, 0)
        li, lc = idx[leaf], cnt[leaf]
        lf = first[nd[leaf]].to(torch.int64)
        for r in range(int(lc.max()) if li.numel() else 0):
            sel = r < lc
            ri = li[sel]
            t, u, v, sl, ok = _row_tests(tri_rows[lf[sel] + r], org[ri],
                                         dirn[ri], None, False)
            tc = torch.where(ok, t, BIG)
            j = torch.argmin(tc, dim=1, keepdim=True)  # first at the min
            rt = tc.gather(1, j)[:, 0]
            win = rt < bt[ri]
            wi = ri[win]
            bs[wi] = sl.gather(1, j)[:, 0][win]
            if any_hit:
                bt[wi] = -1.0
                continue
            bt[wi] = rt[win]
            bu[wi] = u.gather(1, j)[:, 0][win]
            bv[wi] = v.gather(1, j)[:, 0][win]
        node[idx] = torch.where(hit & (cnt == 0), nd + 1,
                                skip[nd].to(torch.int64))
        walking = node[idx] < n_nodes
        if any_hit:
            walking &= bt[idx] >= 0.0
        idx = idx[walking]
    if any_hit:
        bt = torch.where(bs >= 0.0, 0.0, BIG)
    stats = torch.stack([steps.reshape(-1, PACKET).sum(dim=1),
                         rows.reshape(-1, PACKET).sum(dim=1)], dim=1)
    return bt, bu, bv, bs, stats.to(torch.float32)


COUNT_BITS = 8  # packed node word 7: first << COUNT_BITS | count


def pack_nodes(tables):
    """The node tables of ``tables`` (bminx … skip) as K5 reads them:
    (n_nodes, 8) f32, per node bmin.xyz, skip, bmax.xyz, first <<
    COUNT_BITS | count, the ints as their bit patterns. Raises where a
    leaf's row count or first row does not fit its bits."""
    (bminx, bminy, bminz, bmaxx, bmaxy, bmaxz, first, count,
     skip) = tables[:9]
    if first.numel() and (int(count.max()) >= 1 << COUNT_BITS
                          or int(count.min()) < 0 or int(first.min()) < 0
                          or int(first.max()) >= 1 << (31 - COUNT_BITS)):
        raise ValueError("packet BVH nodes do not fit the packed word: "
                         f"counts up to {int(count.max())} (< "
                         f"{1 << COUNT_BITS}), first rows up to "
                         f"{int(first.max())} (< {1 << (31 - COUNT_BITS)})")
    bits = lambda x: x.to(torch.int32).view(torch.float32)
    fc = (first.to(torch.int32) << COUNT_BITS) | count.to(torch.int32)
    return torch.stack([bminx, bminy, bminz, bits(skip), bmaxx, bmaxy,
                        bmaxz, bits(fc)], dim=1).contiguous()


def packet_tables(accel):
    """The walk's tables of a PacketAccel of tensors: the ten of
    ``packet_plain`` and the packed nodes K5 reads."""
    tables = tuple(accel[:10])
    return tables + (pack_nodes(tables),)


def _check_tables(tables, dev):
    from tpurt_torch.kernels.tilewave import _check

    f32, i32 = torch.float32, torch.int32
    n_nodes = tables[6].shape[0]
    for k, name in enumerate(("bminx", "bminy", "bminz", "bmaxx", "bmaxy",
                              "bmaxz")):
        _check(name, tables[k], f32, (n_nodes,), dev)
    for k, name in ((6, "first"), (7, "count"), (8, "skip")):
        _check(name, tables[k], i32, (n_nodes,), dev)
    _check("tri_rows", tables[9], f32, (tables[9].shape[0], 128), dev)
    return n_nodes


def packet_cuda(tables, org, dirn, tmax, any_hit: bool):
    """Launch the CUDA walk (csrc/packet.cu) on the current stream over
    ``packet_tables``' packed nodes. Returns (bt, bu, bv, bs, (G, 2) f32
    counters)."""
    from tpurt_torch.kernels.tilewave import _check

    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"packet_cuda needs CUDA tensors, got {dev}")
    n = org.shape[0]
    if n % PACKET:
        raise ValueError(f"ray count {n} is not a multiple of {PACKET}")
    if len(tables) != 11:
        raise ValueError("packet_cuda takes packet_tables(accel): the "
                         "tables and the packed nodes")
    f32 = torch.float32
    _check("org", org, f32, (n, 3), dev)
    _check("dirn", dirn, f32, (n, 3), dev)
    _check("tmax", tmax, f32, (n,), dev)
    n_nodes = _check_tables(tables, dev)
    nodes = tables[10]
    _check("nodes", nodes, f32, (n_nodes, 8), dev)
    if nodes.data_ptr() % 16:
        raise ValueError("the packed nodes must be 16-byte aligned")
    out = torch.empty((4, n), dtype=f32, device=dev)
    stats = torch.zeros((n // PACKET, 2), dtype=torch.int32, device=dev)
    kernels.launch(
        "packet", dev, nodes.data_ptr(), n_nodes, tables[9].data_ptr(),
        org.data_ptr(), dirn.data_ptr(), tmax.data_ptr(), n,
        int(bool(any_hit)), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), out[3].data_ptr(), stats.data_ptr(), work=n > 0)
    return (*out, stats.to(f32))


def packet(tables, org, dirn, tmax, any_hit: bool):
    """K5 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = packet_plain if org.device.type == "cpu" else packet_cuda
    return fn(tables, org, dirn, tmax, any_hit)


# --------------------------------------------------------------------------
# the intersector
# --------------------------------------------------------------------------


def _trace(org, dirn, t_max_vec, tables, *, any_hit: bool, ray_sort: str):
    """Optional coherence reorder ("octant" partition or "morton" argsort
    over the root box), padding to whole 2048-ray groups (dead rays), the
    walk, and the restore to the caller's order. Returns (bt, bu, bv, bs,
    (G, 2) counters)."""
    n = org.shape[0]
    dev = org.device
    padded = max(1, math.ceil(n / PACKET)) * PACKET
    pos = None
    if ray_sort and ray_sort != "none" and n > PACKET:
        if ray_sort == "octant":
            perm, pos = _octant_partition(dirn, t_max_vec)
        else:  # "morton": origin × direction Morton argsort
            scene_lo = torch.stack([tables[0][0], tables[1][0],
                                    tables[2][0]])
            scene_hi = torch.stack([tables[3][0], tables[4][0],
                                    tables[5][0]])
            keys = _ray_sort_keys(org, dirn, t_max_vec, scene_lo, scene_hi)
            perm = torch.sort(keys, stable=True).indices
            pos = torch.empty_like(perm)
            pos[perm] = torch.arange(n, device=dev)
        org, dirn, t_max_vec = org[perm], dirn[perm], t_max_vec[perm]
    if padded != n:
        pad = padded - n
        org = torch.cat([org, torch.zeros((pad, 3), device=dev)])
        dirn = torch.cat([dirn, torch.ones((pad, 3), device=dev)])
        t_max_vec = torch.cat([t_max_vec,
                               torch.full((pad,), -1.0, device=dev)])
    *out, stats = packet(tables, org.contiguous(), dirn.contiguous(),
                         t_max_vec.contiguous(), any_hit)
    out = [f[:n] for f in out]
    if pos is not None:
        out = [f[pos] for f in out]
    return (*out, stats)


def make_packet_intersector(ds, accel, *, ray_sort: str = "octant"):
    """Closest/any-hit pair over the packet BVH (same interface as
    ``make_brute_force``); ``accel`` is a PacketAccel of tensors on the
    rays' device. Hit.tri/Hit.inst are the real ids (from prim_tri /
    prim_inst); the packet path has no lean mode.

    The closures carry no ``with_stats``: the walk has no pair budget and
    nothing to overflow. ``closest.traversal_stats(org, dirn, t_min,
    t_max)`` returns (Hit, (G, 2) counters: per 2048-ray group, the summed
    node steps and leaf rows of its rays' walks)."""
    del ds
    if ray_sort not in ("none", "octant", "morton"):
        raise ValueError(f"packet ray sort {ray_sort!r}")
    tables = packet_tables(accel)
    prim_tri = accel.prim_tri
    prim_inst = accel.prim_inst
    n_prims = prim_tri.shape[0]

    def _tmax_vec(org, t_max):
        tm = torch.as_tensor(t_max, dtype=torch.float32,
                             device=org.device).expand(org.shape[0])
        return torch.where(torch.isfinite(tm), tm, BIG)

    def _hit_from(bt, bu, bv, bs):
        slot = bs.to(torch.int32)
        valid = slot >= 0
        slot_c = torch.clamp(slot, 0, n_prims - 1).long()
        return Hit(
            t=torch.where(valid, bt, math.inf), u=bu, v=bv,
            tri=prim_tri[slot_c], inst=prim_inst[slot_c], valid=valid,
            slot=torch.where(valid, slot_c.to(torch.int32), -1),
        )

    def traversal_stats(org, dirn, t_min, t_max):
        del t_min  # bounce origins are offset; the walk uses t > 0
        bt, bu, bv, bs, stats = _trace(org, dirn, _tmax_vec(org, t_max),
                                       tables, any_hit=False,
                                       ray_sort=ray_sort)
        return _hit_from(bt, bu, bv, bs), stats

    def closest(org, dirn, t_min, t_max) -> Hit:
        return traversal_stats(org, dirn, t_min, t_max)[0]

    def any_hit(org, dirn, t_min, t_max) -> torch.Tensor:
        del t_min
        bs = _trace(org, dirn, _tmax_vec(org, t_max), tables, any_hit=True,
                    ray_sort=ray_sort)[3]
        return bs >= 0.0

    closest.traversal_stats = traversal_stats
    return closest, any_hit
