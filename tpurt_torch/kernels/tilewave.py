"""Tile-wavefront traversal — port of ``tpurt.kernels.tilewave``
(``make_tile_intersector``).

A wave of rays is cut into 1024-ray tiles. Each tile gets the clusters
some ray of the tile may hit, as entry words ``(tn_q << 16) | cluster``
keyed by a floor-quantized lower bound of their slab entry distance, and a
traversal kernel tests the clusters' triangles against the tile's rays:

  1. bounce and shadow waves are octant-sorted (direction sign first,
     origin Morton second; ``raysort``, on the card ``csrc/raysort.cu``)
     so tiles are coherent, and their entries come
     from the exact per-ray slab reduction (K2 ``exact_entries``, or K3
     ``exact_mask`` unpacked); primary waves keep the screen-tile order
     and take their entries from the conservative interval-frustum mask
     ``_tile_mask``;
  2. each tile's entries are sorted front to back (``torch.sort`` along
     the cluster axis);
  3. the traversal loop (K1, ``tileloop``) walks them per tile,
     closest-hit or lean any-hit, with a far break;
  4. results are un-permuted to the caller's ray order.

The reference's switches ``TPURT_EXACT_MASK``, ``TPURT_FUSED_ENTRIES``
and ``TPURT_SUPERCLUSTER`` change step 1 and the mode below as they do
there (``make_tile_intersector``).

Modes, picked per wave as the reference picks them (its
``_entry_rows_enabled`` gate and launch sizing, ported as the rule for
choosing a mode):

  - all-pairs: scenes of at most 8 clusters walk every cluster (the row
    [0, …, C−1] with scale 0, the reference's ``off``/``pair_cl`` list
    with ``off = arange·C`` laid out as rows; no clamp);
  - entry rows (``TPURT_PAIR_LOOP`` on, the default): one launch over the
    wave, entries per cluster, or per supercluster where the accel has
    them, no clamp is set and either C ≥ SC_AUTO_MIN_CLUSTERS or the
    cluster slab fails the gate; a per-tile clamp (``pairs_per_tile``)
    keeps each tile's first ``min(pairs_per_tile − 1, C)`` hit clusters
    in cluster order and flags the overflow in stats[1];
  - pair segments (K1's ``off``/``pair_cl`` mode, ``tileloop_seg``): where
    the gate fails (``TPURT_ENTRY_ROWS=0``, more than 4096 clusters, or a
    (T, Cp) slab over 48 MB; a 256-tile chunk that passes the gate still
    takes entry rows, as in the reference), 256-tile chunks whose clamped
    entries go into one tile-major list of capacity ``pcap``
    (``pairs_avg_cap`` per tile, at most 96 K pairs); a longer list is
    cut and flagged;
  - grid over pairs (K4, ``tilegrid``, ``TPURT_PAIR_LOOP=0``): the
    interval mask on every wave, clamped per tile in cluster order, one
    sentinel pair per tile, chunks of ``96 K // pairs_avg`` tiles with a
    capacity of ``pairs_avg`` per tile (per wave kind); no far break.

The chunks are the reference's launch sizing (its launches bound SMEM):
they fix the capacities, cuts and overflow flags. Their lists are laid
end to end and one launch walks the whole wave, since a launch of 256
1024-ray blocks fills the card once and then waits for its slowest tile.

A two-level accel transforms the ray into each instance-cluster's object
space inside K1 and K4 and reports the hit instance. The kernels are
hand-written CUDA (``tpurt_torch/csrc``: K2 and K3 in ``entries.cu``, K1
and K4 in ``tileloop.cu``) launched by the ``*_cuda`` functions; the
``*_plain`` functions are their plain PyTorch versions. The dispatching
wrappers take the plain version only for CPU tensors: a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from tpurt_torch import kernels
from tpurt_torch.bvh.paircluster import ROWS_PER_CLUSTER, SC_SIZE
from tpurt_torch.core.vecmath import safe_inv_dir as _safe_inv
from tpurt_torch.kernels.packet import BIG, DEAD_KEY, EPS_DENOM, \
    _expand_bits7, _quantize
from tpurt_torch.render.intersectors import Hit
from tpurt_torch.utils import profiling

TILE = 1024  # rays per tile (= threads per traversal block)
LANES = 128  # entry-slab columns pad to a multiple of this
INT32_MAX = 2 ** 31 - 1
TN_LEVELS = 32766  # largest quantized entry distance
# scenes with at most this many clusters take the all-pairs row (every
# tile walks every cluster; no sort, no entry build)
ALLPAIRS_MAX_CLUSTERS = 8
# accels with superclusters and at least this many clusters build their
# entry rows over the superboxes (the reference's auto rule; its second
# trigger is the entry-row gate below)
SC_AUTO_MIN_CLUSTERS = 2000
# The reference's rule for choosing between entry rows and pair lists,
# kept as its rule (the numbers are its TPU's VMEM and SMEM budgets, not a
# limit of this card): entry rows while the scene has at most 4096
# clusters and the (tiles + 8) × Cp i32 slab fits 48 MB; else 256-tile
# pair-segment launches of at most 96 K pairs, or, without the pair loop,
# grid launches of at most 96 K pairs.
ENTRY_ROWS_MAX_CLUSTERS = 4096
ENTRY_VMEM_BYTES = 48 * 1024 * 1024
ENTRY_GROUP = 8
TILES_PER_LAUNCH = 256
MAX_PAIRS_PER_LAUNCH = 96 * 1024


def _entry_rows_enabled(n_clusters: int, n_tiles: int = 0) -> bool:
    """Whether a wave of ``n_tiles`` tiles takes entry rows:
    ``TPURT_ENTRY_ROWS=1``/``0`` force it, "auto" (the default) applies
    the reference's gate."""
    v = os.environ.get("TPURT_ENTRY_ROWS", "auto")
    if v != "auto":
        return v == "1"
    if n_clusters > ENTRY_ROWS_MAX_CLUSTERS:
        return False
    return (n_tiles + ENTRY_GROUP) * _padded_lanes(n_clusters) * 4 \
        <= ENTRY_VMEM_BYTES


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


# the CUDA devices K2 or K3 has launched on: their ray counters
# (``slab_ray_counts``) keep counting on graph replays, so none is dropped
_SLAB_DEVICES: set = set()


def _slab_rays(reset: bool):
    """Read or clear the kernels' device-side ray counters, after the
    work queued on each device's current stream (both synchronize);
    returns the sums read, (K2 slots, K2 live, K3 slots, K3 live)."""
    import ctypes

    from tpurt_torch.kernels import _stream, cuda_build

    total = [0, 0, 0, 0]
    if not _SLAB_DEVICES:
        return total
    lib = cuda_build.load().lib
    for index in sorted(_SLAB_DEVICES):
        dev = torch.device("cuda", index)
        with torch.cuda.device(dev):
            if reset:
                err = lib.tpurt_slab_rays_reset(_stream(dev))
            else:
                got = (ctypes.c_ulonglong * 4)()
                err = lib.tpurt_slab_rays(got, _stream(dev))
                total = [a + b for a, b in zip(total, got)]
        if err:
            raise RuntimeError(f"slab ray counters: cudaError {err}")
    return total


def slab_ray_counts() -> dict:
    """The ray slots K2 and K3 were launched over and the live rays
    (tmax >= 0) among them, since the last reset: ``{"entries": (slots,
    live), "exact_mask": (slots, live)}``. The kernels count on the card,
    once a tile, graph replays included; reading them synchronizes. The
    plain versions count nothing."""
    k2_slots, k2_live, k3_slots, k3_live = _slab_rays(reset=False)
    return {"entries": (k2_slots, k2_live),
            "exact_mask": (k3_slots, k3_live)}


def entries_cuda(org, inv_d, tmax, lo, hi, scale: float):
    """Launch the CUDA entry-build kernel (csrc/entries.cu) on the
    current stream. Returns the unsorted (T, cp) int32 slab."""
    dev, n_tiles, n_c, cp = _slab_args("entries_cuda", org, inv_d, tmax, lo,
                                       hi)
    out = torch.empty((n_tiles, cp), dtype=torch.int32, device=dev)
    kernels.launch("entries", dev, org.data_ptr(), inv_d.data_ptr(),
                   tmax.data_ptr(), lo.data_ptr(), hi.data_ptr(), n_tiles,
                   n_c, cp, scale, out.data_ptr(), work=n_tiles > 0)
    if n_tiles:
        _SLAB_DEVICES.add(dev.index)
    return out


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
    dev, n_tiles, n_c, cp = _slab_args("exact_mask_cuda", org, inv_d, tmax,
                                       lo, hi)
    mask = torch.empty((n_tiles, n_c), dtype=torch.bool, device=dev)
    tn = torch.empty((n_tiles, n_c), dtype=torch.float32, device=dev)
    kernels.launch("exact_mask", dev, org.data_ptr(), inv_d.data_ptr(),
                   tmax.data_ptr(), lo.data_ptr(), hi.data_ptr(), n_tiles,
                   n_c, cp, mask.data_ptr(), tn.data_ptr(),
                   work=n_tiles > 0)
    if n_tiles:
        _SLAB_DEVICES.add(dev.index)
    return mask, tn


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
                   inv_xform=None, sc_meta=None, exact_boxes: bool = False):
    """Plain PyTorch version of the traversal loop.

    Per ray, every triangle of every cluster in its tile's live entries is
    a candidate; the closest variant keeps the minimal t below tmax with
    ties going to the earliest (entry, row, lane), which is what the
    kernel's strict-'<' fold in that order gives; the lean any-hit
    variant ORs the division-free window test. The far break and the box
    tests only prune, so this version replaces them with conservative
    per-ray box tests (``_slab_pass``) and ignores ``scale``.

    ``exact_boxes``: prune as the kernel does instead, so that a box face
    a triangle lies on decides as it does there. A ray enters an entry
    only while its quantized distance ``(e >> 16) * scale`` is not above
    the ray's best t, tests the cluster box and then each row's sub-box
    unpadded, in the kernel's op order (``_box_interval``), far-limited
    by its best t at that point of the walk (the entry's start, the
    cluster's start, the row's start), and folds each row's 12 tests
    with strict '<' against that best t. The walk's order matters here,
    so the closest variant replays it (``_walk_rounds``).

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
    scale_t = torch.tensor(scale, dtype=torch.float32, device=dev)
    for a in range(0, n_tiles, tiles_per_chunk):
        b = min(a + tiles_per_chunk, n_tiles)
        ent = entries[a:b, :p_all].to(torch.int64)
        live_e = lanes[None, :] < counts[a:b, None]
        eid = torch.where(live_e, ent & 0xFFFF, 0)  # (Tc, P)
        deq = (ent >> 16).to(torch.float32) * scale_t
        if sc_meta is not None:
            mv = sc_meta[eid].to(torch.int64)
            first = mv & 0xFFFF
            live_u = live_e[..., None] & (child < (mv >> 16)[..., None])
            cl = torch.where(live_u, first[..., None] + child, 0)
            xcl = first[..., None].expand_as(cl)  # the transform's cluster
            deq = deq[..., None].expand_as(cl)
            live_u, cl, xcl, deq = (x.reshape(b - a, n_units)
                                    for x in (live_u, cl, xcl, deq))
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
        if exact_boxes:
            # a best t never rises above tmax, so every unit and row the
            # walk tests passes these tests at tmax
            ctn, ctf = _box_interval(o, iv, b_lo[blk][:, None],
                                     b_hi[blk][:, None])
            pair = (ctn <= torch.minimum(ctf, tm)) & (deq[:, None, :] <= tm)
        else:
            pair = _slab_pass(o, iv, b_lo[blk][:, None], b_hi[blk][:, None],
                              tm)
        pair = pair & (tm >= 0.0) & live_u[:, None, :]
        ti, ri, ui = torch.nonzero(pair, as_tuple=True)
        ray = ray0 + ti * TILE + ri  # global ray ids of the pairs
        pc = blk[ti, ui]
        po, pd, piv = org[ray], dirn[ray], inv_d[ray]
        if two_level:
            px = xcl[ti, ui]
            po, pd = _to_object(po, pd, inv_xform[px])
            piv = _safe_inv(pd)
            inst_f = (meta[px] >> 20).to(torch.float32)
        rb = row_box[pc]  # (M, 8, 6)
        if exact_boxes:
            rtn, rtf = _box_interval(po[:, None], piv[:, None], rb[..., 0:3],
                                     rb[..., 3:6])
            rpass = rtn <= torch.minimum(rtf, tmax[ray][:, None])
        else:
            rpass = _slab_pass(po[:, None], _safe_inv(pd)[:, None],
                               rb[..., 0:3], rb[..., 3:6], tmax[ray][:, None])
        mi, row = torch.nonzero(rpass, as_tuple=True)
        walk = []  # exact closest: the rows that may win, in walk order
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
            if exact_boxes:
                # the row's fold: its first candidate at the minimal t
                tc = torch.where(ok, t, math.inf)
                j = torch.argmin(tc, dim=1, keepdim=True)
                rt = tc.gather(1, j)[:, 0]
                k = rt < tmax[rg]
                um = ui[m][k]
                walk.append((
                    rg[k], um * ROWS_PER_CLUSTER + rr[k], um, um // kids,
                    deq[ti[m][k], um], ctn[ti[m][k], ri[m][k], um],
                    rtn[m, rr][k], rt[k], u.gather(1, j)[k, 0],
                    v.gather(1, j)[k, 0], sl.gather(1, j)[k, 0],
                    inst_f[m][k] if two_level else None))
                continue
            key = ((ui[m] * 96 + rr * 12)[:, None]
                   + torch.arange(12, device=dev)[None, :])
            ok = ok & (t < tmax[rg][:, None])
            k_i, j_i = torch.nonzero(ok, as_tuple=True)
            _merge_closest(
                rg[k_i], t[k_i, j_i], key[k_i, j_i], u[k_i, j_i],
                v[k_i, j_i], sl[k_i, j_i], bt, best_k, bu, bv, bs,
                inst_f[m][k_i] if two_level else None, bi)
        if walk:
            _walk_rounds([None if f[0] is None else torch.cat(f)
                          for f in zip(*walk)], bt, bu, bv, bs, bi)
    return result()


def _walk_rounds(cand, bt, bu, bv, bs, bi=None):
    """Replay each ray's closest walk over its candidate rows, in place.

    ``cand`` = (ray, key, unit, entry, deq, cluster tn, row tn, t, u, v,
    slot, inst or None): one row per element whose first candidate at the
    minimal t is t, with the slab entry distances of its unit's cluster
    box and of its own sub-box (``_box_interval``), ``key`` its place in
    the walk (unit · 8 + row). Each round every ray takes its next winning
    row: the first after its last win whose t is below its best t and
    which the walk tests at that best t — the entry's quantized distance
    is checked when the walk enters the entry, the cluster box when it
    enters the cluster, so neither is checked again for a row of the
    entry or cluster of the last win."""
    (ray, key, unit, entry, deq, ctn, rtn, t, u, v, sl, inst) = cand
    n = bt.shape[0]
    none = torch.full((n,), -1, dtype=torch.int64, device=bt.device)
    last, last_unit, last_entry = none, none.clone(), none.clone()
    while ray.numel():
        b = bt[ray]
        test = ((t < b) & (rtn <= b)
                & ((unit == last_unit[ray]) | (ctn <= b))
                & ((entry == last_entry[ray]) | (deq <= b)))
        if not bool(test.any()):
            return
        first = torch.full((n,), 2 ** 62, dtype=torch.int64,
                           device=bt.device)
        first = first.scatter_reduce(0, ray[test], key[test], "amin")
        win = test & (key == first[ray])
        w = ray[win]
        bt[w], bu[w], bv[w], bs[w] = t[win], u[win], v[win], sl[win]
        if inst is not None:
            bi[w] = inst[win]
        last[w], last_unit[w], last_entry[w] = key[win], unit[win], entry[win]
        # a row before a ray's last win, or at or above its best t, never
        # wins later: its best t only falls
        keep = (key > last[ray]) & (t < bt[ray])
        ray, key, unit, entry, deq, ctn, rtn, t, u, v, sl = (
            x[keep] for x in (ray, key, unit, entry, deq, ctn, rtn, t, u, v,
                              sl))
        if inst is not None:
            inst = inst[keep]


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


def _box_interval(o, iv, lo, hi):
    """The kernel's slab interval (``box_reachable``) in its op order, no
    padding and no far limit: (tn, tf), and the box (lo, hi) is entered
    at or before ``far`` exactly when tn <= min(tf, far)."""
    t0 = (lo - o) * iv
    t1 = (hi - o) * iv
    mn, mx = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(mn[..., 0], mn[..., 1]),
                       torch.clamp_min(mn[..., 2], 0.0))
    tf = torch.minimum(torch.minimum(mx[..., 0], mx[..., 1]), mx[..., 2])
    return tn, tf


def _box_exact(o, iv, lo, hi, far):
    """The kernel's slab test: the box (lo, hi) is entered at or before
    ``far``."""
    tn, tf = _box_interval(o, iv, lo, hi)
    return tn <= torch.minimum(tf, far)


def tileloop_work_plain(org, dirn, inv_d, tmax, tri_rows, entries, counts,
                        scale: float, any_hit: bool, bt=None, bs=None,
                        bi=None, pair_meta=None, inv_xform=None,
                        sc_meta=None):
    """The work K1's front-to-back walk over these entries cannot avoid,
    per ray: (box tests, row tests), int64 each.

    A ray's walk ends at its final best t F: for the closest walk the
    result's ``bt`` (with ``bs`` and, two-level, ``bi`` naming the hit),
    for the lean any-hit walk ``tmax`` up to its first occluding row in
    (entry, child, row) order, found here with the kernel's window test.
    Box tests: the walk's units (an entry, or each child of a supercluster
    entry) whose quantized distance ``(e >> 16) * scale`` is at most F —
    the cluster box pre-test, 28 operations each. Row tests: the rows of
    those units whose cluster box and sub-box the ray enters at or before
    F (the kernel's slab arithmetic, object space for a two-level accel),
    each a sub-box test and 12 Möller–Trumbore tests, and the row of the
    closest hit, which a rounding at a box face may leave out of that
    test. Any-hit counts nothing after the first occluding row. Dead rays
    (tmax < 0) count nothing. Arguments as ``tileloop_plain``."""
    dev = org.device
    n = org.shape[0]
    n_tiles = entries.shape[0]
    two_level = pair_meta is not None
    kids = SC_SIZE if sc_meta is not None else 1
    boxes = torch.zeros(n, dtype=torch.int64, device=dev)
    rows_n = torch.zeros(n, dtype=torch.int64, device=dev)
    alive = tmax >= 0.0
    if any_hit:
        far_all = torch.where(alive, tmax, -1.0)
    else:
        far_all = torch.where(alive, bt, -1.0)
    p_all = int(counts.max()) if n_tiles else 0
    if p_all == 0:
        return boxes, rows_n
    blocks = tri_rows.reshape(-1, ROWS_PER_CLUSTER, 128)
    b_lo = torch.stack([blocks[:, 0, 126], blocks[:, 0, 127],
                        blocks[:, 1, 126]], dim=-1)
    b_hi = torch.stack([blocks[:, 1, 127], blocks[:, 2, 126],
                        blocks[:, 2, 127]], dim=-1)
    row_box = blocks[..., 120:126].contiguous()
    meta = pair_meta.to(torch.int64) if two_level else None
    if not any_hit:
        # the hit's row: the first row holding its slot id (slot ids are
        # unique over the real triangles, mesh slots in a two-level accel,
        # whose instance then names the cluster; all-zero padding rows,
        # which never hit, read slot 0, whose real row is the first)
        slots = tri_rows[:, 9:120:10]
        valid = slots >= 0
        row_ids = torch.arange(tri_rows.shape[0], device=dev)[:, None]
        row_of_slot = torch.full((int(slots.max()) + 2,), 2 ** 62,
                                 dtype=torch.int64, device=dev)
        row_of_slot = row_of_slot.scatter_reduce(
            0, slots[valid].to(torch.int64), row_ids.expand_as(slots)[valid],
            "amin")
        hit = alive & (bs >= 0)
        hit_row = torch.where(hit, row_of_slot[torch.clamp_min(
            bs, 0).to(torch.int64)], -1)
    n_units = p_all * kids
    budget = 1 << (26 if dev.type == "cuda" else 22)
    tiles_per_chunk = max(1, budget // (TILE * n_units))
    lanes = torch.arange(p_all, device=dev)
    child = torch.arange(kids, device=dev)
    scale_t = torch.tensor(scale, dtype=torch.float32, device=dev)
    for a in range(0, n_tiles, tiles_per_chunk):
        b = min(a + tiles_per_chunk, n_tiles)
        ent = entries[a:b, :p_all].to(torch.int64)
        live_e = lanes[None, :] < counts[a:b, None]
        eid = torch.where(live_e, ent & 0xFFFF, 0)
        deq = (ent >> 16).to(torch.float32) * scale_t
        if sc_meta is not None:
            mv = sc_meta[eid].to(torch.int64)
            first = mv & 0xFFFF
            live_u = live_e[..., None] & (child < (mv >> 16)[..., None])
            cl = torch.where(live_u, first[..., None] + child, 0)
            xcl = first[..., None].expand_as(cl)
            deq = deq[..., None].expand_as(cl)
            live_u, cl, xcl, deq = (x.reshape(b - a, n_units)
                                    for x in (live_u, cl, xcl, deq))
        else:
            live_u, cl, xcl = live_e, eid, eid
        blk = (meta[cl] & 0xFFFFF) // ROWS_PER_CLUSTER if two_level else cl
        ray0, ray1 = a * TILE, b * TILE
        far = far_all[ray0:ray1].reshape(b - a, TILE, 1)
        o = org[ray0:ray1].reshape(b - a, TILE, 1, 3)
        d = dirn[ray0:ray1].reshape(b - a, TILE, 1, 3)
        iv = inv_d[ray0:ray1].reshape(b - a, TILE, 1, 3)
        if two_level:
            o, d = _to_object(o, d, inv_xform[xcl][:, None])
            iv = _safe_inv(d)
        # (tile, ray, unit): the units the walk reaches
        cand = live_u[:, None, :] & (deq[:, None, :] <= far) & (far >= 0.0)
        enter = cand & _box_exact(o, iv, b_lo[blk][:, None],
                                  b_hi[blk][:, None], far)
        if not any_hit:
            hr = hit_row[ray0:ray1].reshape(b - a, TILE, 1)
            own = blk[:, None, :] == torch.div(hr, ROWS_PER_CLUSTER,
                                               rounding_mode="floor")
            if two_level:
                inst = (meta[cl] >> 20).to(torch.float32)
                own = own & (inst[:, None, :]
                             == bi[ray0:ray1].reshape(b - a, TILE, 1))
            enter = enter | (cand & own & (hr >= 0))
        ti, ri, ui = torch.nonzero(enter, as_tuple=True)
        ray = ray0 + ti * TILE + ri
        if two_level:
            po, pd = _to_object(org[ray], dirn[ray], inv_xform[xcl[ti, ui]])
            piv = _safe_inv(pd)
        else:
            po, pd, piv = org[ray], dirn[ray], inv_d[ray]
        rb = row_box[blk[ti, ui]]  # (M, 8, 6)
        rpass = _box_exact(po[:, None], piv[:, None], rb[..., 0:3],
                           rb[..., 3:6], far_all[ray][:, None])
        if not any_hit:
            own_row = (blk[ti, ui] * ROWS_PER_CLUSTER)[:, None] \
                + torch.arange(ROWS_PER_CLUSTER, device=dev)[None, :]
            rpass = rpass | (own[ti, ri, ui][:, None]
                             & (own_row == hit_row[ray][:, None]))
        unit_key = ui[:, None] * ROWS_PER_CLUSTER \
            + torch.arange(ROWS_PER_CLUSTER, device=dev)[None, :]
        if any_hit:
            # the first occluding row of each ray ends its walk
            mi, rr = torch.nonzero(rpass, as_tuple=True)
            occ = _row_tests(blocks[blk[ti[mi], ui[mi]], rr], po[mi], pd[mi],
                             tmax[ray[mi]], True).any(dim=1)
            stop = torch.full(((b - a) * TILE,), 2 ** 62, dtype=torch.int64,
                              device=dev)
            stop = stop.scatter_reduce(0, (ray - ray0)[mi[occ]],
                                       unit_key[mi[occ], rr[occ]], "amin")
            stop_r = stop.reshape(b - a, TILE, 1)
            u_idx = torch.arange(n_units, device=dev)[None, None, :]
            cand = cand & (u_idx * ROWS_PER_CLUSTER <= stop_r)
            rpass = rpass & (unit_key <= stop[ray - ray0][:, None])
        boxes[ray0:ray1] = cand.sum(dim=2).reshape(-1)
        rows_n.index_add_(0, ray, rpass.sum(dim=1))
    return boxes, rows_n


def _variant(pair_meta, sc_meta, scale: float, seg: bool = False) -> str:
    """Launch-count name of a K1 mode: scale 0 is the all-pairs row (its
    entries carry no distance), sc_meta the supercluster entries, seg the
    pair segments, pair_meta the two-level accel."""
    name = "tileloop"
    if pair_meta is not None:
        name += "_tl"
    if sc_meta is not None:
        name += "_sc"
    elif seg:
        name += "_seg"
    elif scale == 0.0:
        name += "_allpairs"
    return name


def _ray_args(name, org, dirn, inv_d, tmax, tri_rows, pair_meta, inv_xform):
    """Checks shared by the K1 and K4 launchers; returns (device,
    n_tiles)."""
    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    n = org.shape[0]
    if n % TILE:
        raise ValueError(f"ray count {n} is not a multiple of {TILE}")
    f32, i32 = torch.float32, torch.int32
    _check("org", org, f32, (n, 3), dev)
    _check("dirn", dirn, f32, (n, 3), dev)
    _check("inv_d", inv_d, f32, (n, 3), dev)
    _check("tmax", tmax, f32, (n,), dev)
    _check("tri_rows", tri_rows, f32, (tri_rows.shape[0], 128), dev)
    if tri_rows.shape[0] % ROWS_PER_CLUSTER:
        raise ValueError("tri_rows must hold whole clusters of 8 rows")
    if (pair_meta is not None) != (inv_xform is not None):
        raise ValueError("pair_meta and inv_xform come together")
    if pair_meta is not None:
        _check("pair_meta", pair_meta, i32, (pair_meta.shape[0],), dev)
        _check("inv_xform", inv_xform, f32, (pair_meta.shape[0], 12), dev)
    return dev, n // TILE


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_tileloop(org, dirn, inv_d, tmax, tri_rows, entries, counts, off,
                     scale, any_hit, pair_meta, inv_xform, sc_meta):
    """One K1 launch on the current stream: entry rows (``counts``) or
    pair segments (``off``)."""
    dev, n_tiles = _ray_args("tileloop_cuda", org, dirn, inv_d, tmax,
                             tri_rows, pair_meta, inv_xform)
    i32 = torch.int32
    seg = off is not None
    if seg:
        if sc_meta is not None:
            raise ValueError("pair segments take cluster entries, not "
                             "superclusters")
        _check("off", off, i32, (n_tiles + 1,), dev)
        _check("pair_cl", entries, i32, (entries.shape[0],), dev)
        cp = 0
    else:
        cp = entries.shape[1]
        _check("entries", entries, i32, (n_tiles, cp), dev)
        _check("counts", counts, i32, (n_tiles,), dev)
    if sc_meta is not None:
        _check("sc_meta", sc_meta, i32, (sc_meta.shape[0],), dev)
    if tri_rows.data_ptr() % 16:
        raise ValueError("tri_rows must be 16-byte aligned (its clusters "
                         "are fetched by bulk copies)")
    two_level = pair_meta is not None
    out = torch.empty((5 if two_level else 4, org.shape[0]),
                      dtype=torch.float32, device=dev)
    kernels.launch(
        _variant(pair_meta, sc_meta, scale, seg), dev, org.data_ptr(),
        dirn.data_ptr(), inv_d.data_ptr(), tmax.data_ptr(),
        tri_rows.data_ptr(), entries.data_ptr(), _ptr(counts), _ptr(off),
        n_tiles, cp, scale, int(bool(any_hit)), _ptr(pair_meta),
        _ptr(inv_xform), _ptr(sc_meta), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), out[3].data_ptr(),
        out[4].data_ptr() if two_level else None, work=n_tiles > 0)
    return tuple(out)


def tileloop_cuda(org, dirn, inv_d, tmax, tri_rows, entries, counts,
                  scale: float, any_hit: bool, pair_meta=None,
                  inv_xform=None, sc_meta=None):
    """Launch the CUDA traversal kernel (csrc/tileloop.cu) on the current
    stream over entry rows: closest-hit, or the lean any-hit variant when
    ``any_hit``; two-level with ``pair_meta``/``inv_xform``, supercluster
    entries with ``sc_meta``. Returns (bt, bu, bv, bs[, bi]) per ray."""
    return _launch_tileloop(org, dirn, inv_d, tmax, tri_rows, entries,
                            counts, None, scale, any_hit, pair_meta,
                            inv_xform, sc_meta)


def tileloop(org, dirn, inv_d, tmax, tri_rows, entries, counts,
             scale: float, any_hit: bool, pair_meta=None, inv_xform=None,
             sc_meta=None):
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    fn = tileloop_plain if org.device.type == "cpu" else tileloop_cuda
    return fn(org, dirn, inv_d, tmax, tri_rows, entries, counts, scale,
              any_hit, pair_meta=pair_meta, inv_xform=inv_xform,
              sc_meta=sc_meta)


def _segments_to_rows(off, pair_cl):
    """Pair segments → entry rows: (T, P) i32 padded with INT32_MAX and
    the (T,) counts."""
    counts = (off[1:] - off[:-1]).to(torch.int32)
    p_max = int(counts.max()) if counts.numel() else 0
    lane = torch.arange(p_max, device=off.device)
    idx = off[:-1, None].to(torch.int64) + lane[None, :]
    live = lane[None, :] < counts[:, None]
    if pair_cl.numel() == 0:
        return torch.full(idx.shape, INT32_MAX, dtype=torch.int32,
                          device=off.device), counts
    rows = torch.where(live, pair_cl[torch.clamp(idx, max=pair_cl.numel()
                                                 - 1)], INT32_MAX)
    return rows.to(torch.int32), counts


def _rows_to_segments(entry, counts, cap=None):
    """Entry rows → pair segments: (off (T + 1,) i32, pair_cl), the first
    counts[t] entries of every row laid end to end in tile order; cut at
    ``cap`` pairs when given (``off`` clamped with it, so the trailing
    tiles lose theirs)."""
    live = (torch.arange(entry.shape[1], device=entry.device)[None, :]
            < counts[:, None])
    pair_cl = entry[live]
    off = torch.cat([torch.zeros(1, dtype=torch.int64, device=entry.device),
                     torch.cumsum(counts, 0, dtype=torch.int64)])
    if cap is not None:
        pair_cl, off = pair_cl[:cap], torch.clamp_max(off, cap)
    return off.to(torch.int32), pair_cl.contiguous()


def tileloop_seg_plain(org, dirn, inv_d, tmax, tri_rows, off, pair_cl,
                       scale: float, any_hit: bool, pair_meta=None,
                       inv_xform=None, exact_boxes: bool = False):
    """Plain PyTorch version of K1's pair-segment mode: tile t walks
    ``pair_cl[off[t]:off[t + 1]]`` — the entry-row plain version over
    those segments laid out as rows (``exact_boxes`` as there)."""
    entries, counts = _segments_to_rows(off, pair_cl)
    return tileloop_plain(org, dirn, inv_d, tmax, tri_rows, entries, counts,
                          scale, any_hit, pair_meta=pair_meta,
                          inv_xform=inv_xform, exact_boxes=exact_boxes)


def tileloop_seg_cuda(org, dirn, inv_d, tmax, tri_rows, off, pair_cl,
                      scale: float, any_hit: bool, pair_meta=None,
                      inv_xform=None):
    """Launch K1 in its pair-segment mode (the ``kSeg`` variant of
    csrc/tileloop.cu) on the current stream. Returns (bt, bu, bv, bs[,
    bi]) per ray."""
    return _launch_tileloop(org, dirn, inv_d, tmax, tri_rows, pair_cl, None,
                            off, scale, any_hit, pair_meta, inv_xform, None)


def tileloop_seg(org, dirn, inv_d, tmax, tri_rows, off, pair_cl,
                 scale: float, any_hit: bool, pair_meta=None,
                 inv_xform=None):
    """K1 pair-segment wrapper: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    fn = (tileloop_seg_plain if org.device.type == "cpu"
          else tileloop_seg_cuda)
    return fn(org, dirn, inv_d, tmax, tri_rows, off, pair_cl, scale,
              any_hit, pair_meta=pair_meta, inv_xform=inv_xform)


# --------------------------------------------------------------------------
# K4: grid over (tile, cluster) pairs
# --------------------------------------------------------------------------


def tilegrid_plain(org, dirn, inv_d, tmax, tri_rows, packed, any_hit: bool,
                   pair_meta=None, inv_xform=None, all_pairs=False,
                   exact_boxes: bool = False):
    """Plain PyTorch version of K4: each tile walks its real pairs of the
    tile-major list ``packed`` (tile << 16 | cluster + 1; sentinels and
    fill slots, cluster −1, skipped) in list order, the closest fold of
    the entry-row plain version without a far break (``exact_boxes`` as
    there). Any-hit waves get the same closest result: the kernel's
    early-out only stops a ray once it is occluded (bs ≥ 0) or dead,
    which changes no ray's occlusion flag, the one field an any-hit
    caller reads. ``all_pairs`` only names the launch. Returns (bt, bu,
    bv, bs[, bi]) per ray."""
    del any_hit, all_pairs
    entries, counts = grid_rows(packed, org.shape[0] // TILE)
    return tileloop_plain(org, dirn, inv_d, tmax, tri_rows, entries, counts,
                          0.0, False, pair_meta=pair_meta,
                          inv_xform=inv_xform, exact_boxes=exact_boxes)


def grid_rows(packed, n_tiles: int):
    """K4's pair list → entry rows: each tile's real pairs (cluster ids,
    no distance bits) in list order, padded with INT32_MAX, and the (T,)
    counts."""
    dev = packed.device
    pk = packed.to(torch.int64)
    cl = (pk & 0xFFFF) - 1
    real = cl >= 0
    tiles, cl = pk[real] >> 16, cl[real]
    counts = torch.bincount(tiles, minlength=n_tiles).to(torch.int32)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(tiles.shape[0], device=dev) - starts[tiles]
    p_max = int(counts.max()) if n_tiles else 0
    entries = torch.full((n_tiles, p_max), INT32_MAX, dtype=torch.int32,
                         device=dev)
    entries[tiles, rank] = cl.to(torch.int32)
    return entries, counts


def tilegrid_cuda(org, dirn, inv_d, tmax, tri_rows, packed, any_hit: bool,
                  pair_meta=None, inv_xform=None, all_pairs=False):
    """Launch the CUDA grid over pairs (K4, the ``kPairs`` variants of
    csrc/tileloop.cu's walk, each tile finding its real pairs in the list
    by binary search) on the current stream: closest-hit, or any-hit,
    where a ray stops at its first hit. ``all_pairs`` (the list holds
    every (tile, cluster) pair) names the launch "tilegrid_allpairs".
    Returns (bt, bu, bv, bs[, bi]) per ray."""
    dev, n_tiles = _ray_args("tilegrid_cuda", org, dirn, inv_d, tmax,
                             tri_rows, pair_meta, inv_xform)
    _check("packed", packed, torch.int32, (packed.shape[0],), dev)
    if tri_rows.data_ptr() % 16:
        raise ValueError("tri_rows must be 16-byte aligned (its clusters "
                         "are fetched by bulk copies)")
    two_level = pair_meta is not None
    out = torch.empty((5 if two_level else 4, org.shape[0]),
                      dtype=torch.float32, device=dev)
    kernels.launch(
        "tilegrid" + ("_tl" if two_level else "")
        + ("_allpairs" if all_pairs else ""), dev, org.data_ptr(),
        dirn.data_ptr(), inv_d.data_ptr(), tmax.data_ptr(),
        tri_rows.data_ptr(), packed.data_ptr(), packed.shape[0], n_tiles,
        int(bool(any_hit)), _ptr(pair_meta), _ptr(inv_xform),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        out[3].data_ptr(), out[4].data_ptr() if two_level else None,
        work=n_tiles > 0)
    return tuple(out)


def tilegrid(org, dirn, inv_d, tmax, tri_rows, packed, any_hit: bool,
             pair_meta=None, inv_xform=None, all_pairs=False):
    """K4 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = tilegrid_plain if org.device.type == "cpu" else tilegrid_cuda
    return fn(org, dirn, inv_d, tmax, tri_rows, packed, any_hit,
              pair_meta=pair_meta, inv_xform=inv_xform, all_pairs=all_pairs)


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
                      any_hit, exact, tl, pairs_per_tile=0, fused=True):
    """One wave through the entry-row path: entry slab over the boxes
    lo/hi (``exact``: the exact slab reduction, else the interval frustum
    mask; unclamped and ``fused``, the exact entries come packed from K2,
    otherwise from the unpacked mask — K3 where exact — clamped per tile
    when ``pairs_per_tile > 0``, then packed), per-row sort, traversal.
    ``tl``: the two-level and supercluster tables for K1. Returns ((bt,
    bu, bv, bs[, bi]), n_pairs, overflow)."""
    n_tiles = org.shape[0] // TILE
    with profiling.step("entries"):
        inv_d = _safe_inv(dirn)
        overflow = torch.zeros((), dtype=torch.bool, device=org.device)
        if exact and fused and pairs_per_tile <= 0:
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
    with profiling.step("sort"):
        entry = torch.sort(entry, dim=1).values  # per-row front-to-back
    with profiling.step("walk"):
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
    with profiling.step("walk"):
        out = tileloop(org, dirn, _safe_inv(dirn), tmv, tri_rows, entry,
                       counts, 0.0, any_hit, **tl)
    return out, torch.full((), float(n_tiles * n_clusters), device=dev)


def _segment_lists(org, dirn, inv_d, tmv, lo, hi, scale, *, exact,
                   pairs_per_tile, pcap):
    """The pair-segment host side of one launch chunk: the exact mask K3
    (sorted waves) or the interval mask (primary waves), the per-tile
    clamp (all clusters kept without one), the entries packed and sorted
    front to back per tile, then laid end to end in tile order as one
    list cut at ``pcap`` pairs (``off`` clamped with it, so the trailing
    tiles lose theirs; flagged). Returns (off, pair_cl, n_pairs,
    overflow)."""
    n_tiles, n_c = org.shape[0] // TILE, lo.shape[0]
    if exact:
        mask, tn = exact_mask(org, inv_d, tmv, lo, hi)
    else:
        mask, tn = _tile_mask(org, dirn, tmv, lo, hi, n_tiles, return_tn=True)
    mask, counts, overflow = _clamp_rows(
        mask, pairs_per_tile if pairs_per_tile > 0 else n_c + 1)
    total = counts.sum(dtype=torch.int64)
    overflow = overflow | (total > pcap)
    entry = _pack_entries(mask, tn, scale)
    with profiling.step("sort"):
        entry = torch.sort(entry, dim=1).values
    off, pair_cl = _rows_to_segments(entry, counts, cap=pcap)
    return off, pair_cl, total.to(torch.float32), overflow


def _wave_segments(org, dirn, inv_d, tmv, lo, hi, scale, chunk_tiles, *,
                   exact, pairs_per_tile, pcap):
    """The pair segments of a whole wave: each launch chunk of
    ``chunk_tiles`` tiles gets its own list at capacity ``pcap`` (the
    reference's launch sizing, its cuts and flags), and the chunks' lists
    are laid end to end for one launch over the wave (the reference's
    chunks bound a launch's SMEM; here the lists live in device memory,
    and one launch keeps the card busy where a 256-tile launch would wait
    for its slowest tile). Returns (off (T + 1,), pair_cl, n_pairs,
    overflow)."""
    n_tiles = org.shape[0] // TILE
    offs, lists, nps, ofs, base = [], [], [], [], 0
    for k in range(0, n_tiles, chunk_tiles):
        c = slice(k * TILE, (k + chunk_tiles) * TILE)
        off, pair_cl, np_, of = _segment_lists(
            org[c], dirn[c], inv_d[c], tmv[c], lo, hi, scale, exact=exact,
            pairs_per_tile=pairs_per_tile, pcap=pcap)
        offs.append(off[:-1] + base)
        lists.append(pair_cl)
        nps.append(np_)
        ofs.append(of)
        base += pair_cl.shape[0]
    offs.append(torch.full((1,), base, dtype=torch.int32, device=org.device))
    return (torch.cat(offs), torch.cat(lists), torch.stack(nps).sum(),
            torch.stack(ofs).any())


def _trace_segments(org, dirn, tmv, lo, hi, tri_rows, scale, chunk_tiles, *,
                    any_hit, exact, tl, pairs_per_tile, pcap):
    """A wave through K1's pair-segment mode (lists from
    ``_wave_segments``), one launch. Returns ((bt, bu, bv, bs[, bi]),
    n_pairs, overflow)."""
    inv_d = _safe_inv(dirn)
    off, pair_cl, n_pairs, overflow = _wave_segments(
        org, dirn, inv_d, tmv, lo, hi, scale, chunk_tiles, exact=exact,
        pairs_per_tile=pairs_per_tile, pcap=pcap)
    out = tileloop_seg(org, dirn, inv_d, tmv, tri_rows, off, pair_cl, scale,
                       any_hit, **tl)
    return out, n_pairs, overflow


def _grid_list(org, dirn, tmv, lo, hi, *, n_clusters, pair_cap,
               per_tile_clamp, all_pairs=False):
    """K4's pair list for one launch chunk, ``pair_cap`` slots, tile-major,
    as the reference builds it: all (tile, cluster) pairs for all-pairs
    scenes; otherwise the interval mask on every wave, clamped per tile to
    ``per_tile_clamp − 1`` clusters in cluster order, the first
    ``pair_cap − T`` survivors in tile-major order (the rest cut and
    flagged), one sentinel per tile merged in before its clusters, fill
    slots (tile T−1, cluster −1) at the end. Returns (packed, n_pairs,
    overflow); n_pairs counts the mask's pairs before the clamp plus the
    sentinels."""
    n_tiles = org.shape[0] // TILE
    dev = org.device
    if all_pairs:
        tiles = torch.arange(n_tiles, device=dev).repeat_interleave(
            n_clusters)
        cl = torch.arange(n_clusters, device=dev).repeat(n_tiles)
        packed = (tiles * 65536 + cl + 1).to(torch.int32)
        n_pairs = torch.full((), float(n_tiles * n_clusters), device=dev)
        return packed, n_pairs, torch.zeros((), dtype=torch.bool, device=dev)
    mask = _tile_mask(org, dirn, tmv, lo, hi, n_tiles)
    n_pairs = (mask.sum(dtype=torch.int64) + n_tiles).to(torch.float32)
    mask, _, overflow = _clamp_rows(mask, per_tile_clamp)
    real_cap = pair_cap - n_tiles
    ridx = torch.nonzero(mask.reshape(-1))[:, 0]
    overflow = overflow | (ridx.shape[0] > real_cap)
    ridx = ridx[:real_cap]
    real_key = torch.full((real_cap,), INT32_MAX, dtype=torch.int64,
                          device=dev)
    real_key[:ridx.shape[0]] = ((ridx // n_clusters) * (n_clusters + 1)
                                + ridx % n_clusters + 1)
    sent_key = torch.arange(n_tiles, device=dev) * (n_clusters + 1)
    with profiling.step("sort"):
        keys = torch.sort(torch.cat([sent_key, real_key])).values
    valid = keys < INT32_MAX
    pair_tile = torch.where(valid, keys // (n_clusters + 1), n_tiles - 1)
    pair_cl = torch.where(valid, keys % (n_clusters + 1) - 1, -1)
    packed = (pair_tile * 65536 + pair_cl + 1).to(torch.int32)
    return packed, n_pairs, overflow


def _wave_grid_lists(org, dirn, tmv, lo, hi, chunk_tiles, *, n_clusters,
                     pair_cap, per_tile_clamp, all_pairs=False):
    """K4's pair lists of a whole wave: each launch chunk of
    ``chunk_tiles`` tiles gets its own list of ``pair_cap`` slots (the
    reference's launch sizing, cuts and flags), renumbered to the wave's
    tiles and laid end to end, one launch per 32767 tiles (the tile field
    of a pair word). Returns ([(first tile, end tile, packed)], n_pairs,
    overflow)."""
    n_tiles = org.shape[0] // TILE
    if chunk_tiles > 32767:
        raise ValueError(f"{chunk_tiles} tiles in one launch: the pair "
                         "encoding caps them at 32767")
    group = 32767 // chunk_tiles * chunk_tiles  # tiles per launch
    launches, nps, ofs = [], [], []
    for g in range(0, n_tiles, group):
        lists = []
        for k in range(g, min(g + group, n_tiles), chunk_tiles):
            c = slice(k * TILE, (k + chunk_tiles) * TILE)
            packed, np_, of = _grid_list(
                org[c], dirn[c], tmv[c], lo, hi, n_clusters=n_clusters,
                pair_cap=pair_cap, per_tile_clamp=per_tile_clamp,
                all_pairs=all_pairs)
            lists.append(packed + (k - g) * 65536)
            nps.append(np_)
            ofs.append(of)
        launches.append((g, min(g + group, n_tiles), torch.cat(lists)))
    return launches, torch.stack(nps).sum(), torch.stack(ofs).any()


def _trace_grid(org, dirn, tmv, lo, hi, tri_rows, chunk_tiles, *,
                n_clusters, pair_cap, per_tile_clamp, any_hit, tl,
                all_pairs=False):
    """A wave through K4 (lists from ``_wave_grid_lists``). Returns
    ((bt, bu, bv, bs[, bi]), n_pairs, overflow)."""
    inv_d = _safe_inv(dirn)
    launches, n_pairs, overflow = _wave_grid_lists(
        org, dirn, tmv, lo, hi, chunk_tiles, n_clusters=n_clusters,
        pair_cap=pair_cap, per_tile_clamp=per_tile_clamp,
        all_pairs=all_pairs)
    outs = []
    for t0, t1, packed in launches:
        c = slice(t0 * TILE, t1 * TILE)
        outs.append(tilegrid(org[c], dirn[c], inv_d[c], tmv[c], tri_rows,
                             packed, any_hit, all_pairs=all_pairs, **tl))
    out = (outs[0] if len(outs) == 1
           else tuple(torch.cat(f) for f in zip(*outs)))
    return out, n_pairs, overflow


def make_tile_intersector(ds, accel, *, pairs_per_tile: int = 0,
                          pairs_avg: int = 0, ray_sort: str = "none",
                          shadow_ray_sort: str = "octant",
                          shadow_pairs_avg: int = 0, pairs_avg_cap: int = 0,
                          lean: bool = False, live_cap: int = 0,
                          shadow_live_cap: int = 0):
    """Closest/any-hit pair over a pair-cluster accel (same interface as
    ``make_brute_force``); ``accel`` is a PairAccel or PairAccelTL of
    tensors on the rays' device.

    Modes (module docstring): all-pairs for at most ALLPAIRS_MAX_CLUSTERS
    clusters (no sort, no restore, no live truncation); with the pair loop
    (``TPURT_PAIR_LOOP``, default on) entry rows while the reference's
    gate passes (per supercluster at C ≥ SC_AUTO_MIN_CLUSTERS or past the
    cluster gate, without a clamp), else pair segments in 256-tile
    chunks; without it the grid over pairs (K4) in chunks of
    ``96 K // pairs_avg`` tiles. Each wave's chunk lists go to one launch
    of K1 or K4.

    The reference's switches, read here (so a renderer built under them
    keeps them): ``TPURT_SUPERCLUSTER`` "auto" (the default: the rule
    above), "1" (supercluster entries wherever their slab passes the
    entry-row gate, with the pair loop and no clamp) or "0" (never);
    ``TPURT_EXACT_MASK`` "1" (the default: exact entries on sorted waves,
    the interval mask on primary waves), "all" (exact on every wave) or
    "0" (the interval mask on every wave: K2 and K3 never launch);
    ``TPURT_FUSED_ENTRIES`` "1" (the default: unclamped exact entry rows
    come packed from K2) or "0" (from K3's mask and entry distances,
    packed in torch: the same words). A two-level accel
    (``pair_meta``) runs K1/K4 in object space per instance-cluster and
    reports the hit instance.

    ``pairs_per_tile`` > 0 clamps every tile to its first
    ``min(pairs_per_tile − 1, C)`` hit clusters in cluster order (a
    clamped tile drops hits) and reports the overflow in stats[1]; it
    switches superclusters off and leaves all-pairs alone, as in the
    reference. 0 = no clamp. ``pairs_avg`` (closest waves) and
    ``shadow_pairs_avg`` (any-hit waves, 0 = pairs_avg) size the grid's
    pair capacity per tile on average; ``pairs_avg_cap`` (0 = the largest
    of them) sizes the pair-segment capacity. A cut list also sets
    stats[1].

    ``ray_sort``/``shadow_ray_sort``: "none" (keep the caller's order,
    interval-frustum entries — primary waves), "octant" (direction
    octant major, origin Morton minor — bounce and shadow waves) or
    "morton" (origin major, direction minor): a coherence sort, exact
    entries, and the results restored to the caller's order; or "pre"
    (the caller sorted the wave and reads the results in that order: no
    sort and no restore, exact entries kept). ``lean``: Hit.tri comes
    back as −1 (and Hit.inst too on a flat accel; renderers shade through
    ``Hit.slot`` and, two-level, ``Hit.inst``).
    ``live_cap``/``shadow_live_cap``: live-wave truncation of the sorted
    closest/shadow waves (rays, rounded up to whole chunks where the
    wave is chunked); alive rays past the cap are counted in stats[2]
    so the caller can re-render uncapped. ``host_read(n)`` (on both
    closures) says why a wave of ``n`` rays reads the host mid-trace —
    the pair segments and the grid over pairs size their lists by what
    the device found — or "" (all-pairs and entry rows)."""
    from tpurt_torch.kernels import raysort

    del ds
    for s in (ray_sort, shadow_ray_sort):
        if s not in ("none", "morton", "octant", "pre"):
            raise ValueError(f"ray sort {s!r}")
    use_loop = os.environ.get("TPURT_PAIR_LOOP", "1") == "1"
    sc_env = os.environ.get("TPURT_SUPERCLUSTER", "auto")
    exact_env = os.environ.get("TPURT_EXACT_MASK", "1")
    fused = os.environ.get("TPURT_FUSED_ENTRIES", "1") == "1"
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
    sc_meta = accel.sc_meta
    scale = tn_scale_of(lo.cpu().numpy(), hi.cpu().numpy())
    if sc_meta is not None:
        n_sc = int(sc_meta.shape[0])
        sc_scale = tn_scale_of(accel.sc_lo.cpu().numpy(),
                               accel.sc_hi.cpu().numpy())
    lo_all = lo.amin(dim=0)
    hi_all = hi.amax(dim=0)
    ext = hi_all - lo_all
    diag = torch.sqrt(ext[0] * ext[0] + ext[1] * ext[1] + ext[2] * ext[2])
    clamp = (n_clusters + 1 if pairs_per_tile <= 0
             else min(pairs_per_tile, n_clusters + 1))

    def _plan(n_tiles, eff_avg):
        """The mode and the launch sizing of a wave of ``n_tiles`` tiles
        past the all-pairs check (the reference's): (supercluster
        entries, one launch, entry rows, chunk tiles, pair-segment
        capacity, grid pairs a tile)."""
        avg = clamp if eff_avg <= 0 else min(eff_avg, clamp)
        sc_active = (sc_meta is not None and sc_env != "0" and use_loop
                     and pairs_per_tile <= 0
                     and _entry_rows_enabled(n_sc, n_tiles))
        cluster_rows = _entry_rows_enabled(n_clusters, n_tiles)
        sc_active = sc_active and (sc_env == "1" or not cluster_rows
                                   or n_clusters >= SC_AUTO_MIN_CLUSTERS)
        one_launch = use_loop and (sc_active or cluster_rows)
        pcap = 0
        if one_launch:
            chunk_tiles = n_tiles
        elif use_loop:
            cap_avg = pairs_avg_cap if pairs_avg_cap > 0 else max(
                pairs_avg, shadow_pairs_avg, eff_avg)
            chunk_tiles = min(TILES_PER_LAUNCH, n_tiles)
            pcap = min(chunk_tiles * (n_clusters if cap_avg <= 0
                                      else min(cap_avg, n_clusters)),
                       MAX_PAIRS_PER_LAUNCH)
        else:
            chunk_tiles = min(n_tiles, max(1, MAX_PAIRS_PER_LAUNCH // avg),
                              32767)
        # a wave past the gate whose chunks pass it runs entry rows too:
        # the reference launches them per chunk, one launch gives the
        # same rows, clamp and counts (all per tile)
        rows = one_launch or (
            use_loop and _entry_rows_enabled(n_clusters, chunk_tiles))
        return sc_active, one_launch, rows, chunk_tiles, pcap, avg

    def host_read(n: int) -> str:
        """Why a wave of ``n`` rays reads the host before its trace ends
        (its lists are sized by what the device found), or "" where it
        does not: the staged loop captures only waves that do not."""
        if all_pairs:
            return ""  # a fixed row, or a fixed grid list
        if not use_loop:
            return ("the grid over pairs (TPURT_PAIR_LOOP=0) builds its "
                    "pair lists with torch.nonzero")
        if _plan(-(-n // TILE), pairs_avg)[2]:  # entry rows
            return ""
        return ("the pair segments (a wave past the entry-row gate) "
                "build their lists by boolean indexing")

    def _run(org, dirn, t_max, any_hit=False, sort=None, avg_over=None,
             live_trunc=0):
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
            kernels.count("waves." + ("all_pairs" if use_loop else "grid"))
            if use_loop:
                out, n_pairs = _trace_all_pairs(org, dirn, tmv, tri_rows,
                                                n_clusters, any_hit=any_hit,
                                                tl=tl)
                overflow = torch.zeros_like(n_pairs)
            else:
                out, n_pairs, overflow = _trace_grid(
                    org, dirn, tmv, lo, hi, tri_rows, n_tiles,
                    n_clusters=n_clusters, pair_cap=n_tiles * n_clusters,
                    per_tile_clamp=0, any_hit=any_hit, tl=tl,
                    all_pairs=True)
            stats = torch.stack([n_pairs, overflow.to(torch.float32),
                                 live_over])
            return tuple(f[:n] for f in out), stats
        # the mode and the launch sizing of this wave (the reference's)
        eff_avg = pairs_avg if avg_over is None else avg_over
        sc_active, one_launch, rows, chunk_tiles, pcap, avg = _plan(
            n_tiles, eff_avg)
        extra = 0 if rows else (-n_tiles) % chunk_tiles  # equal chunks
        if extra:
            e = extra * TILE
            org = torch.cat([org, torch.zeros((e, 3), device=dev)])
            dirn = torch.cat([dirn, torch.ones((e, 3), device=dev)])
            tmv = torch.cat([tmv, torch.full((e,), -1.0, device=dev)])
            n_tiles += extra
        perm = None
        n_full = n_tiles * TILE
        if sort in ("morton", "octant"):
            kt = n_tiles  # the tiles a live-capped wave keeps
            if live_trunc:
                kt = min(n_tiles, -(-int(live_trunc) // TILE))
                if not one_launch:  # whole launch chunks
                    kt = min(n_tiles, -(-kt // chunk_tiles) * chunk_tiles)
            with profiling.step("sort"):
                perm, org, dirn, tmv, over = raysort.sort_rays(
                    org, dirn, tmv, lo_all, hi_all, kt * TILE,
                    morton=sort == "morton")
            if kt < n_tiles:
                live_over = over
                n_tiles = kt
                if one_launch:
                    chunk_tiles = kt
        exact = exact_env == "all" or (exact_env == "1" and sort != "none")
        kernels.count("waves." + ("grid" if not use_loop else "sc_rows"
                                  if sc_active else "cluster_rows" if rows
                                  else "pair_segments"))
        if not use_loop:
            out, n_pairs, overflow = _trace_grid(
                org, dirn, tmv, lo, hi, tri_rows, chunk_tiles,
                n_clusters=n_clusters, pair_cap=chunk_tiles * avg,
                per_tile_clamp=clamp, any_hit=any_hit, tl=tl)
        elif sc_active:
            out, n_pairs, overflow = _trace_entry_rows(
                org, dirn, tmv, accel.sc_lo, accel.sc_hi, tri_rows, sc_scale,
                any_hit=any_hit, exact=exact, tl=dict(tl, sc_meta=sc_meta),
                fused=fused)
        elif rows:
            out, n_pairs, overflow = _trace_entry_rows(
                org, dirn, tmv, lo, hi, tri_rows, scale, any_hit=any_hit,
                exact=exact, tl=tl, pairs_per_tile=pairs_per_tile,
                fused=fused)
        else:
            out, n_pairs, overflow = _trace_segments(
                org, dirn, tmv, lo, hi, tri_rows, scale, chunk_tiles,
                any_hit=any_hit, exact=exact, tl=tl,
                pairs_per_tile=pairs_per_tile, pcap=pcap)
        if perm is not None:
            # un-permute only what the caller reads (any-hit waves only
            # bs); a truncated wave's dropped tail gets the kernel's
            # dead-lane values (bt −1, bu bv 0, bs −1, bi −1)
            with profiling.step("sort"):
                out = raysort.restore(out, perm, n_full, (3,) if any_hit
                                      else range(len(out)))
        stats = torch.stack([n_pairs, overflow.to(torch.float32), live_over])
        return tuple(f[:n] for f in out), stats

    def _hit_from(bt, bu, bv, bs, bi=None):
        slot = bs.to(torch.int32)
        valid = slot >= 0
        slot_c = torch.clamp(slot, 0, n_prims - 1)
        tri = (torch.full_like(slot_c, -1) if lean
               else prim_tri[slot_c.long()])
        if two_level:
            # the instance comes from the kernel's fifth output (the slot
            # is a shared mesh slot): the two-level resolver needs both
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
                          sort=shadow_ray_sort,
                          avg_over=shadow_pairs_avg or None,
                          live_trunc=shadow_live_cap)
        return out[3] >= 0.0, stats

    def closest(org, dirn, t_min, t_max) -> Hit:
        return closest_with_stats(org, dirn, t_min, t_max)[0]

    def any_hit(org, dirn, t_min, t_max):
        return any_hit_with_stats(org, dirn, t_min, t_max)[0]

    closest.with_stats = closest_with_stats
    any_hit.with_stats = any_hit_with_stats
    closest.host_read = any_hit.host_read = host_read
    return closest, any_hit
