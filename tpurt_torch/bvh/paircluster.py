"""Pair-cluster acceleration structure — port of the flat build of
``tpurt.bvh.paircluster`` (``build_pair_accel``).

Host numpy, byte-identical to the reference's build:

  * instances flattened to world space, triangles Morton-sorted, then
    reordered by a hierarchical kd-SAH partition into uniform clusters of
    TRIS_PER_CLUSTER triangles, so cluster c's rows are exactly
    [c · ROWS_PER_CLUSTER, (c+1) · ROWS_PER_CLUSTER) of the packed
    (R, 128) triangle table (12 tris/row, ``cluster.TPR``);
  * per-cluster world AABBs; each row's 12-triangle sub-AABB rides in
    spare lanes 120–125 and the cluster's own AABB in lanes 126–127 of its
    first three rows (the traversal kernel's box pre-tests);
  * per-slot world-space shading records (``shade_rows``);
  * the supercluster level (parent boxes over SC_SIZE consecutive
    clusters), built but used only by the two-level/supercluster traversal
    modes, which are not ported yet (ROADMAP §1 item 10).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from tpurt_torch.bvh.cluster import LANES_PER_TRI, TPR, _host_tris, _morton

# 8 rows × 12 tris per cluster.
TRIS_PER_CLUSTER = 96
ROWS_PER_CLUSTER = TRIS_PER_CLUSTER // TPR
BIG = np.float32(3.4e38)

# Supercluster level: groups of SC_SIZE consecutive clusters under one
# parent AABB (children are consecutive in the final cluster order).
SC_SIZE = 8
# rows appended so a fixed SC_SIZE-cluster copy from the last group's
# first child cannot overrun the table
SC_PAD_ROWS = (SC_SIZE - 1) * ROWS_PER_CLUSTER


def _supercluster_groups(lo: np.ndarray, hi: np.ndarray,
                         base0: int = 0):
    """Group consecutive clusters into superclusters of SC_SIZE.

    Returns (sc_lo, sc_hi, sc_meta) where sc_meta packs
    ``first_child_cluster | n_children << 16``."""
    n_c = lo.shape[0]
    sc_lo, sc_hi, sc_meta = [], [], []
    for b in range(0, n_c, SC_SIZE):
        e = min(b + SC_SIZE, n_c)
        sc_lo.append(lo[b:e].min(0))
        sc_hi.append(hi[b:e].max(0))
        sc_meta.append((base0 + b) | ((e - b) << 16))
    return (
        np.asarray(sc_lo, np.float32),
        np.asarray(sc_hi, np.float32),
        np.asarray(sc_meta, np.int32),
    )


SHADE_LANES = 32  # record stride (one (n_slots, 32) row per slot)
# record layout (lane offsets within the 32-lane record):
#   0:3   world geometric normal (inst normal matrix · object cross, raw)
#   3:6   world shading normal at v0 (raw; interpolate then normalize)
#   6:9   .. at v1      9:12  .. at v2
#   12    material kind  13:16 albedo  16:19 emission
#   19    param0  20 param1  21 material id
#   22:24 uv at v0  24:26 uv at v1  26:28 uv at v2  28 texture id
#   29    alpha cutoff (0 = opaque; > 0 = alpha-tested)


class PairAccel(NamedTuple):
    """Uniform-cluster table (host numpy; ``to(device)`` for tensors).

    cluster_lo/hi: (C, 3) f32 world AABBs.
    tri_rows: (C · ROWS_PER_CLUSTER + SC_PAD_ROWS, 128) f32 packed
        triangle records (v0.xyz, e1.xyz, e2.xyz, slot id; 12 per row;
        zero padding has det 0 ⇒ Möller–Trumbore miss, slot −1).
    prim_tri/prim_inst: flat slot → (global tri id, instance id).
    shade_rows: (n_slots, SHADE_LANES) f32 world-space shading records.
    """

    cluster_lo: np.ndarray
    cluster_hi: np.ndarray
    tri_rows: np.ndarray
    prim_tri: np.ndarray
    prim_inst: np.ndarray
    shade_rows: np.ndarray
    sc_lo: Optional[np.ndarray] = None
    sc_hi: Optional[np.ndarray] = None
    sc_meta: Optional[np.ndarray] = None

    @property
    def n_clusters(self) -> int:
        return self.cluster_lo.shape[0]

    def to(self, device) -> "PairAccel":
        """The same tables as contiguous torch tensors on ``device``."""
        import torch

        return PairAccel(*(
            None if a is None
            else torch.from_numpy(np.array(a)).to(device)
            for a in self
        ))


def flatten_world_tris(ds, meta, scene=None):
    """Instances → world-space triangle soup, Morton-sorted.

    Returns (v0, v1, v2, tri_id, inst_id) host numpy arrays."""
    tv0, tv1, tv2, inst_tf = _host_tris(ds, meta, scene)
    v0l, v1l, v2l, tril, instl = [], [], [], [], []
    for inst_id, mesh_id in enumerate(meta.inst_mesh):
        start, count = meta.mesh_tri_ranges[mesh_id]
        if count == 0:
            continue
        m = inst_tf[inst_id]
        xf = lambda v: v @ m[:, :3].T + m[:, 3]
        v0l.append(xf(tv0[start:start + count]))
        v1l.append(xf(tv1[start:start + count]))
        v2l.append(xf(tv2[start:start + count]))
        tril.append(np.arange(start, start + count, dtype=np.int32))
        instl.append(np.full(count, inst_id, np.int32))
    v0 = np.concatenate(v0l).astype(np.float32)
    v1 = np.concatenate(v1l).astype(np.float32)
    v2 = np.concatenate(v2l).astype(np.float32)
    tri_id = np.concatenate(tril)
    inst_id = np.concatenate(instl)

    centro = (v0 + v1 + v2) / 3.0
    lo = np.minimum(np.minimum(v0, v1), v2).min(0)
    hi = np.maximum(np.maximum(v0, v1), v2).max(0)
    order = np.argsort(_morton(centro, lo, hi), kind="stable")
    return (v0[order], v1[order], v2[order], tri_id[order],
            inst_id[order])


def kd_cluster_order(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                     size: int = TRIS_PER_CLUSTER,
                     sah: bool = True, n_cand: int = 5) -> np.ndarray:
    """Permutation grouping triangles into kd-tight uniform clusters.

    Recursive centroid partition whose split counts are multiples of
    ``size``: every consecutive run of ``size`` tris in the returned
    order is one spatially compact cluster (the single remainder cluster
    lands last). ``sah=True`` picks the split axis and position by
    scanning 3 axes × ``n_cand`` size-multiple positions with the cost
    area(L)·nL + area(R)·nR over true triangle-box unions. Clusters are
    emitted in Morton order of their centroid, and tris within a cluster
    are kd-ordered into 12-tri rows so the per-row sub-boxes stay tight.
    """
    centro = ((v0 + v1 + v2) / 3.0).astype(np.float64)
    if sah:
        pmin = np.minimum(np.minimum(v0, v1), v2).astype(np.float64)
        pmax = np.maximum(np.maximum(v0, v1), v2).astype(np.float64)

        def _area(lo, hi):
            d = np.maximum(hi - lo, 0.0)
            return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    n = v0.shape[0]
    groups = []
    stack = [np.arange(n)]
    while stack:
        s = stack.pop()
        if s.shape[0] <= size:
            groups.append(s)
            continue
        c = centro[s]
        if sah:
            n_cl = s.shape[0] // size
            mid = max(1, int(round(n_cl / 2.0)))
            cands = sorted({
                max(1, min(n_cl, mid + d))
                for d in range(-(n_cand // 2), n_cand // 2 + 1)
            })
            best = None
            for ax in range(3):
                o = np.argsort(c[:, ax], kind="stable")
                so = s[o]
                pre_lo = np.minimum.accumulate(pmin[so], axis=0)
                pre_hi = np.maximum.accumulate(pmax[so], axis=0)
                suf_lo = np.minimum.accumulate(
                    pmin[so][::-1], axis=0)[::-1]
                suf_hi = np.maximum.accumulate(
                    pmax[so][::-1], axis=0)[::-1]
                for m in cands:
                    k = m * size
                    if k >= s.shape[0]:
                        continue
                    cost = (
                        _area(pre_lo[k - 1], pre_hi[k - 1]) * k
                        + _area(suf_lo[k], suf_hi[k])
                        * (s.shape[0] - k)
                    )
                    if best is None or cost < best[0]:
                        best = (cost, so[:k], so[k:])
            if best is not None:
                stack.append(best[1])
                stack.append(best[2])
                continue
            # every candidate k >= len(s) (single full cluster +
            # remainder): fall through to the midpoint split below
        ax = int(np.argmax(c.max(0) - c.min(0)))
        n_cl = s.shape[0] / size
        k = max(1, int(round(n_cl / 2.0))) * size
        if k >= s.shape[0]:
            k = (s.shape[0] - 1) // size * size
        part = np.argpartition(c[:, ax], k)
        stack.append(s[part[:k]])
        stack.append(s[part[k:]])
    # remainder cluster (size < ``size``) must land last so padding only
    # ever hits the final cluster's rows
    full = [g for g in groups if g.shape[0] == size]
    rest = [g for g in groups if g.shape[0] < size]
    assert len(rest) <= 1
    if full:
        lo = centro.min(0)
        hi = centro.max(0)
        cen = np.stack([centro[g].mean(0) for g in full])
        c_ord = np.argsort(
            _morton(cen.astype(np.float32), lo.astype(np.float32),
                    hi.astype(np.float32)), kind="stable"
        )
        full = [full[i] for i in c_ord]
    order = []
    for g in full + rest:
        if sah and g.shape[0] > 12:
            # within-cluster kd-sah into 12-tri rows: the kernel's per-row
            # sub-AABBs come from chopping this order every 12
            order.append(g[kd_cluster_order(
                v0[g], v1[g], v2[g], size=12, sah=True)])
            continue
        m = _morton(centro[g].astype(np.float32),
                    centro[g].min(0).astype(np.float32),
                    centro[g].max(0).astype(np.float32))
        order.append(g[np.argsort(m, kind="stable")])
    return np.concatenate(order) if order else np.arange(0)


def hier_cluster_order(v0, v1, v2, size: int = TRIS_PER_CLUSTER,
                       parent: int = SC_SIZE * TRIS_PER_CLUSTER):
    """Two-level kd-SAH order: kd-tight parent blocks of ``parent`` tris
    first, then kd-tight ``size`` clusters within each block, so the
    SC_SIZE consecutive clusters of each supercluster share a tight parent
    box. Every non-last parent block is exactly ``parent`` tris and the
    single sub-size remainder lands last, so the final cluster is still
    the only padded one."""
    outer = kd_cluster_order(v0, v1, v2, size=parent, sah=True)
    order = []
    n = v0.shape[0]
    for b in range(0, n, parent):
        blk = outer[b:min(b + parent, n)]
        inner = kd_cluster_order(v0[blk], v1[blk], v2[blk], size=size,
                                 sah=True)
        order.append(blk[inner])
    return (np.concatenate(order) if order
            else np.arange(0))


def cluster_order(v0, v1, v2, size: int = TRIS_PER_CLUSTER):
    """Production triangle order for uniform clustering (hierarchical
    kd-SAH — the reference's default)."""
    return hier_cluster_order(v0, v1, v2, size)


def pack_tri_rows(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                  n_rows: int):
    """Pack triangles into the (n_rows, 128) kernel record table.

    Returns (tri_rows, pmin, pmax) where pmin/pmax are per-slot triangle
    AABBs (±BIG on padding slots) for cluster/row box fitting."""
    t = v0.shape[0]
    slots = n_rows * TPR
    pad = slots - t

    def padf(a, fill=0.0):
        return np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]
        )

    v0p, v1p, v2p = padf(v0), padf(v1), padf(v2)
    slot_id = np.concatenate(
        [np.arange(t, dtype=np.float32), np.full(pad, -1.0, np.float32)]
    )
    rec = np.zeros((slots, LANES_PER_TRI), np.float32)
    rec[:, 0:3] = v0p
    rec[:, 3:6] = v1p - v0p
    rec[:, 6:9] = v2p - v0p
    rec[:, 9] = slot_id
    tri_rows = np.zeros((n_rows, 128), np.float32)
    tri_rows[:, : TPR * LANES_PER_TRI] = rec.reshape(
        n_rows, TPR * LANES_PER_TRI
    )
    valid = (slot_id >= 0)[:, None]
    pmin = np.where(valid, np.minimum(np.minimum(v0p, v1p), v2p), BIG)
    pmax = np.where(valid, np.maximum(np.maximum(v0p, v1p), v2p), -BIG)
    return tri_rows, pmin, pmax


def _pack_cluster_box_lanes(tri_rows: np.ndarray, lo: np.ndarray,
                            hi: np.ndarray) -> None:
    """Stuff each cluster's own AABB into lanes 126–127 of its first three
    rows: row0 → (lox, loy), row1 → (loz, hix), row2 → (hiy, hiz). The
    traversal kernel slab-tests this box once per (tile, cluster) pair and
    skips the 8 per-row box tests when no lane can reach the cluster."""
    n_c = lo.shape[0]
    box = np.concatenate([lo, hi], axis=1).astype(np.float32)  # (C, 6)
    rows = tri_rows.reshape(n_c, ROWS_PER_CLUSTER, 128)
    rows[:, 0, 126:128] = box[:, 0:2]
    rows[:, 1, 126:128] = box[:, 2:4]
    rows[:, 2, 126:128] = box[:, 4:6]


def _host_shading(ds, meta, scene=None):
    """Host-side per-global-tri (n0, n1, n2, mat_id), per-inst (normal
    matrix, material override), and material tables."""
    if scene is not None:
        n0s, n1s, n2s, mats = [], [], [], []
        uv0s, uv1s, uv2s = [], [], []
        for mesh in scene.meshes:
            idx = mesh.indices
            nrm = (mesh.normals if mesh.normals is not None
                   else mesh.compute_vertex_normals())
            n0s.append(nrm[idx[:, 0]])
            n1s.append(nrm[idx[:, 1]])
            n2s.append(nrm[idx[:, 2]])
            uv = (mesh.uvs if mesh.uvs is not None
                  else np.zeros((mesh.vertices.shape[0], 2), np.float32))
            uv0s.append(uv[idx[:, 0]])
            uv1s.append(uv[idx[:, 1]])
            uv2s.append(uv[idx[:, 2]])
            mats.append(mesh.material_ids)
        tn0 = np.concatenate(n0s).astype(np.float32)
        tn1 = np.concatenate(n1s).astype(np.float32)
        tn2 = np.concatenate(n2s).astype(np.float32)
        tuv = tuple(
            np.concatenate(x).astype(np.float32)
            for x in (uv0s, uv1s, uv2s)
        )
        tmat = np.concatenate(mats).astype(np.int32)
        inst_nrm = np.stack([
            np.linalg.inv(i.transform[:, :3]).T for i in scene.instances
        ]).astype(np.float32)
        inst_over = np.array(
            [i.material_override for i in scene.instances], np.int32
        )
        k = max(len(scene.materials), 1)
        mk = np.zeros(k, np.float32)
        ma = np.zeros((k, 3), np.float32)
        me = np.zeros((k, 3), np.float32)
        mp0 = np.zeros(k, np.float32)
        mp1 = np.zeros(k, np.float32)
        mtex = np.full(k, -1, np.float32)
        mcut = np.zeros(k, np.float32)
        for j, m in enumerate(scene.materials):
            mk[j] = m.kind
            ma[j] = m.albedo
            me[j] = m.emission
            mp0[j] = m.param0
            mp1[j] = m.param1
            mtex[j] = m.base_color_texture
            mcut[j] = m.alpha_cutoff
        return tn0, tn1, tn2, tmat, inst_nrm, inst_over, mk, ma, me, \
            mp0, mp1, tuv, mtex, mcut
    host = lambda x: x.cpu().numpy()
    return (host(ds.tri_n0), host(ds.tri_n1), host(ds.tri_n2),
            host(ds.tri_mat), host(ds.inst_nrm), host(ds.inst_mat_override),
            host(ds.mat_kind).astype(np.float32), host(ds.mat_albedo),
            host(ds.mat_emission), host(ds.mat_param0), host(ds.mat_param1),
            (host(ds.tri_uv0), host(ds.tri_uv1), host(ds.tri_uv2)),
            host(ds.mat_texture).astype(np.float32),
            host(ds.mat_alpha_cutoff).astype(np.float32))


def build_shade_rows(ds, meta, v0, v1, v2, tri_id, inst_id, n_slots: int,
                     scene=None):
    """(n_slots, SHADE_LANES) world-space shading records."""
    (tn0, tn1, tn2, tmat, inst_nrm, inst_over, mk, ma, me, mp0,
     mp1, tuv, mtex, mcut) = _host_shading(ds, meta, scene)
    t = tri_id.shape[0]
    nm = inst_nrm[inst_id]  # (t, 3, 3)
    xf = lambda n: np.einsum("tij,tj->ti", nm, n).astype(np.float32)
    # v0/v1/v2 are WORLD-space: their cross is already the world normal
    # up to det(A) — flip by its sign to match the normal-matrix convention
    det_sign = np.sign(np.linalg.det(np.linalg.inv(nm))).astype(
        np.float32
    )[:, None]
    n_geom = (np.cross(v1 - v0, v2 - v0) * det_sign).astype(np.float32)
    n0w = xf(tn0[tri_id])
    n1w = xf(tn1[tri_id])
    n2w = xf(tn2[tri_id])
    over = inst_over[inst_id]
    mid = np.where(over >= 0, over, tmat[tri_id])
    mid = np.clip(mid, 0, mk.shape[0] - 1)

    rec = np.zeros((n_slots, SHADE_LANES), np.float32)
    rec[:t, 0:3] = n_geom
    rec[:t, 3:6] = n0w
    rec[:t, 6:9] = n1w
    rec[:t, 9:12] = n2w
    rec[:t, 12] = mk[mid]
    rec[:t, 13:16] = ma[mid]
    rec[:t, 16:19] = me[mid]
    rec[:t, 19] = mp0[mid]
    rec[:t, 20] = mp1[mid]
    rec[:t, 21] = mid.astype(np.float32)
    rec[:t, 22:24] = tuv[0][tri_id]
    rec[:t, 24:26] = tuv[1][tri_id]
    rec[:t, 26:28] = tuv[2][tri_id]
    rec[:t, 28] = mtex[mid]
    rec[:t, 29] = mcut[mid]
    return rec


def build_pair_accel(ds, meta, scene=None) -> PairAccel:
    """Flatten instances → kd-tight uniform clusters + AABBs."""
    v0, v1, v2, tri_id, inst_id = flatten_world_tris(ds, meta, scene)
    ko = cluster_order(v0, v1, v2)
    v0, v1, v2 = v0[ko], v1[ko], v2[ko]
    tri_id, inst_id = tri_id[ko], inst_id[ko]
    t = v0.shape[0]
    n_clusters = -(-t // TRIS_PER_CLUSTER)
    n_rows = n_clusters * ROWS_PER_CLUSTER
    tri_rows, pmin, pmax = pack_tri_rows(v0, v1, v2, n_rows)

    lo = pmin.reshape(n_clusters, TRIS_PER_CLUSTER, 3).min(1)
    hi = pmax.reshape(n_clusters, TRIS_PER_CLUSTER, 3).max(1)

    # each ROW's 12-tri sub-AABB in its own spare lanes 120–125 (padding
    # rows get an empty +BIG/−BIG box that fails every slab test)
    row_lo = pmin.reshape(n_rows, TPR, 3).min(1)
    row_hi = pmax.reshape(n_rows, TPR, 3).max(1)
    tri_rows[:, 120:123] = row_lo.astype(np.float32)
    tri_rows[:, 123:126] = row_hi.astype(np.float32)
    _pack_cluster_box_lanes(tri_rows, lo, hi)

    shade_rows = build_shade_rows(
        ds, meta, v0, v1, v2, tri_id, inst_id, n_slots=t, scene=scene
    )
    lo32 = lo.astype(np.float32)
    hi32 = hi.astype(np.float32)
    sc_lo, sc_hi, sc_meta = _supercluster_groups(lo32, hi32)
    tri_rows = np.concatenate(
        [tri_rows, np.zeros((SC_PAD_ROWS, 128), np.float32)]
    )
    return PairAccel(
        cluster_lo=lo32,
        cluster_hi=hi32,
        tri_rows=tri_rows,
        prim_tri=tri_id,
        prim_inst=inst_id,
        shade_rows=shade_rows,
        sc_lo=sc_lo,
        sc_hi=sc_hi,
        sc_meta=sc_meta,
    )
