"""Packet-BVH build — port of ``tpurt.bvh.cluster``.

Triangles pack 12 per 128-lane row; each owns 10 lanes (v0.xyz, e1.xyz,
e2.xyz, slot id as f32). The pair-cluster build uses the same records and
the Morton helpers below. ``build_packet_accel`` flattens instances to
world space, Morton-sorts the triangles, packs them into rows, groups the
rows into uniform leaves and builds a preorder median-split tree over the
leaves with skip links: the acceleration structure of the ``bvh_packet``
intersector (``kernels.packet``).

The tree is built natively when the host library loads
(``utils.native.bvh_build``, ``std::nth_element`` splits), as the
reference builds it, and otherwise by the Python twin
``_median_split_tree``. The two order leaves differently; each is
byte-equal to the reference's own build of the same kind, so the node
arrays match the reference's with or without ``TPURT_NO_NATIVE=1``.
``tri_rows``, ``prim_tri`` and ``prim_inst`` do not depend on the tree.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np

TPR = 12  # triangles per 128-lane row: 12 × 10 lanes + 8 spare
LANES_PER_TRI = 10
# largest tree the reference's SMEM node budget holds (≈ 2 nodes per leaf)
SMEM_NODE_BUDGET = 5000


class PacketAccel(NamedTuple):
    """Packed packet-BVH (host numpy; ``to(device)`` for tensors).

    node_*: per-node scalars. ``count`` rows > 0 = leaf over tri rows
    [first, first + count); 0 = internal (hit successor = node + 1).
    ``skip`` >= n_nodes ⇒ traversal done.
    tri_rows: (R, 128) f32 — triangle t of row r at lanes [10t, 10t + 10):
        v0.xyz, e1.xyz, e2.xyz, slot (exact in f32 up to 2^24). Padding
        triangles are all-zero (Möller–Trumbore det = 0 ⇒ miss) with
        slot -1.
    prim_tri/prim_inst: flat slot → (global triangle id, instance id).
    """

    node_bminx: np.ndarray
    node_bminy: np.ndarray
    node_bminz: np.ndarray
    node_bmaxx: np.ndarray
    node_bmaxy: np.ndarray
    node_bmaxz: np.ndarray
    node_first: np.ndarray
    node_count: np.ndarray
    node_skip: np.ndarray
    tri_rows: np.ndarray
    prim_tri: np.ndarray
    prim_inst: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.node_first.shape[0]

    @property
    def n_rows(self) -> int:
        return self.tri_rows.shape[0]

    def to(self, device) -> "PacketAccel":
        """The same tables as contiguous torch tensors on ``device``."""
        import torch

        return PacketAccel(*(torch.from_numpy(np.array(a)).to(device)
                             for a in self))


def _expand_bits(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint32)
    v = (v | (v << 16)) & np.uint32(0x030000FF)
    v = (v | (v << 8)) & np.uint32(0x0300F00F)
    v = (v | (v << 4)) & np.uint32(0x030C30C3)
    v = (v | (v << 2)) & np.uint32(0x09249249)
    return v


def _morton(c: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    q = np.clip((c - lo) / np.maximum(hi - lo, 1e-12), 0.0, 1.0)
    g = np.minimum((q * 1024.0).astype(np.uint32), 1023)
    return (
        (_expand_bits(g[:, 0]) << 2)
        | (_expand_bits(g[:, 1]) << 1)
        | _expand_bits(g[:, 2])
    )


class _Tree(NamedTuple):
    bmin: np.ndarray
    bmax: np.ndarray
    first: np.ndarray
    count: np.ndarray
    skip: np.ndarray


def _build_tree(bmin: np.ndarray, bmax: np.ndarray) -> _Tree:
    """The preorder median-split tree over item boxes: the native build
    when the host library loads, else the Python twin."""
    from tpurt_torch.utils import native

    built = native.bvh_build(bmin, bmax)
    if built is not None:
        return _Tree(*built)
    return _median_split_tree(bmin, bmax)


def _median_split_tree(bmin: np.ndarray, bmax: np.ndarray) -> _Tree:
    """Preorder median-split BVH over items with skip links (the Python
    twin of the native build): each node splits its items at the
    centroid median (stable argsort) along the widest centroid axis; a
    single item is a leaf (count 1)."""
    n = bmin.shape[0]
    centro = 0.5 * (bmin + bmax)
    nb, nx, firsts, counts = [], [], [], []

    def emit(idx: np.ndarray) -> None:
        me = len(firsts)
        nb.append(bmin[idx].min(0))
        nx.append(bmax[idx].max(0))
        firsts.append(int(idx[0]))
        counts.append(0)
        if idx.size == 1:
            counts[me] = 1
            return
        ext = centro[idx].max(0) - centro[idx].min(0)
        axis = int(np.argmax(ext))
        part = idx[np.argsort(centro[idx, axis], kind="stable")]
        half = idx.size // 2
        emit(part[:half])
        emit(part[half:])

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * n + 64))
    try:
        emit(np.arange(n))
    finally:
        sys.setrecursionlimit(old)

    m = len(firsts)
    counts_a = np.asarray(counts, np.int32)
    sizes = np.ones(m, np.int32)
    stack: list[int] = []
    for i in range(m - 1, -1, -1):
        if counts_a[i] > 0:
            sizes[i] = 1
        else:
            a = stack.pop()
            b = stack.pop()
            sizes[i] = 1 + sizes[a] + sizes[b]
        stack.append(i)
    skip = np.arange(m, dtype=np.int32) + sizes
    return _Tree(
        np.asarray(nb, np.float32),
        np.asarray(nx, np.float32),
        np.asarray(firsts, np.int32),
        counts_a,
        skip,
    )


def _host_tris(ds, meta, scene=None):
    """Host-side (v0, v1, v2, inst_transform) for the accel build: from
    the host Scene when given, else read back from the DeviceScene."""
    if scene is not None:
        v0s, v1s, v2s = [], [], []
        for mesh in scene.meshes:
            v = mesh.vertices
            idx = mesh.indices
            v0s.append(v[idx[:, 0]])
            v1s.append(v[idx[:, 1]])
            v2s.append(v[idx[:, 2]])
        tv0 = np.concatenate(v0s).astype(np.float32)
        tv1 = np.concatenate(v1s).astype(np.float32)
        tv2 = np.concatenate(v2s).astype(np.float32)
        inst_tf = np.stack(
            [i.transform for i in scene.instances]
        ).astype(np.float32)
        return tv0, tv1, tv2, inst_tf
    return tuple(x.cpu().numpy() for x in (
        ds.tri_v0, ds.tri_v1, ds.tri_v2, ds.inst_transform))


def build_packet_accel(ds, meta, leaf_rows: int | None = None,
                       scene=None) -> PacketAccel:
    """Flatten instances → Morton sort → pack rows → median-split tree,
    with ``leaf_rows`` rows a leaf, by default the fewest that keep the
    tree in the node budget."""
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
    t = v0.shape[0]

    centro = (v0 + v1 + v2) / 3.0
    lo = np.minimum(np.minimum(v0, v1), v2).min(0)
    hi = np.maximum(np.maximum(v0, v1), v2).max(0)
    order = np.argsort(_morton(centro, lo, hi), kind="stable")
    v0, v1, v2 = v0[order], v1[order], v2[order]
    tri_id, inst_id = tri_id[order], inst_id[order]

    n_rows = -(-t // TPR)
    if leaf_rows is None:
        # largest tree whose ~2·leaves nodes fit the node budget
        leaf_rows = max(1, -(-n_rows // (SMEM_NODE_BUDGET // 2)))
    n_leaves = -(-n_rows // leaf_rows)
    n_rows = n_leaves * leaf_rows  # pad rows so leaves are uniform
    slots = n_rows * TPR
    pad = slots - t

    def padf(a, fill=0.0):
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill,
                                          a.dtype)])

    v0, v1, v2 = padf(v0), padf(v1), padf(v2)
    slot_id = np.concatenate(
        [np.arange(t, dtype=np.float32), np.full(pad, -1.0, np.float32)]
    )

    e1 = v1 - v0
    e2 = v2 - v0
    rec = np.zeros((slots, LANES_PER_TRI), np.float32)
    rec[:, 0:3] = v0
    rec[:, 3:6] = e1
    rec[:, 6:9] = e2
    rec[:, 9] = slot_id
    tri_rows = np.zeros((n_rows, 128), np.float32)
    tri_rows[:, : TPR * LANES_PER_TRI] = rec.reshape(
        n_rows, TPR * LANES_PER_TRI
    )

    # leaf AABBs over valid tris only
    valid = (slot_id >= 0)[:, None]
    big = np.float32(3.4e38)
    pmin = np.where(valid, np.minimum(np.minimum(v0, v1), v2), big)
    pmax = np.where(valid, np.maximum(np.maximum(v0, v1), v2), -big)
    lt = leaf_rows * TPR
    lbmin = pmin.reshape(n_leaves, lt, 3).min(1)
    lbmax = pmax.reshape(n_leaves, lt, 3).max(1)

    tree = _build_tree(lbmin, lbmax)
    # leaf ids → row ranges
    first_rows = np.where(
        tree.count > 0, tree.first * leaf_rows, 0
    ).astype(np.int32)
    count_rows = (tree.count * leaf_rows).astype(np.int32)

    return PacketAccel(
        node_bminx=tree.bmin[:, 0].copy(),
        node_bminy=tree.bmin[:, 1].copy(),
        node_bminz=tree.bmin[:, 2].copy(),
        node_bmaxx=tree.bmax[:, 0].copy(),
        node_bmaxy=tree.bmax[:, 1].copy(),
        node_bmaxz=tree.bmax[:, 2].copy(),
        node_first=first_rows,
        node_count=count_rows,
        node_skip=tree.skip,
        tri_rows=tri_rows,
        prim_tri=tri_id,
        prim_inst=inst_id,
    )
