"""Triangle-record layout and Morton helpers — the part of
``tpurt.bvh.cluster`` the pair-cluster build uses.

Triangles pack 12 per 128-lane row; each owns 10 lanes (v0.xyz, e1.xyz,
e2.xyz, slot id as f32). The packet BVH built on the same records (the
``bvh_packet`` intersector and its kernel) is not ported yet (ROADMAP §1
item 15).
"""

from __future__ import annotations

import numpy as np

TPR = 12  # triangles per 128-lane row: 12 × 10 lanes + 8 spare
LANES_PER_TRI = 10


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
