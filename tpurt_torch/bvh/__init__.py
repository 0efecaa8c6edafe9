"""Acceleration structures: the flat and two-level pair-cluster builds,
the packet BVH (host numpy), and the reference's LBVH builds — one LBVH
per mesh under an LBVH over the instances (``two_level``), built on the
scene's device."""

from tpurt_torch.bvh.cluster import PacketAccel, build_packet_accel
from tpurt_torch.bvh.lbvh import Bvh, build_lbvh
from tpurt_torch.bvh.paircluster import (
    PairAccel,
    PairAccelTL,
    build_pair_accel,
    build_pair_accel_two_level,
)
from tpurt_torch.bvh.two_level import (
    SceneAccel,
    build_scene_accel,
    make_two_level_intersector,
    scene_accel_from_arrays,
)

__all__ = ["Bvh", "PacketAccel", "PairAccel", "PairAccelTL", "SceneAccel",
           "build_lbvh", "build_packet_accel", "build_pair_accel",
           "build_pair_accel_two_level", "build_scene_accel",
           "make_two_level_intersector", "scene_accel_from_arrays"]
