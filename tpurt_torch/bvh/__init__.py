"""Acceleration structures: the flat and two-level pair-cluster builds
and the packet BVH (host numpy).

The reference's LBVH builds are not ported yet (ROADMAP §1 item 15)."""

from tpurt_torch.bvh.cluster import PacketAccel, build_packet_accel
from tpurt_torch.bvh.paircluster import (
    PairAccel,
    PairAccelTL,
    build_pair_accel,
    build_pair_accel_two_level,
)

__all__ = ["PacketAccel", "PairAccel", "PairAccelTL", "build_packet_accel",
           "build_pair_accel", "build_pair_accel_two_level"]
