"""Acceleration structures: the flat pair-cluster build (host numpy).

The reference's LBVH and two-level builds are not ported yet (ROADMAP
§1 items 10 and 15)."""

from tpurt_torch.bvh.paircluster import PairAccel, build_pair_accel

__all__ = ["PairAccel", "build_pair_accel"]
