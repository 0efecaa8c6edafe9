"""Multi-GPU rendering — port of ``tpurt.parallel``.

X1 tile sharding (the frame's pixels split between ranks, the scene and
accel replicated) and X2 sample sharding (each rank over its own window
of the sample stream), one process a shard, joined by
``torch.distributed``; the merges are fixed-order sums, so a sharded
render equals the single-device render of the same samples bit for bit.
"""

from tpurt_torch.parallel.mesh import (
    RenderMesh,
    distributed_spec,
    init_multihost,
    make_render_mesh,
    merge_shards,
    render_batch_distributed,
)

__all__ = ["RenderMesh", "distributed_spec", "init_multihost",
           "make_render_mesh", "merge_shards", "render_batch_distributed"]
