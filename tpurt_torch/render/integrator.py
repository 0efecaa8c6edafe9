"""Intersector selection for the render loop — the ``bvh_tile``,
``bvh_pair`` and ``bvh_packet`` branches of
``tpurt.render.integrator.make_intersectors``.

The reference's megakernel ``render_batch`` and the alpha-cutout
occluder/closest wrappers are not ported yet (ROADMAP §1 items 11 and 15);
the port renders through the staged loop in ``render.staged``.
"""

from __future__ import annotations

from tpurt_torch.bvh.cluster import PacketAccel
from tpurt_torch.render.intersectors import SceneMeta
from tpurt_torch.utils.config import RenderConfig

# shadow rays stop this fraction short of the sampled light point
SHADOW_EPS = 1e-3


def make_intersectors(ds, accel, *, meta: SceneMeta, config: RenderConfig,
                      wave: str = "bounce", lean: bool = False,
                      live_cap: int = 0, shadow_live_cap: int = 0):
    """Closest/any-hit pair for one wave kind. A PacketAccel takes the
    packet intersector with ``config.packet_ray_sort`` for every wave (no
    lean mode, budgets or live caps, as in the reference). ``bvh_pair``
    takes the pair-wavefront intersector with ``config.pairs_per_ray``
    for every wave (no sort, lean mode or live caps, as in the
    reference). Otherwise the tile intersector: "primary" (camera waves —
    the config's primary sort, screen-tile order by default, and
    ``pairs_avg``) or "bounce" (incoherent waves — octant sort and
    ``pairs_avg_bounce``), with the config's per-tile clamp, the shadow
    budget ``pairs_avg_shadow`` and their maximum as the pair-segment
    capacity. ``lean=True`` skips the Hit.tri/Hit.inst lookups
    (renderers shade through Hit.slot)."""
    if meta.has_alpha_cutout:
        raise NotImplementedError(
            "alpha-cutout scenes are not ported yet (ROADMAP §1 item 11)")
    if isinstance(accel, PacketAccel):
        from tpurt_torch.kernels.packet import make_packet_intersector

        return make_packet_intersector(ds, accel,
                                       ray_sort=config.packet_ray_sort)
    if config.intersector == "bvh_pair":
        from tpurt_torch.kernels.pairwave import make_pair_intersector

        return make_pair_intersector(ds, accel,
                                     pairs_per_ray=config.pairs_per_ray)
    from tpurt_torch.kernels.tilewave import make_tile_intersector

    if wave == "primary":
        sort, avg = config.tile_primary_sort, config.pairs_avg
    elif wave == "bounce":
        sort, avg = config.tile_ray_sort, config.pairs_avg_bounce
    else:
        raise NotImplementedError(
            f"wave kind {wave!r}: the sorted-wave pipeline is not ported "
            "yet (ROADMAP §1 item 15)")
    return make_tile_intersector(
        ds, accel, pairs_per_tile=config.pairs_per_tile, pairs_avg=avg,
        ray_sort=sort, shadow_ray_sort=config.tile_shadow_sort,
        shadow_pairs_avg=config.pairs_avg_shadow,
        pairs_avg_cap=max(config.pairs_avg, config.pairs_avg_bounce,
                          config.pairs_avg_shadow),
        lean=lean, live_cap=live_cap, shadow_live_cap=shadow_live_cap,
    )
