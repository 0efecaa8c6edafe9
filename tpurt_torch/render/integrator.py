"""Intersector selection for the render loop — the ``bvh_tile`` branch of
``tpurt.render.integrator.make_intersectors``.

The reference's megakernel ``render_batch`` and the alpha-cutout
occluder/closest wrappers are not ported yet (ROADMAP §1 items 11 and 15);
the port renders through the staged loop in ``render.staged``.
"""

from __future__ import annotations

from tpurt_torch.render.intersectors import SceneMeta
from tpurt_torch.utils.config import RenderConfig

# shadow rays stop this fraction short of the sampled light point
SHADOW_EPS = 1e-3


def make_intersectors(ds, accel, *, meta: SceneMeta, config: RenderConfig,
                      wave: str = "bounce", lean: bool = False,
                      live_cap: int = 0, shadow_live_cap: int = 0):
    """Closest/any-hit pair of the tile intersector for one wave kind:
    "primary" (camera waves — the config's primary sort, screen-tile
    order by default) or "bounce" (incoherent waves — octant sort).
    ``lean=True`` skips the Hit.tri/Hit.inst lookups (renderers shade
    through Hit.slot)."""
    from tpurt_torch.kernels.tilewave import make_tile_intersector

    if meta.has_alpha_cutout:
        raise NotImplementedError(
            "alpha-cutout scenes are not ported yet (ROADMAP §1 item 11)")
    if wave == "primary":
        sort = config.tile_primary_sort
    elif wave == "bounce":
        sort = config.tile_ray_sort
    else:
        raise NotImplementedError(
            f"wave kind {wave!r}: the sorted-wave pipeline is not ported "
            "yet (ROADMAP §1 item 15)")
    return make_tile_intersector(
        ds, accel, ray_sort=sort,
        shadow_ray_sort=config.tile_shadow_sort,
        lean=lean, live_cap=live_cap, shadow_live_cap=shadow_live_cap,
    )
