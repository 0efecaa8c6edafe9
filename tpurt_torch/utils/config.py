"""Config system — port of ``tpurt.utils.config``.

One frozen dataclass ``RenderConfig`` with the reference's fields and
defaults, and the per-demo presets of the benchmark ladder. More than one
sample or tile shard renders on a world of that many ranks
(``tpurt_torch.parallel``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    scene: str = "cornell"  # preset name or .obj/.gltf/.glb path
    width: int = 512
    height: int = 512
    spp: int = 64  # total samples per pixel (progressive)
    spp_per_batch: int = 4  # samples folded into one batch's ray wave
    # cap on rays per batch: samples are flattened into the ray axis, so
    # width·height·spp_per_batch is clamped to this
    max_rays_per_batch: int = 4 << 20
    max_bounces: int = 4  # 0 = primary rays only
    use_nee: bool = True  # next-event estimation (shadow rays)
    shading_mode: str = "full"  # "full" | "flat" (hello-triangle)
    texture_filter: str = "nearest"  # "nearest" | "bilinear"
    seed: int = 0
    exposure: float = 1.0
    # "auto" | "brute" | "bvh" | "bvh_packet" | "bvh_pair" | "bvh_tile";
    # "auto" resolves to bvh_tile, the path the port is built around (the
    # reference's CPU default, brute or bvh, is reached by naming it)
    intersector: str = "auto"
    # tile-accel instancing: "auto" | "flatten" | "two_level"
    instancing: str = "auto"
    # bvh_pair: static (ray, cluster) pair capacity per trace = rays ×
    # pairs_per_ray; bvh_tile: per-tile cluster clamp (0 = all clusters,
    # exact). An overflow of either is flagged and render_scene retries
    # with doubled budgets. The pairs_avg* budgets (pairs per tile on
    # average) size bvh_tile's pair lists where entry rows are off: per
    # wave kind (primary, bounce, shadow) the grid-over-pairs capacity
    # under TPURT_PAIR_LOOP=0, and their maximum the pair-segment
    # capacity of a 256-tile launch (TPURT_ENTRY_ROWS=0, or scenes past
    # the entry-row gate). Their overflows retry like the clamp's.
    pairs_per_ray: int = 8
    pairs_per_tile: int = 0
    pairs_avg: int = 48
    pairs_avg_bounce: int = 384
    pairs_avg_shadow: int = 192
    # tile-wavefront ray reorder per wave kind: "none" | "morton" |
    # "octant". Primaries keep the screen-tile order; bounce and shadow
    # waves sort by direction octant, then origin Morton.
    tile_primary_sort: str = "none"
    tile_ray_sort: str = "octant"
    tile_shadow_sort: str = "octant"
    # the staged loop's sorted-wave variant: one payload-through sort of
    # the wave a bounce replaces the intersector's forward and restore
    # sorts (tile and pair accels, flat shading excluded); the
    # TPURT_SORTED_WAVE environment variable (0/1) overrides it
    sorted_wave: bool = False
    # live-wave truncation caps: entry b = max rays kept for the
    # bounce-(b+1) trace after its octant sort puts dead rays at the back
    # (rounded up to the tile size). () = none. A cap that cuts alive
    # rays trips the live_overflow counter and render_scene re-renders
    # uncapped — never a silent truncation.
    live_caps: tuple = ()
    # shadow-wave truncation caps: entry b = max rays kept for bounce b's
    # occlusion trace (non-want rays sort to the back). Same contract.
    shadow_caps: tuple = ()
    bvh_leaf_size: int = 4
    packet_ray_sort: str = "none"
    # "auto" | "mega" | "staged" | "wavefront"; "auto" resolves to the
    # staged wave loop
    pipeline: str = "auto"
    wavefront_capacity: int = 1 << 16
    material_sort: bool = True
    # distributed execution: mesh axis sizes (one rank a shard); 1 = single
    # device
    n_sample_shards: int = 1
    n_tile_shards: int = 1

    def resolved_pipeline(self) -> str:
        return "staged" if self.pipeline == "auto" else self.pipeline

    def resolved_intersector(self) -> str:
        return "bvh_tile" if self.intersector == "auto" else self.intersector


# The five-config benchmark ladder.
PRESETS = {
    "hello_triangle": RenderConfig(
        scene="hello_triangle", width=800, height=600, spp=1, spp_per_batch=1,
        max_bounces=0, use_nee=False, shading_mode="flat", intersector="auto",
    ),
    "cornell": RenderConfig(
        scene="cornell", width=512, height=512, spp=64, spp_per_batch=16,
        max_bounces=0, use_nee=True, intersector="auto",
    ),
    "bunny": RenderConfig(
        scene="bunny", width=800, height=600, spp=16, spp_per_batch=8,
        max_bounces=2, use_nee=True, intersector="auto",
    ),
    "cornell_pt": RenderConfig(
        scene="cornell_pt", width=512, height=512, spp=256,
        spp_per_batch=16,
        max_bounces=4, use_nee=True, intersector="auto",
    ),
    "sponza": RenderConfig(
        scene="sponza", width=1920, height=1080, spp=8, spp_per_batch=2,
        max_bounces=2, use_nee=True, intersector="auto",
    ),
}


def get_config(name: str, **overrides) -> RenderConfig:
    cfg = PRESETS.get(name)
    if cfg is None:
        cfg = RenderConfig(scene=name)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
