"""Config system — port of ``tpurt.utils.config``.

One frozen dataclass ``RenderConfig`` with the reference's fields and
defaults, and the per-demo presets of the benchmark ladder. Fields that
select reference variants the port does not carry yet are kept so configs
stay interchangeable; ``render_scene`` rejects values that would need them.
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
    # the port implements bvh_tile ("auto" resolves to it)
    intersector: str = "auto"
    # tile-accel instancing: "auto" | "flatten" | "two_level"
    instancing: str = "auto"
    # pair-wavefront / budget-path pair capacities (reference variants)
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
    # sorted-wave pipeline (reference variant, off by default)
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
    # "auto" | "mega" | "staged" | "wavefront"; the port runs the staged
    # wave loop ("auto" resolves to it)
    pipeline: str = "auto"
    wavefront_capacity: int = 1 << 16
    material_sort: bool = True
    # distributed execution: axis sizes; 1 = single device
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
