"""Render entry point — port of ``tpurt.render.render_scene``.

``render_scene(config, device=...)`` renders ``config.spp`` samples per
pixel in progressive batches through the staged wave loop on ``device``
and returns (FrameState, stats). The uncapped re-render on live overflow
is kept; the reference's pair-budget retries have nothing to retry here
(entry rows have no pair capacity).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from tpurt_torch.core.camera import Camera
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render.intersectors import scene_meta
from tpurt_torch.render.png import write_png
from tpurt_torch.scene.device import to_device
from tpurt_torch.scene.loader import load_scene
from tpurt_torch.utils.config import RenderConfig, get_config


def _check_supported(config: RenderConfig) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for every
    config the port does not carry yet."""
    kind = config.resolved_intersector()
    if kind != "bvh_tile":
        raise NotImplementedError(
            f"intersector {kind!r} is not ported (ROADMAP §1 item 15: "
            "alternates and oracles; only bvh_tile is)")
    pipeline = config.resolved_pipeline()
    if pipeline != "staged":
        raise NotImplementedError(
            f"pipeline {pipeline!r} is not ported (ROADMAP §1 item 15: "
            "megakernel and wavefront pipelines)")
    if config.n_sample_shards * config.n_tile_shards > 1:
        raise NotImplementedError(
            "multi-device sharding is not ported (ROADMAP §1 item 14)")
    if config.sorted_wave:
        raise NotImplementedError(
            "the sorted-wave pipeline is not ported (ROADMAP §1 item 15)")
    if config.shading_mode not in ("full", "flat"):
        raise NotImplementedError(
            f"shading mode {config.shading_mode!r} is not a reference mode")
    if config.pairs_per_tile > 0:
        raise NotImplementedError(
            "per-tile pair clamps (the budget path) are not ported "
            "(ROADMAP §1 item 10b)")


def build_accel(config: RenderConfig, ds, meta, scene=None, device="cpu"):
    """The pair-cluster accel on ``device``, picked as the reference picks
    it: two-level when the config asks for it, or on "auto" when
    instances reuse meshes at least 2× and the tables fit pair_meta's
    encoding; flat otherwise."""
    from tpurt_torch.bvh.paircluster import (
        INST_SHIFT, ROWS_PER_CLUSTER, TRIS_PER_CLUSTER, build_pair_accel,
        build_pair_accel_two_level,
    )

    total_instanced = sum(meta.mesh_tri_ranges[m][1] for m in meta.inst_mesh)
    unique = sum(r[1] for r in meta.mesh_tri_ranges)
    n_inst = len(meta.inst_mesh)
    max_rows = (-(-unique // TRIS_PER_CLUSTER) * ROWS_PER_CLUSTER
                + len(meta.mesh_tri_ranges) * ROWS_PER_CLUSTER)
    # pair_meta packs a 20-bit row base and an 11-bit instance id
    fits = n_inst < (1 << (31 - INST_SHIFT)) and max_rows < (1 << INST_SHIFT)
    use_tl = config.instancing == "two_level" or (
        config.instancing == "auto" and fits and n_inst > 1
        and total_instanced >= 2 * unique)
    build = build_pair_accel_two_level if use_tl else build_pair_accel
    return build(ds, meta, scene=scene).to(device)


def render_scene(
    config: RenderConfig,
    *,
    device,
    scene=None,
    camera: Optional[Camera] = None,
    state: Optional[fb.FrameState] = None,
    verbose: bool = False,
):
    """Render ``config.spp`` samples progressively on ``device``; returns
    (FrameState, stats).

    ``scene``: a host Scene (else built from ``config.scene``);
    ``camera`` overrides the scene camera; ``state`` resumes an earlier
    accumulation. Measured live-wave caps (``utils.autotune``) apply when
    the config carries none; if a cap cut alive rays (stats
    ``live_overflow``), the frame is re-rendered uncapped with a warning.
    """
    from tpurt_torch.utils import autotune

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render_scene: device='cuda' but torch finds "
                           "no CUDA device")
    _check_supported(config)
    if not config.live_caps:
        caps = autotune.live_caps_for(config)
        if caps:
            config = dataclasses.replace(config, live_caps=caps)
    if not config.shadow_caps and config.use_nee:
        scaps = autotune.want_caps_for(config)
        if scaps:
            config = dataclasses.replace(config, shadow_caps=scaps)
    if scene is None:
        scene = load_scene(config.scene)
    while True:
        out_state, stats = _render_scene_once(config, scene, camera, state,
                                              verbose, device)
        stats["budget_retries"] = 0
        if not stats["live_overflow"]:
            return out_state, stats
        warnings.warn(
            "live-wave cap truncated alive rays "
            f"(caps={config.live_caps}, shadow={config.shadow_caps}) — "
            "re-rendering uncapped",
            RuntimeWarning,
        )
        config = dataclasses.replace(config, live_caps=(), shadow_caps=())


def _render_scene_once(config, scene, camera, state, verbose, device):
    from tpurt_torch.render.staged import StagedRenderer

    cam = camera if camera is not None else scene.camera
    if cam is None:
        raise ValueError("scene has no camera")
    spp_fit = max(1, config.max_rays_per_batch
                  // (config.width * config.height))
    if config.spp_per_batch > spp_fit:
        config = dataclasses.replace(config, spp_per_batch=spp_fit)

    meta = scene_meta(scene)
    ds = to_device(scene, device)
    accel = build_accel(config, ds, meta, scene=scene, device=device)
    renderer = StagedRenderer(ds, accel, meta=meta, config=config,
                              device=device)
    if state is None:
        state = fb.new_frame_state(config.width, config.height,
                                   config.seed, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n_batches = -(-config.spp // config.spp_per_batch)
    sync()
    t0 = time.perf_counter()
    total_rays = None
    for _ in range(int(state.batch_index), n_batches):
        radiance_sum, counts = renderer(cam, state.seed, state.n_samples)
        state = fb.accumulate(state, radiance_sum, config.spp_per_batch)
        total_rays = counts if total_rays is None else total_rays + counts
        if verbose:
            sync()
            print(f"  batch {state.batch_index}/{n_batches} "
                  f"({state.n_samples} spp) "
                  f"{time.perf_counter() - t0:.3f}s")
    sync()
    elapsed = time.perf_counter() - t0
    # counters are read back after the timed section
    mb = config.max_bounces
    rays = (total_rays.cpu().numpy() if total_rays is not None
            else np.zeros(4 + 2 * (mb + 1)))
    n_rays = float(rays[0] + rays[1])
    stats = {
        "elapsed_s": elapsed,
        "spp": int(state.n_samples),
        "rays_closest": float(rays[0]),
        "rays_shadow": float(rays[1]),
        "rays_traced": n_rays,
        "rays_estimated": False,
        "pair_overflow": bool(rays[2] > 0.0),
        "pair_overflow_events": float(rays[2]),
        "live_overflow": bool(rays[3] > 0.0),
        # live-after-bounce-b then want-at-bounce-b
        "live_counts": [float(v) for v in rays[4:4 + mb + 1]],
        "want_counts": [float(v) for v in rays[4 + mb + 1:]],
        "mrays_per_s": n_rays / max(elapsed, 1e-9) / 1e6,
        "device": str(device),
    }
    return state, stats


def render_to_png(name_or_config, path: str, *, device,
                  verbose: bool = False, **overrides):
    """One-call demo: preset/config → PNG file."""
    config = (
        name_or_config
        if isinstance(name_or_config, RenderConfig)
        else get_config(name_or_config, **overrides)
    )
    state, stats = render_scene(config, device=device, verbose=verbose)
    img = fb.to_png_array(state, config.exposure)
    write_png(path, img)
    return img, stats
