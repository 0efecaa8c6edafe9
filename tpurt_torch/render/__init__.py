"""Render entry point — port of ``tpurt.render.render_scene``.

``render_scene(config)`` renders ``config.spp`` samples per pixel in
progressive batches through the staged wave loop on the card (or on
``device="cpu"``, where every kernel runs its plain version) and returns
(FrameState, stats). It keeps the reference's safety nets: the uncapped
re-render when a live-wave cap cut alive rays, and the budget retries —
a render whose trace reported a pair-budget overflow (the per-tile clamp
or the pair-list capacities of ``bvh_tile``, or ``bvh_pair``'s pairs per
ray) is re-rendered with doubled budgets, and ``BudgetOverflowError`` is
raised when the retries run out.

A one-entry scene-context cache keeps the host scene, its device arrays,
its accel and the last staged renderer across calls, so the frames of a
flythrough (one scene, a new camera each) upload and build once; the
budget retries reuse the entry too (the budgets do not change the accel;
a retry builds a renderer with the doubled budgets).
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from tpurt_torch.core.camera import Camera
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render.intersectors import scene_meta
from tpurt_torch.render.png import write_png
from tpurt_torch.scene.device import to_device, torch_device
from tpurt_torch.scene.loader import load_scene
from tpurt_torch.utils.config import RenderConfig, get_config

# the one-entry scene-context cache (host scene, device arrays, accel),
# and how many contexts it has built
_SCENE_CACHE: dict = {}
_CACHE_BUILDS = [0]


class BudgetOverflowError(RuntimeError):
    """Pair-budget overflow persisted after all budget-doubling retries.

    The render proceeded with truncated traversal — trailing clusters were
    dropped and the image is missing hits. Raised (instead of returning a
    silently-wrong image) unless TPURT_ALLOW_OVERFLOW=1.
    """


def _check_supported(config: RenderConfig) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for every
    config the port does not carry yet."""
    kind = config.resolved_intersector()
    if kind not in ("bvh_tile", "bvh_pair", "bvh_packet"):
        raise NotImplementedError(
            f"intersector {kind!r} is not ported (ROADMAP §1 item 6: "
            "alternate pipelines and builders; bvh_tile, bvh_pair and "
            "bvh_packet are)")
    pipeline = config.resolved_pipeline()
    if pipeline != "staged":
        raise NotImplementedError(
            f"pipeline {pipeline!r} is not ported (ROADMAP §1 item 6: "
            "megakernel and wavefront pipelines)")
    if config.n_sample_shards * config.n_tile_shards > 1:
        raise NotImplementedError(
            "multi-device sharding is not ported (ROADMAP §1 item 5)")
    if config.sorted_wave:
        raise NotImplementedError(
            "the sorted-wave pipeline is not ported (ROADMAP §1 item 6)")
    if config.shading_mode not in ("full", "flat"):
        raise NotImplementedError(
            f"shading mode {config.shading_mode!r} is not a reference mode")


def build_accel(config: RenderConfig, ds, meta, scene=None, device="cuda"):
    """The accel on ``device`` (the card unless the caller asks for the
    CPU), picked as the reference picks it: the packet BVH for
    ``bvh_packet``; else the pair-cluster accel, for ``bvh_tile``
    two-level when the config asks for it, or on "auto" when instances
    reuse meshes at least 2× and the tables fit pair_meta's encoding;
    flat otherwise, and always flat for ``bvh_pair``."""
    from tpurt_torch.bvh.cluster import build_packet_accel
    from tpurt_torch.bvh.paircluster import (
        INST_SHIFT, ROWS_PER_CLUSTER, TRIS_PER_CLUSTER, build_pair_accel,
        build_pair_accel_two_level,
    )

    device = torch_device(device)
    if config.resolved_intersector() == "bvh_packet":
        return build_packet_accel(ds, meta, scene=scene).to(device)

    total_instanced = sum(meta.mesh_tri_ranges[m][1] for m in meta.inst_mesh)
    unique = sum(r[1] for r in meta.mesh_tri_ranges)
    n_inst = len(meta.inst_mesh)
    max_rows = (-(-unique // TRIS_PER_CLUSTER) * ROWS_PER_CLUSTER
                + len(meta.mesh_tri_ranges) * ROWS_PER_CLUSTER)
    # pair_meta packs a 20-bit row base and an 11-bit instance id
    fits = n_inst < (1 << (31 - INST_SHIFT)) and max_rows < (1 << INST_SHIFT)
    use_tl = config.resolved_intersector() == "bvh_tile" and (
        config.instancing == "two_level" or (
            config.instancing == "auto" and fits and n_inst > 1
            and total_instanced >= 2 * unique))
    build = build_pair_accel_two_level if use_tl else build_pair_accel
    return build(ds, meta, scene=scene).to(device)


def scene_context_builds() -> int:
    """How many scene contexts (upload + accel build) this process has
    made; a flythrough adds one for all its frames."""
    return _CACHE_BUILDS[0]


def _scene_context(config: RenderConfig, scene, device):
    """The cached (scene, meta, DeviceScene, accel) for this scene and
    config, built on a miss. Preset and file scenes key by name (their
    host scene is cached too); in-memory scenes by identity, held by the
    entry so no other scene can take its id, and by their table sizes so
    one grown in place misses. The key holds what the accel depends on —
    the intersector, the instancing and the native switch — and not the
    pair budgets, so a budget retry reuses the entry. A miss drops the
    old entry's tensors before it builds the new one."""
    if scene is None:
        scene_key = ("preset", config.scene)
        scene = _SCENE_CACHE.get(("host_scene", config.scene))
        if scene is None:
            scene = load_scene(config.scene)
    else:
        scene_key = ("object", id(scene), len(scene.meshes),
                     len(scene.instances), len(scene.materials),
                     len(scene.textures))
    key = (scene_key, str(device), config.resolved_intersector(),
           config.instancing, os.environ.get("TPURT_NO_NATIVE") == "1")
    ctx = _SCENE_CACHE.get(key)
    if ctx is None or ctx["scene"] is not scene:
        _SCENE_CACHE.clear()
        meta = scene_meta(scene)
        ds = to_device(scene, device)
        accel = build_accel(config, ds, meta, scene=scene, device=device)
        ctx = {"scene": scene, "meta": meta, "ds": ds, "accel": accel}
        _SCENE_CACHE[key] = ctx
        if scene_key[0] == "preset":
            _SCENE_CACHE[("host_scene", config.scene)] = scene
        _CACHE_BUILDS[0] += 1
    return ctx


def render_scene(
    config: RenderConfig,
    *,
    device="cuda",
    scene=None,
    camera: Optional[Camera] = None,
    state: Optional[fb.FrameState] = None,
    verbose: bool = False,
    readback_stats: bool = True,
    max_budget_retries: int = 3,
):
    """Render ``config.spp`` samples progressively on ``device`` (the card
    unless the caller asks for the CPU); returns (FrameState, stats).

    ``scene``: a host Scene (else built from ``config.scene``);
    ``camera`` overrides the scene camera; ``state`` resumes an earlier
    accumulation. Measured live-wave caps (``utils.autotune``) apply when
    the config carries none and ``TPURT_LIVE_TRUNC`` is not "0"; if a cap
    cut alive rays (stats ``live_overflow``), the frame is re-rendered
    uncapped with a warning. Under ``TPURT_AUTOTUNE_WRITE=1`` an uncapped
    render records its live and want counts (``autotune.record``).

    ``readback_stats=False`` keeps the ray counters on the device: the
    stats then carry them as ``counts_device`` (the layout of the staged
    loop's counters) and report the analytic ray count
    (``rays_estimated``); the overflow flags are not read, so neither
    safety net runs — the caller reads ``counts_device`` later (animate's
    deferred overflow accounting).

    Pair-budget safety, as in the reference: when a trace reports a
    pair-budget overflow (stats ``pair_overflow`` — clusters dropped,
    hits lost), the frame is re-rendered from the caller's ``state`` with
    doubled budgets (``pairs_per_tile``, ``pairs_avg*``,
    ``pairs_per_ray``), up to ``max_budget_retries`` times;
    ``budget_retries`` records how many doublings were needed. If the
    overflow persists after the last retry the image is wrong and
    ``BudgetOverflowError`` is raised; ``TPURT_ALLOW_OVERFLOW=1`` turns it
    into a RuntimeWarning and returns the truncated image (the stats
    still record the overflow).
    """
    from tpurt_torch.utils import autotune

    device = torch_device(device)
    _check_supported(config)
    if os.environ.get("TPURT_LIVE_TRUNC", "1") == "1":
        if not config.live_caps:
            caps = autotune.live_caps_for(config)
            if caps:
                config = dataclasses.replace(config, live_caps=caps)
        if not config.shadow_caps and config.use_nee:
            scaps = autotune.want_caps_for(config)
            if scaps:
                config = dataclasses.replace(config, shadow_caps=scaps)
    ctx = _scene_context(config, scene, device)
    retries = 0
    while True:
        out_state, stats = _render_scene_once(config, ctx, camera, state,
                                              verbose, device,
                                              readback_stats)
        stats["budget_retries"] = retries
        if (not config.live_caps
                and os.environ.get("TPURT_AUTOTUNE_WRITE") == "1"):
            autotune.record(config, stats)
        if stats["live_overflow"]:
            warnings.warn(
                "live-wave cap truncated alive rays "
                f"(caps={config.live_caps}, shadow={config.shadow_caps}) — "
                "re-rendering uncapped",
                RuntimeWarning,
            )
            config = dataclasses.replace(config, live_caps=(),
                                         shadow_caps=())
            continue
        if not stats["pair_overflow"]:
            return out_state, stats
        if retries >= max_budget_retries:
            msg = (
                f"pair-budget overflow persists after {retries} "
                f"budget-doubling retries "
                f"({stats['pair_overflow_events']} overflow events this "
                f"frame; budgets now avg={config.pairs_avg}/"
                f"{config.pairs_avg_bounce}/{config.pairs_avg_shadow}, "
                f"per_tile={config.pairs_per_tile}) — traversal was "
                "truncated and the image is wrong. Raise the pairs_* "
                "budgets in the config, or set TPURT_ALLOW_OVERFLOW=1 to "
                "accept the truncated image."
            )
            if os.environ.get("TPURT_ALLOW_OVERFLOW") == "1":
                warnings.warn(msg, RuntimeWarning)
                return out_state, stats
            raise BudgetOverflowError(msg)
        retries += 1
        dbl = lambda v: v * 2 if v > 0 else 0
        config = dataclasses.replace(
            config,
            pairs_per_tile=dbl(config.pairs_per_tile),
            pairs_avg=dbl(config.pairs_avg),
            pairs_avg_bounce=dbl(config.pairs_avg_bounce),
            pairs_avg_shadow=dbl(config.pairs_avg_shadow),
            pairs_per_ray=config.pairs_per_ray * 2,
        )
        if verbose:
            print(f"  pair-budget overflow: retrying with doubled budgets "
                  f"(per_tile={config.pairs_per_tile}, "
                  f"per_ray={config.pairs_per_ray})")


def _render_scene_once(config, ctx, camera, state, verbose, device,
                       readback_stats=True):
    from tpurt_torch.render.staged import StagedRenderer

    cam = camera if camera is not None else ctx["scene"].camera
    if cam is None:
        raise ValueError("scene has no camera")
    spp_fit = max(1, config.max_rays_per_batch
                  // (config.width * config.height))
    if config.spp_per_batch > spp_fit:
        config = dataclasses.replace(config, spp_per_batch=spp_fit)

    # the entry keeps its last renderer (pixel orders, intersectors) for
    # the configs that differ only in what a batch does not read, under
    # the same launch switches (the tile intersector reads them when built)
    key = (dataclasses.replace(config, spp=0, seed=0, exposure=1.0),
           os.environ.get("TPURT_PAIR_LOOP"),
           os.environ.get("TPURT_ENTRY_ROWS"))
    if ctx.get("renderer_key") != key:
        ctx["renderer"] = StagedRenderer(ctx["ds"], ctx["accel"],
                                         meta=ctx["meta"], config=config,
                                         device=device)
        ctx["renderer_key"] = key
    renderer = ctx["renderer"]
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
    mb = config.max_bounces
    estimated = not readback_stats or total_rays is None
    if not estimated:
        # counters are read back after the timed section
        rays = total_rays.cpu().numpy()
    else:
        # the analytic count: one closest ray per path vertex, and with
        # NEE one shadow ray per vertex, for the samples accumulated
        closest_ps = config.width * config.height * (1 + mb)
        shadow_ps = (closest_ps if config.use_nee
                     and config.shading_mode == "full" else 0)
        done = int(state.n_samples)
        rays = np.zeros(4)  # no live or want counts
        rays[0], rays[1] = closest_ps * done, shadow_ps * done
    n_rays = float(rays[0] + rays[1])
    stats = {
        "elapsed_s": elapsed,
        "spp": int(state.n_samples),
        "rays_closest": float(rays[0]),
        "rays_shadow": float(rays[1]),
        "rays_traced": n_rays,
        "rays_estimated": estimated,
        "pair_overflow": bool(rays[2] > 0.0),
        "pair_overflow_events": float(rays[2]),
        "live_overflow": bool(rays[3] > 0.0),
        # live-after-bounce-b then want-at-bounce-b
        "live_counts": [float(v) for v in rays[4:4 + mb + 1]],
        "want_counts": [float(v) for v in rays[4 + mb + 1:]],
        "mrays_per_s": n_rays / max(elapsed, 1e-9) / 1e6,
        "device": str(device),
    }
    if not readback_stats and total_rays is not None:
        stats["counts_device"] = total_rays
    return state, stats


def render_to_png(name_or_config, path: str, *, device="cuda",
                  verbose: bool = False, **overrides):
    """One-call demo: preset/config → PNG file, rendered on ``device``
    (the card unless the caller asks for the CPU)."""
    config = (
        name_or_config
        if isinstance(name_or_config, RenderConfig)
        else get_config(name_or_config, **overrides)
    )
    state, stats = render_scene(config, device=device, verbose=verbose)
    img = fb.to_png_array(state, config.exposure)
    write_png(path, img)
    return img, stats
