"""Render entry point — port of ``tpurt.render.render_scene``.

``render_scene(config)`` renders ``config.spp`` samples per pixel in
progressive batches on the card (or on ``device="cpu"``, where every
kernel runs its plain version) and returns (FrameState, stats). The
config picks the pipeline — the staged wave loop (the port's default,
and with ``sorted_wave`` or ``TPURT_SORTED_WAVE=1`` its sorted-wave
variant), the megakernel (``"mega"``) or the wavefront loop — and the
intersector: ``bvh_tile`` (the default), ``bvh_pair``, ``bvh_packet``,
the two-level LBVH walk (``"bvh"``) or the dense brute force
(``"brute"``). It keeps the reference's safety nets: the uncapped
re-render when a live-wave cap cut alive rays, and the budget retries —
a render whose trace reported a pair-budget overflow (the per-tile clamp
or the pair-list capacities of ``bvh_tile``, or ``bvh_pair``'s pairs per
ray) is re-rendered with doubled budgets, and ``BudgetOverflowError`` is
raised when the retries run out.

A config with more than one sample or tile shard renders on a
("sample", "tile") mesh of ranks (``tpurt_torch.parallel``): a world of
``n_sample_shards * n_tile_shards`` processes, each calling
``render_scene`` with the same config. The staged loop traces the rank's
shard (``StagedRenderer(mesh=...)``); the megakernel and the wavefront
loop run the megakernel's shards (``render_batch_distributed``), as the
reference does. A batch then adds ``spp_per_batch * n_sample_shards``
samples, and every rank ends it with the whole frame and the world's
counters, so the re-renders and retries below are taken by every rank
alike.

A one-entry scene-context cache keeps the host scene, its device arrays,
its accel and the last renderer across calls, so the frames of a
flythrough (one scene, a new camera each) upload and build once; the
budget retries reuse the entry too (the budgets do not change the accel;
a retry builds a renderer with the doubled budgets).

A staged renderer runs its stage programs as CUDA graphs on the card
(``tpurt_torch.render.staged``): under ``TPURT_PREWARM`` (default "1")
``render_scene`` captures them with ``renderer.prewarm`` when it builds
the renderer, before the timed batches, as the reference prewarms its
stage executables; a flythrough's frames replay them with each frame's
camera.

While the recorder is on (``tpurt_torch.utils.profiling.record``) a call
records its spans: ``render`` (the call), ``caps``, ``scene_context``
(``accel.build`` inside on a miss, and inside that a pair-cluster
build's ``accel.order``, ``accel.pack`` and ``accel.shade_rows``; the
build's counts are ``accel_build_record``), ``renderer.build``,
``prewarm``, a ``batch`` a batch (``accumulate`` inside, and the staged
loop's own spans) and ``readback``.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from tpurt_torch import kernels
from tpurt_torch.bvh.paircluster import clustering_mode
from tpurt_torch.core.camera import Camera
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render.intersectors import scene_meta
from tpurt_torch.render.png import write_png
from tpurt_torch.scene.device import to_device, torch_device
from tpurt_torch.scene.loader import load_scene
from tpurt_torch.utils import profiling
from tpurt_torch.utils.config import RenderConfig, get_config

# the switches a renderer reads when it is built (the tile intersector's
# and the staged loop's): a renderer is kept only under the same values
RENDERER_SWITCHES = ("TPURT_PAIR_LOOP", "TPURT_ENTRY_ROWS",
                     "TPURT_SORTED_WAVE", "TPURT_SUPERCLUSTER",
                     "TPURT_EXACT_MASK", "TPURT_FUSED_ENTRIES",
                     "TPURT_CAPTURE_WAVES", "TPURT_DEBUG_STAGES",
                     "TPURT_FUSE_STAGES", "TPURT_FUSE_BOUNCES")

# the one-entry scene-context cache (host scene, device arrays, accel),
# and how many contexts it has built
_SCENE_CACHE: dict = {}
_CACHE_BUILDS = [0]
# the last accel build (``accel_build_record``)
_ACCEL_RECORD: dict = {}


class BudgetOverflowError(RuntimeError):
    """Pair-budget overflow persisted after all budget-doubling retries.

    The render proceeded with truncated traversal — trailing clusters were
    dropped and the image is missing hits. Raised (instead of returning a
    silently-wrong image) unless TPURT_ALLOW_OVERFLOW=1.
    """


def _check_supported(config: RenderConfig) -> None:
    """Raise ValueError for a pipeline, intersector or shading mode the
    reference does not have."""
    kind = config.resolved_intersector()
    if kind not in ("brute", "bvh", "bvh_tile", "bvh_pair", "bvh_packet"):
        raise ValueError(f"intersector {kind!r} is not a reference "
                         "intersector")
    if config.resolved_pipeline() not in ("staged", "mega", "wavefront"):
        raise ValueError(f"pipeline {config.pipeline!r} is not a reference "
                         "pipeline")
    if config.shading_mode not in ("full", "flat"):
        raise ValueError(
            f"shading mode {config.shading_mode!r} is not a reference mode")


def build_accel(config: RenderConfig, ds, meta, scene=None, device="cuda"):
    """The accel on ``device`` (the card unless the caller asks for the
    CPU), picked as the reference picks it: none for ``brute`` (the
    dense brute force), the two-level LBVH for ``bvh`` (built where
    ``ds`` lives, with ``config.bvh_leaf_size``), the packet BVH for
    ``bvh_packet``; else the pair-cluster accel, for ``bvh_tile``
    two-level when the config asks for it, or on "auto" when instances
    reuse meshes at least 2× and the tables fit pair_meta's encoding;
    flat otherwise, and always flat for ``bvh_pair``."""
    from tpurt_torch.bvh.cluster import build_packet_accel
    from tpurt_torch.bvh.paircluster import (
        INST_SHIFT, ROWS_PER_CLUSTER, TRIS_PER_CLUSTER, build_pair_accel,
        build_pair_accel_two_level,
    )
    from tpurt_torch.bvh.two_level import build_scene_accel

    device = torch_device(device)
    kind = config.resolved_intersector()
    if kind == "brute":
        return None
    if kind == "bvh":
        # on the DeviceScene's device (the caller's: the scene context
        # uploads it there first)
        return build_scene_accel(ds, meta,
                                 leaf_size=config.bvh_leaf_size).to(device)
    if kind == "bvh_packet":
        return build_packet_accel(ds, meta, scene=scene).to(device)

    total_instanced = sum(meta.mesh_tri_ranges[m][1] for m in meta.inst_mesh)
    unique = sum(r[1] for r in meta.mesh_tri_ranges)
    n_inst = len(meta.inst_mesh)
    max_rows = (-(-unique // TRIS_PER_CLUSTER) * ROWS_PER_CLUSTER
                + len(meta.mesh_tri_ranges) * ROWS_PER_CLUSTER)
    # pair_meta packs a 20-bit row base and an 11-bit instance id
    fits = n_inst < (1 << (31 - INST_SHIFT)) and max_rows < (1 << INST_SHIFT)
    use_tl = kind == "bvh_tile" and (
        config.instancing == "two_level" or (
            config.instancing == "auto" and fits and n_inst > 1
            and total_instanced >= 2 * unique))
    build = build_pair_accel_two_level if use_tl else build_pair_accel
    return build(ds, meta, scene=scene).to(device)


def accel_build_record() -> dict:
    """The last scene context's accel build, kept whether or not the
    recorder is on: ``kind`` (the accel's type, None for the brute
    force), ``seconds`` (``build``: the whole build with its upload, and
    a pair-cluster build's phases ``order``, ``pack`` and ``shade_rows``,
    ``bvh.paircluster.last_build_phases``), and the counts
    ``triangles`` (after instancing), ``clusters`` (a pair-cluster
    accel's cluster entries: instance-clusters on the two-level one),
    ``superclusters`` (0 where the accel has none), ``bytes`` (its
    tables), ``instances`` and ``stored_triangles`` (those the accel
    holds: each mesh's once in a two-level accel, every instance's in a
    flat one). Empty before the first build. While recording, the counts
    are also the counters ``accel.<count>``."""
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in _ACCEL_RECORD.items()}


def _record_accel_build(accel, meta, seconds: float) -> None:
    from tpurt_torch.bvh import paircluster
    from tpurt_torch.bvh.two_level import SceneAccel

    tables = [] if accel is None else [a for a in accel
                                       if isinstance(a, torch.Tensor)]
    pair = isinstance(accel, (paircluster.PairAccel,
                              paircluster.PairAccelTL))
    sc = getattr(accel, "sc_meta", None)
    instanced = sum(meta.mesh_tri_ranges[m][1] for m in meta.inst_mesh)
    two_level = isinstance(accel, (paircluster.PairAccelTL, SceneAccel))
    counts = {
        "triangles": instanced,
        "clusters": int(accel.cluster_lo.shape[0]) if pair else 0,
        "superclusters": int(sc.shape[0]) if pair and sc is not None else 0,
        "bytes": sum(t.numel() * t.element_size() for t in tables),
        "instances": len(meta.inst_mesh),
        "stored_triangles": (sum(n for _, n in meta.mesh_tri_ranges)
                             if two_level else instanced),
    }
    _ACCEL_RECORD.clear()
    _ACCEL_RECORD.update(
        kind=None if accel is None else type(accel).__name__,
        seconds={"build": seconds,
                 **(paircluster.last_build_phases() if pair else {})},
        **counts)
    for name, n in counts.items():
        profiling.count("accel." + name, n)


def scene_context_builds() -> int:
    """How many scene contexts (upload + accel build) this process has
    made; a flythrough adds one for all its frames."""
    return _CACHE_BUILDS[0]


def _scene_context(config: RenderConfig, scene, device, mesh=None):
    """The cached (scene, meta, DeviceScene, accel) for this scene and
    config, built on a miss. Preset and file scenes key by name (their
    host scene is cached too); in-memory scenes by identity, held by the
    entry so no other scene can take its id, and by their table sizes so
    one grown in place misses. The key holds what the accel depends on —
    the intersector, the instancing, the LBVH's leaf size, the native
    switch and the clustering (``TPURT_CLUSTERING``) — and the mesh's
    shape, and not the pair budgets, so a budget
    retry reuses the entry. A miss drops the old entry's tensors before it
    builds the new one."""
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
           config.instancing, config.bvh_leaf_size,
           os.environ.get("TPURT_NO_NATIVE") == "1", clustering_mode(),
           _mesh_key(mesh))
    ctx = _SCENE_CACHE.get(key)
    if ctx is None or ctx["scene"] is not scene:
        _SCENE_CACHE.clear()
        meta = scene_meta(scene)
        ds = to_device(scene, device=device)
        t = time.perf_counter()
        with profiling.span("accel.build"):
            accel = build_accel(config, ds, meta, scene=scene, device=device)
        _record_accel_build(accel, meta, time.perf_counter() - t)
        ctx = {"scene": scene, "meta": meta, "ds": ds, "accel": accel}
        _SCENE_CACHE[key] = ctx
        if scene_key[0] == "preset":
            _SCENE_CACHE[("host_scene", config.scene)] = scene
        _CACHE_BUILDS[0] += 1
    return ctx


def render_scene(
    config: RenderConfig,
    scene=None,
    camera: Optional[Camera] = None,
    state: Optional[fb.FrameState] = None,
    verbose: bool = False,
    readback_stats: bool = True,
    max_budget_retries: int = 3,
    *,
    device="cuda",
):
    """Render ``config.spp`` samples progressively on ``device`` (the card
    unless the caller asks for the CPU); returns (FrameState, stats).

    ``scene``: a host Scene (else built from ``config.scene``);
    ``camera`` overrides the scene camera; ``state`` resumes an earlier
    accumulation. Measured live-wave caps (``utils.autotune``) apply when
    the config carries none and ``TPURT_LIVE_TRUNC`` is not "0"; if a cap
    cut alive rays (stats ``live_overflow``), the frame is re-rendered
    uncapped with a warning (stats ``rerenders`` counts them). Under ``TPURT_AUTOTUNE_WRITE=1`` an uncapped
    render records its live and want counts (``autotune.record``).
    Stats ``shade_waves_cuda``: the waves the staged loop's shade kernel
    shaded in the call, flat and two-level (0 on the PyTorch shade:
    ``StagedRenderer``'s ``shade_path``).

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
    with profiling.span("render"):
        return _render_scene(config, scene, camera, state, verbose,
                             readback_stats, max_budget_retries, device)


def _render_scene(config, scene, camera, state, verbose, readback_stats,
                  max_budget_retries, device):
    from tpurt_torch.utils import autotune

    device = torch_device(device)
    _check_supported(config)
    mesh = None
    if config.n_sample_shards * config.n_tile_shards > 1:
        from tpurt_torch.parallel.mesh import make_render_mesh

        mesh = make_render_mesh(config.n_sample_shards,
                                config.n_tile_shards, device=device)
        device = mesh.device
    if os.environ.get("TPURT_LIVE_TRUNC", "1") == "1":
        with profiling.span("caps"):
            if not config.live_caps:
                caps = autotune.live_caps_for(config)
                if caps:
                    config = dataclasses.replace(config, live_caps=caps)
            if not config.shadow_caps and config.use_nee:
                scaps = autotune.want_caps_for(config)
                if scaps:
                    config = dataclasses.replace(config, shadow_caps=scaps)
    with profiling.span("scene_context"):
        ctx = _scene_context(config, scene, device, mesh)
    retries = rerenders = 0
    s1_waves = lambda: sum(kernels.counts().get(k, 0)
                           for k in ("shade", "shade_tl"))
    shaded = s1_waves()
    while True:
        out_state, stats = _render_scene_once(config, ctx, camera, state,
                                              verbose, device,
                                              readback_stats, mesh)
        stats["budget_retries"] = retries
        stats["rerenders"] = rerenders
        stats["shade_waves_cuda"] = s1_waves() - shaded
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
            rerenders += 1
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


def _mesh_key(mesh):
    return None if mesh is None else (mesh.n_sample, mesh.n_tile, mesh.rank)


def _make_renderer(config, ctx, device, mesh=None):
    """One batch of ``config``'s pipeline: ``renderer(cam, seed,
    sample0) -> ((H, W, 3) radiance sum, counters)``; on a mesh, the
    world's batch (the megakernel's shards for the mega and wavefront
    pipelines, as in the reference), cropped to the frame."""
    ds, accel, meta = ctx["ds"], ctx["accel"], ctx["meta"]
    pipeline = config.resolved_pipeline()
    if pipeline == "staged":
        from tpurt_torch.render.staged import make_staged_renderer

        return make_staged_renderer(ds, accel, meta=meta, config=config,
                                    mesh=mesh, device=device)
    if mesh is not None:
        from tpurt_torch.parallel.mesh import (distributed_spec,
                                               render_batch_distributed)

        rows_per_shard, _ = distributed_spec(config, mesh)

        def sharded(cam, seed, sample0):
            img, counts = render_batch_distributed(
                ds, cam, seed, sample0, accel, meta=meta, config=config,
                mesh=mesh, rows_per_shard=rows_per_shard)
            return img[:config.height], counts

        return sharded
    if pipeline == "mega":
        from tpurt_torch.render.integrator import render_batch as batch
    else:
        from tpurt_torch.render.wavefront import \
            render_batch_wavefront as batch

    def renderer(cam, seed, sample0):
        return batch(ds, cam, seed, sample0, accel, meta=meta, config=config)

    return renderer


def _prewarm(renderer, cam, state, verbose: bool) -> None:
    """A new staged renderer's stage graphs, captured before its first
    batch under ``TPURT_PREWARM`` (default "1"), as the reference
    prewarms its stage executables; under ``verbose`` how many, or why
    its path runs eagerly."""
    prewarm = getattr(renderer, "prewarm", None)
    if prewarm is None:  # the megakernel and wavefront loops
        return
    if verbose and renderer.graph_reason:
        print(f"  stage programs run eagerly: {renderer.graph_reason}")
    if verbose:
        print(f"  shade path: {renderer.shade_path}"
              + (f" ({renderer.shade_reason})" if renderer.shade_reason
                 else ""))
    if os.environ.get("TPURT_PREWARM", "1") == "1":
        n_ready = prewarm(cam, state.seed, state.n_samples)
        if verbose and n_ready:
            print(f"  prewarmed {n_ready} stage graphs")


def _render_scene_once(config, ctx, camera, state, verbose, device,
                       readback_stats=True, mesh=None):
    cam = camera if camera is not None else ctx["scene"].camera
    if cam is None:
        raise ValueError("scene has no camera")
    spp_fit = max(1, config.max_rays_per_batch
                  // (config.width * config.height))
    if config.spp_per_batch > spp_fit:
        config = dataclasses.replace(config, spp_per_batch=spp_fit)

    # the entry keeps its last renderer (pixel orders, intersectors) for
    # the configs that differ only in what a batch does not read, under
    # the same switches (the tile intersector and the staged loop read
    # them when built); the config holds the pipeline
    key = (dataclasses.replace(config, spp=0, seed=0, exposure=1.0),
           *(os.environ.get(k) for k in RENDERER_SWITCHES), _mesh_key(mesh))
    if state is None:
        state = fb.new_frame_state(config.width, config.height,
                                   config.seed, device=device)
    if ctx.get("renderer_key") != key:
        # the old renderer (and its graphs) go before new ones are made
        ctx.pop("renderer", None)
        ctx.pop("renderer_key", None)
        with profiling.span("renderer.build"):
            renderer = _make_renderer(config, ctx, device, mesh)
        with profiling.span("prewarm"):
            _prewarm(renderer, cam, state, verbose)
        ctx["renderer"], ctx["renderer_key"] = renderer, key
    renderer = ctx["renderer"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # a batch adds spp_per_batch samples on each sample shard
    spp_batch = config.spp_per_batch * config.n_sample_shards
    n_batches = -(-config.spp // spp_batch)
    sync()
    t0 = time.perf_counter()
    total_rays = None
    for _ in range(int(state.batch_index), n_batches):
        with profiling.span("batch"):
            radiance_sum, counts = renderer(cam, state.seed, state.n_samples)
            with profiling.span("accumulate"):
                state = fb.accumulate(state, radiance_sum, spp_batch)
            total_rays = counts if total_rays is None else total_rays + counts
        if verbose:
            sync()
            print(f"  batch {state.batch_index}/{n_batches} "
                  f"({state.n_samples} spp) "
                  f"{time.perf_counter() - t0:.3f}s")
    mb = config.max_bounces
    estimated = not readback_stats or total_rays is None
    with profiling.span("readback"):
        sync()
        elapsed = time.perf_counter() - t0
        if not estimated:
            # counters are read back after the timed section
            rays = total_rays.cpu().numpy()
    if estimated:
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
        # the megakernel and wavefront loops count no live overflow
        "live_overflow": bool(len(rays) > 3 and rays[3] > 0.0),
        # live-after-bounce-b then want-at-bounce-b
        "live_counts": [float(v) for v in rays[4:4 + mb + 1]],
        "want_counts": [float(v) for v in rays[4 + mb + 1:]],
        "mrays_per_s": n_rays / max(elapsed, 1e-9) / 1e6,
        "device": str(device),
    }
    if not readback_stats and total_rays is not None:
        stats["counts_device"] = total_rays
    return state, stats


def estimate_rays(config: RenderConfig) -> int:
    """Rays per sample per pixel over the frame: the primary ray and one
    per bounce, and with NEE one shadow ray per path vertex too — the
    upper bound behind the analytic ray count."""
    per_path = 1 + config.max_bounces
    if config.use_nee and config.shading_mode == "full":
        per_path += 1 + config.max_bounces
    return config.width * config.height * per_path


def render_to_png(name_or_config, path: str, verbose: bool = False, *,
                  device="cuda", **overrides):
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
