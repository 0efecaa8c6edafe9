"""Command line — port of ``tpurt.cli``:

  python -m tpurt_torch render  --config cornell_pt --out out.png
  python -m tpurt_torch render  --config scene.glb --checkpoint ck.npz
  python -m tpurt_torch render  --config bunny --resume ck.npz --spp 32
  python -m tpurt_torch animate --config sponza --frames 24 --out-dir frames/
  python -m tpurt_torch export  --config sponza --out sponza.glb
  python -m tpurt_torch info

Every command renders on the card; ``--cpu`` renders on the CPU instead
(every kernel then runs its plain version). Without ``--cpu`` and without
a card, a render raises: nothing falls back to the CPU silently.
``render`` writes and resumes checkpoints (``--checkpoint``/``--resume``)
and ``--profile DIR`` writes a ``torch.profiler`` trace there
(``utils.profiling.trace``).
``animate`` renders a camera path (sponza's atrium flythrough, or an
orbit) with one upload and accel build for all its frames.

``--pipeline`` picks the staged loop (``auto``), the megakernel or the
wavefront loop, and ``--intersector`` the tile, pair, packet, LBVH
(``bvh``) or brute-force intersector.

Multi-GPU: ``--sample-shards S --tile-shards T`` render on a world of
S·T processes, one a shard, each running the same command with
``--multihost``, which joins it to the world before rendering — through
torchrun's environment::

  torchrun --nproc-per-node 4 -m tpurt_torch render --multihost \
      --sample-shards 2 --tile-shards 2 --config bunny

or through a coordinator that rank 0 serves (``--coordinator HOST:PORT
--num-processes N --process-id I``, once for each rank I, on any host).
Every rank renders its shard and ends with the whole frame; only rank 0
writes files (the PNG, the checkpoint, the frames).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time


def _add_config_overrides(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--config", default="cornell",
                    help="preset name or scene file (.obj/.gltf/.glb)")
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--spp", type=int)
    ap.add_argument("--spp-per-batch", type=int, dest="spp_per_batch")
    ap.add_argument("--max-bounces", type=int, dest="max_bounces")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--exposure", type=float)
    ap.add_argument("--intersector",
                    choices=["auto", "brute", "bvh", "bvh_packet",
                             "bvh_pair", "bvh_tile"])
    ap.add_argument("--pipeline",
                    choices=["auto", "mega", "staged", "wavefront"])
    ap.add_argument("--no-nee", action="store_true",
                    help="disable next-event estimation")
    ap.add_argument("--sample-shards", type=int, dest="n_sample_shards",
                    help="X2 sample-parallel axis size (ranks)")
    ap.add_argument("--tile-shards", type=int, dest="n_tile_shards",
                    help="X1 tile-parallel axis size (ranks)")
    ap.add_argument("--texture-filter", dest="texture_filter",
                    choices=["nearest", "bilinear"],
                    help="base-color sampling (bilinear = glTF LINEAR)")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (the kernels' plain versions)")
    ap.add_argument("--multihost", action="store_true",
                    help="join a torch.distributed world of ranks before "
                         "rendering (torchrun's environment, or "
                         "--coordinator)")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port, served by rank 0 "
                         "(multihost; omit under torchrun)")
    ap.add_argument("--num-processes", type=int, dest="num_processes",
                    help="total process count (multihost)")
    ap.add_argument("--process-id", type=int, dest="process_id",
                    help="this process's index (multihost)")


def _build_config(args):
    from tpurt_torch.utils.config import get_config

    overrides = {}
    for field in ("width", "height", "spp", "spp_per_batch", "max_bounces",
                  "seed", "exposure", "intersector", "pipeline",
                  "n_sample_shards", "n_tile_shards", "texture_filter"):
        v = getattr(args, field, None)
        if v is not None:
            overrides[field] = v
    if getattr(args, "no_nee", False):
        overrides["use_nee"] = False
    return get_config(args.config, **overrides)


def _device(args) -> str:
    return "cpu" if getattr(args, "cpu", False) else "cuda"


def _join_world(args) -> int:
    """Under ``--multihost``, join the world of ranks and print which
    rank this process is; returns the rank (0 without ``--multihost``)."""
    if not getattr(args, "multihost", False):
        return 0
    import torch.distributed as dist

    from tpurt_torch.parallel import init_multihost

    rank, world = init_multihost(args.coordinator, args.num_processes,
                                 args.process_id, device=_device(args))
    print(f"multihost: process {rank}/{world} (backend "
          f"{dist.get_backend()})")
    return rank


@contextlib.contextmanager
def _environ(**env):
    """The variables in ``env`` set inside the block, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cmd_render(args) -> int:
    from tpurt_torch.render import framebuffer as fb
    from tpurt_torch.render import render_scene
    from tpurt_torch.render.checkpoint import load_checkpoint, save_checkpoint
    from tpurt_torch.render.png import write_png

    rank = _join_world(args)
    config = _build_config(args)
    device = _device(args)
    state = None
    if args.resume:
        state, ck_config, _ = load_checkpoint(args.resume, device=device)
        if ck_config is not None:
            # the command line's values win over the checkpoint's where
            # they differ from the defaults
            merged = dataclasses.asdict(ck_config)
            default = type(config)()
            for k, v in dataclasses.asdict(config).items():
                if v != getattr(default, k):
                    merged[k] = v
            config = type(config)(**merged)
        print(f"resumed at {int(state.n_samples)} spp from {args.resume}")

    t0 = time.perf_counter()
    state, stats = render_scene(config, device=device, state=state,
                                verbose=args.verbose)
    if rank == 0:
        if args.checkpoint:
            save_checkpoint(args.checkpoint, state, config)
            print(f"checkpoint → {args.checkpoint}")
        write_png(args.out, fb.to_png_array(state, config.exposure))
    print(
        f"{args.out}: {config.width}x{config.height} {stats['spp']} spp, "
        f"{stats['mrays_per_s']:.2f} Mrays/s, "
        f"{time.perf_counter() - t0:.2f}s total"
    )
    return 0


def cmd_animate(args) -> int:
    """One PNG a frame along the scene's camera path; the accumulation
    starts afresh at every camera. Frames stay on the device and are
    written every ``--readback-chunk`` frames (0: once at the end), their
    ray counters read with them: a frame whose live cap cut alive rays,
    or whose pair budget overflowed, is re-rendered uncapped and its PNG
    rewritten. ``--autotune`` renders uncapped, reads the counters every
    frame and records the largest live/want counts of the path in the
    autotune cache. In a world of ranks every rank renders every frame
    and only rank 0 writes them."""
    from tpurt_torch.render import framebuffer as fb
    from tpurt_torch.render import render_scene
    from tpurt_torch.render.png import write_png
    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.scene.procedural import flythrough_cameras

    rank = _join_world(args)
    config = _build_config(args)
    device = _device(args)
    scene = load_scene(config.scene)
    cams = flythrough_cameras(config.scene, args.frames)
    if rank == 0:
        os.makedirs(args.out_dir, exist_ok=True)
    autotune = getattr(args, "autotune", False)
    env = (dict(TPURT_LIVE_TRUNC="0", TPURT_AUTOTUNE_WRITE="1") if autotune
           else {})
    chunk = args.readback_chunk
    frames = []  # (frame index, packed u8 image on the device, counters)
    overflow_frames = []
    total_rays = 0.0

    def frame_png(idx):
        return os.path.join(args.out_dir, f"frame_{idx:04d}.png")

    def flush():
        for idx, img, counts in frames:
            if rank == 0:
                write_png(frame_png(idx), img.cpu().numpy())
            if counts is not None:
                c = counts.cpu().numpy()
                if (c[2:4] > 0.0).any():  # pair or live-cap overflow
                    overflow_frames.append(idx)
        frames.clear()

    t0 = time.perf_counter()
    with _environ(**env):
        for f, cam in enumerate(cams):
            state, stats = render_scene(config, device=device, scene=scene,
                                        camera=cam, readback_stats=autotune)
            total_rays += stats["rays_traced"]
            frames.append((f, fb.pack_u8(fb.tonemap(fb.resolve(state),
                                                    config.exposure)),
                           stats.get("counts_device")))
            if chunk and len(frames) >= chunk:
                flush()
            if args.verbose:
                print(f"  frame {f + 1}/{len(cams)}: "
                      f"{stats['mrays_per_s']:.2f} Mrays/s"
                      f"{' (est)' if stats['rays_estimated'] else ''}")
        flush()
    elapsed = time.perf_counter() - t0
    if overflow_frames:
        import warnings

        warnings.warn(
            f"live caps or pair budgets truncated frames {overflow_frames}"
            " — re-rendering those frames uncapped", RuntimeWarning)
        uncapped = dataclasses.replace(config, live_caps=(), shadow_caps=())
        with _environ(TPURT_LIVE_TRUNC="0"):
            for idx in overflow_frames:
                state, _ = render_scene(uncapped, device=device, scene=scene,
                                        camera=cams[idx])
                if rank == 0:
                    write_png(frame_png(idx),
                              fb.to_png_array(state, config.exposure))
    print(
        f"{len(cams)} frames → {args.out_dir} in {elapsed:.1f}s "
        f"({elapsed / len(cams) * 1e3:.0f} ms/frame, "
        f"{total_rays / elapsed / 1e6:.2f} Mrays/s, "
        f"{len(overflow_frames)} capped-frame overflow(s))"
    )
    return 0


def cmd_export(args) -> int:
    """Write a scene (preset or file) as a standard .obj/.glb/.gltf
    asset, which the loaders read back."""
    from tpurt_torch.scene.export import export_scene
    from tpurt_torch.scene.loader import load_scene

    scene = load_scene(args.config)
    export_scene(args.out, scene)
    print(f"{args.out}: {len(scene.meshes)} meshes, "
          f"{len(scene.instances)} instances, "
          f"{scene.num_triangles} unique tris")
    return 0


def cmd_info(args) -> int:
    import torch

    from tpurt_torch.kernels import cuda_build
    from tpurt_torch.utils import native
    from tpurt_torch.utils.config import PRESETS, RenderConfig

    n = 0 if args.cpu or not torch.cuda.is_available() else \
        torch.cuda.device_count()
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{n} CUDA device(s){' (--cpu)' if args.cpu else ''}:")
    for d in range(n):
        p = torch.cuda.get_device_properties(d)
        print(f"  [cuda:{d}] {p.name}, {p.total_memory / (1 << 30):.1f} GiB, "
              f"sm_{p.major}{p.minor}, {p.multi_processor_count} SMs")
    print("presets:", ", ".join(sorted(PRESETS)))
    auto = RenderConfig()
    print(f"pipeline: auto → {auto.resolved_pipeline()} (also mega, "
          "wavefront; staged with sorted_wave / TPURT_SORTED_WAVE=1)")
    print(f"intersector: auto → {auto.resolved_intersector()} (also "
          "bvh_pair, bvh_packet, bvh (two-level LBVH), brute)")
    lib = native.get_lib()
    print(f"native host library: "
          + (f"loaded ({native.SO})" if lib is not None else
             "off (TPURT_NO_NATIVE=1)"
             if os.environ.get("TPURT_NO_NATIVE") == "1" else
             f"not loaded: {native.build_error() or 'unknown'}"))
    built = sorted(f for f in os.listdir(cuda_build.BUILD)
                   if f.endswith(".so") and f != os.path.basename(native.SO)
                   ) if os.path.isdir(cuda_build.BUILD) else []
    print(f"CUDA kernels: sources {cuda_build.CSRC}, built at first use "
          f"into {cuda_build.BUILD} ({len(built)} build(s) there)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpurt_torch", description="the tpurt ray tracer on CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render one config to a PNG")
    _add_config_overrides(r)
    r.add_argument("--out", default="out.png")
    r.add_argument("--checkpoint", help="write FrameState .npz after render")
    r.add_argument("--resume", help="resume from a FrameState .npz")
    r.add_argument("--profile",
                   help="write a torch.profiler trace into this directory")
    r.add_argument("--verbose", "-v", action="store_true")
    r.set_defaults(fn=cmd_render)

    a = sub.add_parser("animate", help="render a camera flythrough")
    _add_config_overrides(a)
    a.add_argument("--frames", type=int, default=8)
    a.add_argument("--out-dir", default="frames")
    a.add_argument("--readback-chunk", type=int, default=64,
                   dest="readback_chunk",
                   help="write frames to PNG every N frames (bounds device "
                        "memory; 0 = one readback at the end)")
    a.add_argument("--autotune", action="store_true",
                   help="calibration pass: render uncapped, read the "
                        "counters every frame and record the path's largest "
                        "live/want counts in the autotune cache")
    a.add_argument("--verbose", "-v", action="store_true")
    a.set_defaults(fn=cmd_animate)

    e = sub.add_parser("export", help="write a scene to .obj/.glb/.gltf")
    e.add_argument("--config", default="bunny",
                   help="preset name or scene file")
    e.add_argument("--out", required=True)
    e.set_defaults(fn=cmd_export)

    i = sub.add_parser("info", help="show devices, presets and builds")
    i.add_argument("--cpu", action="store_true")
    i.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)

    profile_dir = getattr(args, "profile", None)
    if profile_dir:
        import torch

        from tpurt_torch.utils import profiling

        with profiling.trace(profile_dir, cuda=not args.cpu
                             and torch.cuda.is_available()) as path:
            rc = args.fn(args)
        print(f"profiler trace → {path}")
        return rc
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
