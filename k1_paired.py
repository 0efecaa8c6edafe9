#!/usr/bin/env python3
"""The tile loop (K1), the grid over pairs (K4), the packet walk (K5) and
the entry build and exact mask (K2, K3) of this checkout against those of
another checkout, on the waves chip_smoke.py holds them to, on one CUDA
GPU.

    python3 k1_paired.py --parent DIR [--scenes bunny,sponza,cornell,buddha]
        [--cases K4,K5,sort] [--variant TAG:kName=V,kName=V ...] [--reps 10]
        [--out FILE]

DIR is a checkout of the commit to compare with (for example the parent,
unpacked with ``git archive``). The kernels of both checkouts are built
from their own ``tpurt_torch/csrc`` with the same nvcc flags, and each
``--variant`` builds a copy of this checkout's sources whose
``constexpr int kName = ...;`` lines take the given values, each name
looked up in the one source that holds it: the loop's shape in
csrc/tileloop.cu (kSliceWarps, kScSliceWarps, kStages, kGroup, kRegCap,
kTlRegCap, kTriLanes) and the packet walk's in csrc/packet.cu (kBlock,
kRowLanes, kShareCost). For every case — K1 on
the bunny's first bounce (closest) and shadow (lean any-hit) waves as
entry rows and as pair segments, on chip_smoke's edge-case lists, on
sponza's supercluster and per-cluster entries, on cornell's all-pairs
rows; K4 on the bunny's and cornell's grid lists and the bunny's K4
edge-case lists; K5 on the bunny's primary, bounce and shadow waves
through its packet BVH; K2 on the primary (every ray live), bounce and
shadow waves of an uncapped bunny batch (cluster boxes) and buddha.accum
batch (``buddha``: perfbench's frozen scene, superboxes), as
chip_smoke.slab_waves gives them, and K3 on their ``bounce-1`` and
``shadow-0`` waves — whose name holds one of ``--cases`` (every case
by default), it checks every output of every other build bit-equal to
this checkout's (K5: its group counters too; K4 any-hit: the occlusion
flags), then times each build by CUDA events (mean of ``--reps``
launches) in the order parent, tree, the variants, the variants
reversed, tree, parent. The edge-case lists are
cut for this checkout's ring (its kGroup and kSliceWarps). This
checkout's wrappers launch every build, so a case runs only where every
build's C entry point of its kernel takes the same arguments as this
checkout's; the others are skipped and logged (a parent from before K5's
packed nodes: its K5 cases). Prints each build's
registers and spills (ptxas), the nvidia-smi name and power-limit line
and a JSON object (also written to ``--out``); exits 1 if any output
differs.

The ``sort`` cases time the tile intersector's ray sort step
(``chip_smoke.raysort_step``: keys, sort, gather and restore) on every
bounce and shadow wave of one bunny batch (uncapped, and cut at caps 5%
above each wave's live rays) and one buddha.accum batch, as the parent
ran it (``raysort``'s plain versions: the torch ops the step ran before
``csrc/raysort.cu``) and as this tree runs it (the kernels), every
output bit-equal, in the order parent, tree, tree, parent. Where a sort
case runs, the bunny and buddha scenes (of those in ``--scenes``) are
also rendered (two batches of 8 spp at their benchmark sizes) by each
checkout in a process of its own, the parent's with its own kernels,
and their accumulations must be bit-equal.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import shutil
import sys

import chip_smoke
from chip_smoke import cuda_ms, log

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(ROOT, "tpurt_torch", "build", "paired")


def build(csrc: str, tag: str, consts: dict | None = None):
    """The kernel library of the sources in ``csrc`` (with the named
    constants replaced by ``consts``), built into BUILD."""
    from tpurt_torch.kernels import cuda_build

    src_dir = os.path.join(BUILD, tag)
    shutil.rmtree(src_dir, ignore_errors=True)
    os.makedirs(src_dir)
    # the sources this checkout builds that ``csrc`` has (a parent may
    # predate some)
    sources = [name for name in cuda_build.SOURCES
               if os.path.exists(os.path.join(csrc, name))]
    for name in sources:
        shutil.copy(os.path.join(csrc, name), src_dir)
    for name, value in (consts or {}).items():
        found = 0
        for src in sources:
            path = os.path.join(src_dir, src)
            with open(path) as f:
                text = f.read()
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
            if n:
                with open(path, "w") as f:
                    f.write(text)
            found += n
        if found != 1:
            raise ValueError(f"{tag}: {found} constants {name} in csrc")
    lib = cuda_build.build_library(src_dir,
                                   os.path.join(src_dir, f"lib_{tag}.so"))
    log(f"[build] {tag}: {lib.seconds:.2f} s")
    return lib


# The C entry point that each case's kernel launches through.
ENTRY = {"K1": "tpurt_tileloop", "K4": "tpurt_tilegrid",
         "K5": "tpurt_packet", "K2": "tpurt_entries",
         "K3": "tpurt_exact_mask"}


def interfaces(csrc: str) -> dict:
    """The parameter list of every C entry point in the sources of
    ``csrc``, whitespace squeezed, by name."""
    from tpurt_torch.kernels import cuda_build

    out = {}
    for name in cuda_build.SOURCES:
        if not os.path.exists(os.path.join(csrc, name)):
            continue
        with open(os.path.join(csrc, name)) as f:
            text = f.read()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            out[m.group(1)] = " ".join(m.group(2).split())
    return out


def slab_cases(scene: str, device):
    """K2 on every wave of one uncapped batch of ``scene`` (bunny or
    buddha) over the boxes its entry rows use, K3 on two of them."""
    from tpurt_torch.kernels import tilewave as tw
    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.utils.config import get_config

    if scene == "buddha":
        config, host = chip_smoke.buddha_scene()
    else:
        config = get_config(scene, spp=8, spp_per_batch=8)
        host = load_scene(config.scene)
    (lo, hi), waves = chip_smoke.slab_waves(config, host, device,
                                            primary=True)
    scale = tw.tn_scale_of(lo.cpu().numpy(), hi.cpu().numpy())
    for label, (org, _, inv_d, tmv) in waves:
        yield (f"K2 {scene} {label}",
               lambda o=org, iv=inv_d, t=tmv:
               (tw.entries_cuda(o, iv, t, lo, hi, scale),))
        if label in ("bounce-1", "shadow-0"):
            yield (f"K3 {scene} {label}",
                   lambda o=org, iv=inv_d, t=tmv:
                   tw.exact_mask_cuda(o, iv, t, lo, hi))


def scene_cases(scene: str, device):
    """(case name, closure launching the kernel on the case's inputs[,
    flags]) for every case of ``scene``, built from the same waves as
    chip_smoke.py; ``flags``: only the occlusion flags (bs >= 0) are the
    result (K4's any-hit stops a ray at its first hit)."""
    import torch

    from tpurt_torch.bvh.cluster import build_packet_accel
    from tpurt_torch.kernels import packet as pk
    from tpurt_torch.kernels import tilewave as tw
    from tpurt_torch.render.intersectors import scene_meta
    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.utils.config import get_config

    if scene in ("bunny", "buddha"):
        yield from slab_cases(scene, device)
        if scene == "buddha":
            return
    if scene == "cornell":
        accel, waves, _ = chip_smoke.batch_waves("cornell", device, 16,
                                                 sort=False)
        n_c = accel.cluster_lo.shape[0]
        for kind, any_hit in (("primary", False), ("shadow", True)):
            wave = waves[kind]
            n_tiles = wave[0].shape[0] // tw.TILE
            entry = torch.arange(n_c, dtype=torch.int32, device=device)
            entry = entry[None].expand(n_tiles, n_c).contiguous()
            counts = torch.full((n_tiles,), n_c, dtype=torch.int32,
                                device=device)
            yield (f"K1 all-pairs cornell {kind}",
                   lambda w=wave, e=entry, c=counts, a=any_hit:
                   tw.tileloop_cuda(*w, accel.tri_rows, e, c, 0.0, a))
            packed = chip_smoke.grid_list("cornell", wave, accel, n_c,
                                          all_pairs=True)[0]
            yield (f"K4 all-pairs cornell {kind}",
                   lambda w=wave, pk_=packed, a=any_hit:
                   tw.tilegrid_cuda(*w, accel.tri_rows, pk_, a,
                                    all_pairs=True), any_hit)
        return
    spp = 8 if scene == "bunny" else 2
    accel, waves, raw = chip_smoke.batch_waves(scene, device, spp, sort=True)
    rows = accel.tri_rows
    if scene == "bunny":
        modes = (("flat", accel.cluster_lo, accel.cluster_hi, {}),)
        cfg = get_config("bunny")
    else:
        tl = dict(pair_meta=accel.pair_meta, inv_xform=accel.inv_xform)
        modes = (("sc", accel.sc_lo, accel.sc_hi,
                  dict(tl, sc_meta=accel.sc_meta)),
                 ("cluster", accel.cluster_lo, accel.cluster_hi, tl))
    for mode, lo, hi, tl in modes:
        scale = tw.tn_scale_of(lo.cpu().numpy(), hi.cpu().numpy())
        for kind, any_hit in (("bounce", False), ("shadow", True)):
            wave = waves[kind]
            org, _, inv_d, tmv = wave
            entry = torch.sort(tw.entries_cuda(org, inv_d, tmv, lo, hi,
                                               scale), dim=1).values
            counts = (entry != tw.INT32_MAX).sum(dim=1, dtype=torch.int32)
            yield (f"K1 {mode} {scene} {kind}",
                   lambda w=wave, e=entry, c=counts, a=any_hit, t=tl, s=scale:
                   tw.tileloop_cuda(*w, rows, e, c, s, a, **t))
            rays, ent, cnt, _ = chip_smoke.edge_case(wave, entry, counts,
                                                     scale, sc=mode == "sc")
            yield (f"K1 edges {mode} {scene} {kind}",
                   lambda r=rays, e=ent, c=cnt, a=any_hit, t=tl, s=scale:
                   tw.tileloop_cuda(*r, rows, e, c, s, a, **t))
            if scene != "bunny":
                continue
            off, pair_cl = tw._rows_to_segments(ent, cnt)
            yield (f"K1 edges seg {scene} {kind}",
                   lambda r=rays, o=off, pc=pair_cl, a=any_hit:
                   tw.tileloop_seg_cuda(*r, rows, o, pc, scale, a))
            cap_avg = max(cfg.pairs_avg, cfg.pairs_avg_bounce,
                          cfg.pairs_avg_shadow)
            pcap = min(tw.TILES_PER_LAUNCH * min(cap_avg, lo.shape[0]),
                       tw.MAX_PAIRS_PER_LAUNCH)
            off, pair_cl, _, _ = tw._wave_segments(
                *wave, lo, hi, scale, tw.TILES_PER_LAUNCH, exact=True,
                pairs_per_tile=0, pcap=pcap)
            yield (f"K1 seg {scene} {kind}",
                   lambda w=wave, o=off, pc=pair_cl, a=any_hit:
                   tw.tileloop_seg_cuda(*w, rows, o, pc, scale, a))
            avg = cfg.pairs_avg_shadow if any_hit else cfg.pairs_avg_bounce
            packed = chip_smoke.grid_list(f"bunny {kind}", wave, accel,
                                          avg)[0]
            yield (f"K4 {scene} {kind}",
                   lambda w=wave, pk_=packed, a=any_hit:
                   tw.tilegrid_cuda(*w, rows, pk_, a), any_hit)
            g_rays, g_list, _ = chip_smoke.grid_edge_case(wave, rows, packed,
                                                          any_hit)
            yield (f"K4 edges {scene} {kind}",
                   lambda r=g_rays, pk_=g_list, a=any_hit:
                   tw.tilegrid_cuda(*r, rows, pk_, a), any_hit)
    if scene != "bunny":
        return
    del accel, waves
    cfg_scene = load_scene(cfg.scene)
    pacc = build_packet_accel(None, scene_meta(cfg_scene),
                              scene=cfg_scene).to(device)
    tables = pk.packet_tables(pacc)
    for kind in ("primary", "bounce", "shadow"):
        pw = chip_smoke.packet_wave(raw[kind])
        yield (f"K5 {scene} {kind}",
               lambda w=pw, a=kind == "shadow":
               pk.packet_cuda(tables, *w, a))


def sort_cases(scene: str, device):
    """(case name, the parent's sort step, this tree's) on every bounce
    and shadow wave of one batch of ``scene`` (bunny: uncapped and at caps
    5% above each wave's live rays; buddha: uncapped)."""
    import torch

    from tpurt_torch.kernels import tilewave as tw
    from tpurt_torch.scene.loader import load_scene
    from tpurt_torch.utils.config import get_config

    if scene == "buddha":
        config, host = chip_smoke.buddha_scene()
    else:
        config = get_config(scene, spp=8, spp_per_batch=8)
        host = load_scene(config.scene)
    box, waves = chip_smoke.slab_waves(config, host, device, sort=False)
    for capped in ((False, True) if scene == "bunny" else (False,)):
        for label, wave in waves:
            keep = wave[0].shape[0]
            if capped:
                live = int((wave[3] >= 0).sum())
                keep = min(keep, -(-int(live * 1.05) // tw.TILE) * tw.TILE)
            out = tuple(torch.arange(keep, dtype=torch.float32,
                                     device=device) + 0.25 * k
                        for k in range(4))
            step = lambda plain, w=wave, o=out, a=label.startswith("shadow"): \
                chip_smoke.raysort_step(w, box, o, a, plain)
            yield (f"sort {scene} {'capped' if capped else 'uncapped'} "
                   f"{label}", lambda s=step: s(True), lambda s=step: s(False))


# two batches of 8 spp of the bunny and buddha scenes rendered by a
# checkout (the working directory) into .npy accumulations
RENDER = """
import sys
import numpy
import chip_smoke
from tpurt_torch.render import render_scene
from tpurt_torch.scene.loader import load_scene
from tpurt_torch.utils.config import get_config

out, names = sys.argv[1], sys.argv[2].split(",")
for name in names:
    if name == "buddha":
        config, scene = chip_smoke.buddha_scene()
    else:
        config = get_config(name, spp=16, spp_per_batch=8)
        scene = load_scene(config.scene)
    img, stats = render_scene(config, device="cuda", scene=scene)
    numpy.save(f"{out}/{name}.npy", img.accum.cpu().numpy())
    print(name, stats.get("rays_traced"), stats.get("live_overflow"))
"""


def images_equal(parent: str, names: list) -> dict:
    """Render ``names`` in the parent checkout and in this one, each in
    a process of its own; whether each pair of accumulations is
    bit-equal."""
    import subprocess
    import tempfile

    import numpy as np

    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, root in (("parent", os.path.abspath(parent)),
                          ("tree", ROOT)):
            os.makedirs(os.path.join(tmp, tag))
            run = subprocess.run(
                [sys.executable, "-c", RENDER, os.path.join(tmp, tag),
                 ",".join(names)], cwd=root, capture_output=True, text=True,
                env=dict(os.environ, PYTHONPATH=root))
            log(f"[images] {tag}: rc {run.returncode}; "
                + " | ".join(run.stdout.split("\n")[-4:]))
            if run.returncode:
                raise RuntimeError(f"{tag} render failed:\n"
                                   f"{run.stderr[-4000:]}")
        for name in names:
            a, b = (np.load(os.path.join(tmp, tag, f"{name}.npy"))
                    for tag in ("parent", "tree"))
            got[name] = bool(a.shape == b.shape and
                             np.array_equal(a.view(np.uint32),
                                            b.view(np.uint32)))
            log(f"[images] {name}: the tree's accumulation bit-equal to "
                f"the parent's {got[name]}")
    return got


def main() -> int:
    import torch

    from tpurt_torch.kernels import cuda_build
    from tpurt_torch.utils import profiling

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--scenes", default="bunny,sponza,cornell")
    ap.add_argument("--cases", default="",
                    help="comma-separated parts of case names to run")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_paired: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = profiling.nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")

    jobs = {"parent": (os.path.join(args.parent, "tpurt_torch", "csrc"),
                       None),
            "tree": (cuda_build.CSRC, None)}
    for spec in args.variant:
        tag, _, body = spec.partition(":")
        jobs[tag] = (cuda_build.CSRC,
                     dict(kv.split("=") for kv in body.split(",") if kv))
    variants = list(jobs)[2:]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {tag: pool.submit(build, csrc, tag, consts)
                   for tag, (csrc, consts) in jobs.items()}
        libs = {tag: f.result() for tag, f in futures.items()}
    # this checkout's wrappers launch every build: a case runs only where
    # the builds' entry points take the same arguments
    ifs = {tag: interfaces(csrc) for tag, (csrc, _) in jobs.items()}
    differs = {entry: [tag for tag in jobs
                       if ifs[tag].get(entry) != ifs["tree"][entry]]
               for entry in ENTRY.values()}
    report = {"card": smi, "builds": {}, "cases": {}}
    for tag, lib in libs.items():
        regs = chip_smoke.registers(lib.log)
        report["builds"][tag] = dict(seconds=lib.seconds, kernels=regs)
        for name, r in sorted(regs.items()):
            log(f"[build] {tag} {name}: {r}")
    order = ["parent", "tree", *variants, *variants[::-1], "tree", "parent"]
    wanted = [c for c in args.cases.split(",") if c]
    bad = 0
    for scene in args.scenes.split(","):
        if wanted == ["sort"]:
            break
        for name, run, *flags in scene_cases(scene, device):
            if wanted and not any(c in name for c in wanted):
                continue
            entry = ENTRY[name.split()[0]]
            if differs[entry]:
                log(f"[paired] {name}: skipped, {entry} of "
                    f"{', '.join(differs[entry])} takes other arguments")
                report["cases"][name] = dict(skipped=differs[entry])
                continue
            cuda_build.activate(libs["tree"])
            ref = run()
            equal = {}
            for tag in libs:
                if tag == "tree":
                    continue
                cuda_build.activate(libs[tag])
                out = run()
                if flags and flags[0]:
                    equal[tag] = torch.equal(out[3] >= 0, ref[3] >= 0)
                else:
                    equal[tag] = all(torch.equal(a, b)
                                     for a, b in zip(out, ref))
                bad += not equal[tag]
            ms = {tag: [] for tag in libs}
            for tag in order:
                cuda_build.activate(libs[tag])
                run()
                ms[tag].append(cuda_ms(run, args.reps))
            report["cases"][name] = dict(ms=ms, bit_equal_to_tree=equal)
            log(f"[paired] {name}: " + "; ".join(
                f"{tag} " + " / ".join(f"{t:.3f}" for t in ms[tag])
                for tag in libs) + " ms; bit-equal to the tree: "
                + ", ".join(f"{t} {e}" for t, e in equal.items()))
            del ref
        torch.cuda.empty_cache()
    cuda_build.activate(libs["tree"])
    # the sort step: the parent's torch ops (raysort's plain versions)
    # against this tree's kernels, then the images of both checkouts
    rendered = []
    for scene in args.scenes.split(","):
        if scene not in ("bunny", "buddha"):
            continue
        for name, parent, tree in sort_cases(scene, device):
            if wanted and not any(c in name for c in wanted):
                continue
            ref, out = tree(), parent()
            equal = all(torch.equal(a.to(b.dtype), b)
                        for a, b in zip(ref, out))
            bad += not equal
            ms = {"parent": [], "tree": []}
            for tag in ("parent", "tree", "tree", "parent"):
                fn = parent if tag == "parent" else tree
                fn()
                ms[tag].append(cuda_ms(fn, args.reps))
            report["cases"][name] = dict(ms=ms, bit_equal_to_tree=dict(
                parent=equal))
            log(f"[paired] {name}: " + "; ".join(
                f"{tag} " + " / ".join(f"{t:.3f}" for t in ms[tag])
                for tag in ms) + f" ms; bit-equal to the tree: {equal}")
            del ref, out
            if scene not in rendered:
                rendered.append(scene)
        torch.cuda.empty_cache()
    if rendered:
        images = images_equal(args.parent, rendered)
        report["images_bit_equal"] = images
        bad += sum(not v for v in images.values())
    text = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    print(smi)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
