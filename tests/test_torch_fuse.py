"""The reference's stage programs in tpurt_torch's staged loop:
``TPURT_FUSE_STAGES``, ``TPURT_FUSE_BOUNCES``, ``prewarm`` and the CUDA
graphs they run as on the card.

On the CPU the stage programs run eagerly. The fused stages keep every
operation of the unfused loop in its order, so they are bit-equal to it,
counters included, as the reference's are (its
``tests/unit/test_staged.py::test_fusion_variants_bit_exact``). Against
the reference on its own case (cornell_pt at 40×32, 2 spp a batch, 3
bounces, seed 5, first sample 8, the brute force) the port is held to
the reference's tolerances for whole-batch fusion: counters rtol 1e-3
and atol 2, under 2% of pixels off by more than 1e-3, RMSE under 1e-2
(torch and XLA:CPU round transcendentals apart, ROADMAP §3).

A stage program may read nothing from the host, or its graph could not
be captured: a dispatch mode records every host read (a scalar read, a
nonzero, a boolean index, a tensor made from Python data) inside the
captured paths' programs, with the kernels' plain versions (which read
the host on the CPU only) left out.

The reference and jax are imported inside the tests that use them, so
the ``cuda`` test also runs on a machine without them:

    python -m pytest --noconftest -q tests/test_torch_fuse.py -m cuda
"""

import contextlib
import io
import os
import pathlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpurt_torch import kernels
from tpurt_torch import render as rd
from tpurt_torch.core.camera import Camera
from tpurt_torch.kernels import packet as pk
from tpurt_torch.kernels import tilewave as tw
from tpurt_torch.render.staged import StagedRenderer, make_staged_renderer
from tpurt_torch.scene.procedural import bunny_standin, cornell_box
from tpurt_torch.utils import profiling
from tpurt_torch.utils.config import get_config

BUNNY = dict(width=48, height=32, spp=2, spp_per_batch=2, max_bounces=2)
CORNELL_PT = dict(width=40, height=32, spp_per_batch=2, max_bounces=3)
SEED, SAMPLE0 = 5, 8


def _renderer(scene, cfg, env=(), device="cpu", accel=True, **kw):
    """A StagedRenderer built under the switches ``env``."""
    ds = rd.to_device(scene, device=device)
    meta = rd.scene_meta(scene)
    acc = (rd.build_accel(cfg, ds, meta, scene=scene, device=device)
           if accel else None)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(env).items():
            mp.setenv(k, v)
        return StagedRenderer(ds, acc, meta=meta, config=cfg, device=device,
                              **kw)


def _cases():
    bunny = bunny_standin(subdivisions=3)
    return {
        "bunny": (bunny, get_config("bunny", **BUNNY), True),
        "cornell_pt": (cornell_box(path_tracer=True),
                       get_config("cornell_pt", **CORNELL_PT), False),
        "sorted": (bunny, get_config("bunny", sorted_wave=True, **BUNNY),
                   True),
    }


@pytest.mark.parametrize("case", ["bunny", "cornell_pt", "sorted"])
def test_fused_stages_bit_equal_to_the_unfused_loop(case):
    """The fused stage programs against the unfused loop, and the sorted
    loop's programs against the default loop, whose image they equal —
    under live caps at the waves' measured live counts, which cut the
    sorted waves to whole tiles and the default loop's inside its
    intersector, and drop no alive ray: the image and every counter bit
    for bit."""
    scene, cfg, accel = _cases()[case]
    if case == "sorted":
        live = _renderer(scene, cfg, accel=accel)(
            scene.camera, SEED, SAMPLE0)[1][4:6]
        cfg = get_config("bunny", sorted_wave=True,
                         live_caps=tuple(int(v) + 1 for v in live), **BUNNY)
    fused = _renderer(scene, cfg, {"TPURT_FUSE_STAGES": "1"}, accel=accel)
    base = _renderer(scene, cfg, {"TPURT_FUSE_STAGES": "0",
                                  "TPURT_SORTED_WAVE": "0"}, accel=accel)
    assert fused.mode == ("sorted" if case == "sorted" else "fused")
    assert base.mode == "unfused"
    assert not fused.graphs and not base.graphs  # the CPU runs eagerly
    if case == "sorted":
        assert any(fused.sorted_caps)  # a wave is cut
    img_f, rays_f = fused(scene.camera, SEED, SAMPLE0)
    img_b, rays_b = base(scene.camera, SEED, SAMPLE0)
    assert torch.equal(img_f, img_b)
    assert torch.equal(rays_f, rays_b)
    assert float(rays_f[0]) > 0 and float(rays_f[1]) > 0


def _ref_render(env):
    """The reference's staged renderer on cornell_pt under ``env``."""
    import jax.numpy as jnp

    from tpurt.render.intersectors import scene_meta as ref_meta
    from tpurt.render.staged import make_staged_renderer as ref_make
    from tpurt.scene.device import to_device as ref_to_device
    from tpurt.scene.procedural import cornell_box as ref_cornell
    from tpurt.utils.config import get_config as ref_config

    scene = ref_cornell(path_tracer=True)
    cfg = ref_config("cornell_pt", **CORNELL_PT)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        r = ref_make(ref_to_device(scene), None, meta=ref_meta(scene),
                     config=cfg)
        img, rays = r(scene.camera, jnp.uint32(SEED), jnp.uint32(SAMPLE0))
    return np.asarray(img), np.asarray(rays)


@pytest.mark.parametrize("env", [{"TPURT_FUSE_STAGES": "1"},
                                 {"TPURT_FUSE_BOUNCES": "1"}],
                         ids=["stages", "bounces"])
def test_fused_programs_match_the_reference(env):
    want_img, want_rays = _ref_render(env)
    scene = cornell_box(path_tracer=True)
    r = _renderer(scene, get_config("cornell_pt", **CORNELL_PT), env,
                  accel=False)
    assert r.mode == ("whole" if "TPURT_FUSE_BOUNCES" in env else "fused")
    img, rays = r(scene.camera, SEED, SAMPLE0)
    np.testing.assert_allclose(rays.numpy(), want_rays, rtol=1e-3, atol=2)
    diff = np.abs(img.numpy() - want_img)
    assert float((diff > 1e-3).mean()) < 0.02
    assert float(np.sqrt((diff ** 2).mean())) < 1e-2


def test_whole_batch_is_the_default_loop_uncapped():
    """TPURT_FUSE_BOUNCES traces full waves: with live and shadow caps
    that cut nothing it equals the capped default loop bit for bit; its
    intersectors carry no caps."""
    scene, cfg, _ = _cases()["bunny"]
    cfg = get_config("bunny", live_caps=(3072, 2048),
                     shadow_caps=(3072, 3072, 2048), **BUNNY)
    whole = _renderer(scene, cfg, {"TPURT_FUSE_BOUNCES": "1"})
    fused = _renderer(scene, cfg)
    assert whole.mode == "whole" and [p[0] for p in whole.programs()] == [
        "whole_batch"]
    img_w, rays_w = whole(scene.camera, SEED, SAMPLE0)
    img_f, rays_f = fused(scene.camera, SEED, SAMPLE0)
    assert float(rays_f[3]) == 0.0  # no cap cut an alive ray
    assert torch.equal(img_w, img_f) and torch.equal(rays_w, rays_f)


def test_whole_batch_stays_off_on_a_mesh_and_the_sorted_loop():
    class Shard:
        n_tile, n_sample, tile_id, sample_id = 2, 1, 0, 0

    scene, cfg, _ = _cases()["bunny"]
    env = {"TPURT_FUSE_BOUNCES": "1"}
    assert _renderer(scene, cfg, env, mesh=Shard()).mode == "fused"
    assert _renderer(scene, get_config("bunny", sorted_wave=True, **BUNNY),
                     env).mode == "sorted"
    assert _renderer(scene, cfg, dict(env, TPURT_CAPTURE_WAVES="x")
                     ).mode == "unfused"
    flat = get_config("hello_triangle", width=32, height=32)
    assert _renderer(scene, flat, env).mode == "flat"


def test_graph_reason_names_the_paths_prewarm_leaves_eager():
    """A mesh, flat shading and the wave probe run their stage programs
    eagerly on the card too (the reference's prewarm makes none ready
    for the first two; the probe copies waves to the host): each says
    why, so the first batch never captures inside a timed render."""
    class Shard:
        n_tile, n_sample, tile_id, sample_id = 2, 1, 0, 0

    scene, cfg, _ = _cases()["bunny"]
    flat = get_config("hello_triangle", width=32, height=32)
    for r, reason in (
            (_renderer(scene, cfg, mesh=Shard()), "a mesh"),
            (_renderer(scene, flat), "flat shading"),
            (_renderer(scene, cfg, {"TPURT_CAPTURE_WAVES": "x"}),
             "TPURT_CAPTURE_WAVES")):
        assert r.graph_reason.startswith(reason) and not r.graphs
        assert r.prewarm(scene.camera) == 0


def test_prewarm_is_zero_on_the_cpu_and_render_scene_calls_it(monkeypatch):
    scene, cfg, _ = _cases()["bunny"]
    ds = rd.to_device(scene, device="cpu")
    meta = rd.scene_meta(scene)
    accel = rd.build_accel(cfg, ds, meta, scene=scene, device="cpu")
    made = make_staged_renderer(ds, accel, meta=meta, config=cfg,
                                device="cpu")
    assert made.prewarm(scene.camera) == 0
    assert made.prewarm(scene.camera, seed=3, sample0=2) == 0
    calls = []
    real = StagedRenderer.prewarm

    def counted(self, cam, seed=0, sample0=0):
        calls.append((seed, sample0))
        return real(self, cam, seed, sample0)

    monkeypatch.setattr(StagedRenderer, "prewarm", counted)
    monkeypatch.setenv("TPURT_PREWARM", "0")
    rd.render_scene(cfg, scene=scene, device="cpu")
    assert calls == []
    monkeypatch.delenv("TPURT_PREWARM")
    # a new renderer (another first sample per batch): one prewarm,
    # with the render's seed and first sample
    cfg2 = get_config("bunny", **dict(BUNNY, spp=1, spp_per_batch=1))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rd.render_scene(cfg2, scene=scene, device="cpu", verbose=True)
    assert calls == [(cfg2.seed, 0)]
    assert "prewarmed" not in out.getvalue()  # 0 graphs on the CPU


@pytest.mark.parametrize("switch", ["TPURT_FUSE_STAGES",
                                    "TPURT_FUSE_BOUNCES"])
def test_a_fuse_switch_rebuilds_the_cached_renderer(monkeypatch, switch):
    scene, cfg, _ = _cases()["bunny"]
    cfg = get_config("bunny", **dict(BUNNY, spp=1, spp_per_batch=1))

    def renderer():
        rd.render_scene(cfg, scene=scene, device="cpu")
        return next(c["renderer"] for c in rd._SCENE_CACHE.values()
                    if isinstance(c, dict) and "renderer" in c)

    first = renderer()
    assert renderer() is first  # kept under the same switches
    monkeypatch.setenv(switch, "0" if switch == "TPURT_FUSE_STAGES" else "1")
    other = renderer()
    assert other is not first
    assert other.mode == ("unfused" if switch == "TPURT_FUSE_STAGES"
                          else "whole")


def test_capture_waves_writes_the_same_files_under_fusion(monkeypatch,
                                                          tmp_path):
    scene, cfg, _ = _cases()["bunny"]
    cfg = get_config("bunny", **dict(BUNNY, spp=1, spp_per_batch=1))
    images = {}
    for fuse in ("1", "0"):
        monkeypatch.setenv("TPURT_FUSE_STAGES", fuse)
        monkeypatch.setenv("TPURT_CAPTURE_WAVES", str(tmp_path / fuse))
        state, _ = rd.render_scene(cfg, scene=scene, device="cpu")
        images[fuse] = state.accum
    names = sorted(os.listdir(tmp_path / "1"))
    assert names == sorted(os.listdir(tmp_path / "0")) and len(names) == 5
    for name in names:
        a, b = np.load(tmp_path / "1" / name), np.load(tmp_path / "0" / name)
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert torch.equal(images["1"], images["0"])


def test_debug_prints_the_fused_stage_names(monkeypatch):
    scene, cfg, _ = _cases()["bunny"]
    r = _renderer(scene, cfg, {"TPURT_DEBUG_STAGES": "1"})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        r(scene.camera, SEED, SAMPLE0)
    names = [ln.split("] ", 1)[1].rsplit(": ", 1)[0]
             for ln in out.getvalue().splitlines()
             if ln.startswith("    [stage] ")]
    assert names == [f"{s}[{b}]" for b in range(3)
                     for s in ("trace", "shade_occlude")]


@pytest.mark.parametrize("name,over,env,reason", [
    ("bunny", {}, {}, ""),
    ("segments", {}, {"TPURT_ENTRY_ROWS": "0"}, "pair segments"),
    ("grid", {}, {"TPURT_PAIR_LOOP": "0"}, "grid over pairs"),
    ("bvh_pair", {"intersector": "bvh_pair"}, {}, "bvh_pair"),
    ("bvh", {"intersector": "bvh"}, {}, "LBVH"),
])
def test_graph_reason_names_the_host_reads(name, over, env, reason):
    """Decided when the renderer is built, from the intersectors it
    made: the paths whose lists are sized on the host run eagerly."""
    scene = bunny_standin(subdivisions=3)
    r = _renderer(scene, get_config("bunny", **dict(BUNNY, **over)), env)
    assert r.mode == "fused"
    if reason:
        assert reason in r.graph_reason
    else:
        assert r.graph_reason == ""


class _HostReads(TorchDispatchMode):
    """Records the ops that read the host or copy host data to the
    device: under a CUDA graph capture each would raise."""

    SYNC = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
            "aten.lift_fresh", "aten.bincount", "aten.repeat_interleave.Tensor",
            "aten.equal", "aten.is_nonzero", "aten._unique2",
            "aten.unique_consecutive")
    paused = False

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bad = name.startswith(self.SYNC) or (
            name.startswith(("aten.index.Tensor", "aten.index_put"))
            and any(t is not None and t.dtype == torch.bool
                    for t in args[1]))
        if bad and not _HostReads.paused:
            self.found.append(name)
        return func(*args, **(kwargs or {}))


def _plain_unwatched(monkeypatch):
    """The kernels' dispatchers run their plain versions (which read the
    host on the CPU; on the card the kernel launches) unwatched."""
    def unwatched(fn):
        def run(*a, **k):
            _HostReads.paused = True
            try:
                return fn(*a, **k)
            finally:
                _HostReads.paused = False
        return run

    for mod, name in ((tw, "tileloop"), (tw, "exact_entries"),
                      (tw, "exact_mask"), (pk, "packet")):
        monkeypatch.setattr(mod, name, unwatched(getattr(mod, name)))


@pytest.mark.parametrize("name,over,env", [
    ("bunny", {}, {}),
    ("unfused", {}, {"TPURT_FUSE_STAGES": "0"}),
    ("bunny_sc", {}, {"TPURT_SUPERCLUSTER": "1"}),
    ("budget", {"pairs_per_tile": 8}, {}),
    ("sorted", {"sorted_wave": True, "live_caps": (1024, 1024)}, {}),
    ("whole", {}, {"TPURT_FUSE_BOUNCES": "1"}),
    ("packet", {"intersector": "bvh_packet"}, {}),
    ("cornell", {"scene": "cornell"}, {}),
    ("two_level", {"scene": "sponza"}, {}),
    ("fence", {"scene": "fence"}, {}),
    ("fence_packet", {"scene": "fence", "intersector": "bvh_packet"}, {}),
])
def test_captured_programs_read_nothing_from_the_host(monkeypatch, name,
                                                      over, env):
    import chip_smoke
    from tpurt_torch.scene.procedural import sponza_standin

    _plain_unwatched(monkeypatch)
    over = dict(over)
    scene = over.pop("scene", "bunny")
    preset = "bunny" if scene == "fence" else scene
    scene = {"cornell": cornell_box,
             "sponza": lambda: sponza_standin(8, 3),
             # the bunny beside chip_smoke's cut-out fence: the cut-out
             # loop's rounds and alpha probes
             "fence": lambda: chip_smoke.fence_scenes(3)[0],
             }.get(scene, lambda: bunny_standin(3))()
    r = _renderer(scene, get_config(preset, **dict(BUNNY, **over)), env)
    assert r.graph_reason == "" and r.programs()
    r.set_inputs(scene.camera, SEED, SAMPLE0)
    mode = _HostReads()
    carry = None
    with mode:
        for _, fn in r.programs():
            carry = fn(carry)
    assert mode.found == []
    assert len(carry) == 2  # (per-pixel sums, counters)


def test_launch_counts_survive_a_capture_and_add_on_replay():
    """The bookkeeping a graph does around its capture: the launches and
    waves counted while capturing are taken back and added again on
    every replay, the waves in the recorder too."""
    kernels.reset_launch_counts()
    kernels.reset("waves.")
    was = profiling.recording()
    profiling.record(True)
    try:
        kernels.add({"entries": 2, "tileloop": 3, "waves.cluster_rows": 1})
        before = kernels.counts()
        # what a capture counts
        kernels.add({"entries": 1, "tileloop": 2, "tileloop_sc": 1,
                     "packet": 4, "waves.sc_rows": 2})
        delta = kernels.take_since(before)
        assert kernels.launch_counts()["entries"] == 2
        assert kernels.launch_counts().get("tileloop_sc") is None
        assert kernels.counts("waves.") == {"waves.cluster_rows": 1}
        assert profiling.records()["counts"].get("waves.sc_rows") == 0
        for _ in range(3):
            kernels.add(delta)
        counts = kernels.launch_counts()
        recorded = profiling.records()["counts"]
    finally:
        profiling.record(was)
    assert (counts["entries"], counts["tileloop"], counts["tileloop_sc"],
            counts["packet"]) == (5, 9, 3, 12)
    assert kernels.counts("waves.") == {"waves.cluster_rows": 1,
                                        "waves.sc_rows": 6}
    assert recorded["waves.sc_rows"] == 6
    kernels.reset_launch_counts()  # the launches, not the waves
    assert kernels.launch_counts() == {"entries": 0, "exact_mask": 0,
                                       "pair": 0, "packet": 0, "shade": 0}
    assert kernels.counts() == {"waves.cluster_rows": 1, "waves.sc_rows": 6}
    kernels.reset("waves.")
    assert kernels.counts() == {}


class _FakeLibrary:
    """A kernel library whose every entry point records its arguments and
    returns ``err``."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.err
        return entry


@pytest.mark.parametrize("key,entry,err,work,want", [
    ("entries", "tpurt_entries", 700, True,
     "entries kernel launch failed: cudaError 700"),
    ("tileloop_tl_sc", "tpurt_tileloop", 0, False, None),
    ("tileloop_tl_sc", "tpurt_tileloop", 0, True, None),
    ("tileloop_tl_xx", None, 0, True, "no device kernel"),
], ids=["error", "no_work", "work", "unknown_key"])
def test_launch_counts_its_key_once_when_it_had_work(monkeypatch, key, entry,
                                                     err, work, want):
    """``launch`` calls the key's entry point with the device's current
    stream last, raises with the kernel's name on a nonzero cudaError,
    and counts the key only when the launch had work and succeeded."""
    from types import SimpleNamespace

    from tpurt_torch.kernels import cuda_build

    lib = _FakeLibrary(err)
    monkeypatch.setattr(cuda_build, "_LOADED", [SimpleNamespace(lib=lib)])
    monkeypatch.setattr(kernels, "_stream", lambda device: 77)
    kernels.reset_launch_counts()
    if want is None:
        kernels.launch(key, "cuda", 1, 2.5, work=work)
    else:
        with pytest.raises((RuntimeError, KeyError), match=want):
            kernels.launch(key, "cuda", 1, 2.5, work=work)
    assert lib.calls == ([(entry, (1, 2.5, 77))] if entry else [])
    launched = int(want is None and work)
    assert kernels.launch_counts().get(key, 0) == launched
    assert sum(kernels.launch_counts().values()) == launched
    kernels.reset_launch_counts()


def _launch_keys():
    """Every launch key the launchers can count: K2, K3, K6, K5, S1 (flat
    and two-level), K1's modes (``tilewave._variant``), K4's names
    (tilegrid_cuda) and the ray sort's three (``kernels.raysort``)."""
    k1 = {tw._variant(pm, sc, scale, seg) for pm in (None, 1)
          for sc in (None, 1) for scale in (0.0, 1.0) for seg in (False, True)}
    k4 = {"tilegrid" + tl + ap for tl in ("", "_tl")
          for ap in ("", "_allpairs")}
    return ["entries", "exact_mask", "pair", "packet", "shade", "shade_tl",
            *sorted(k1), *sorted(k4), "raysort", "raygather", "rayrestore"]


@pytest.mark.parametrize("key", _launch_keys())
def test_every_launch_key_has_a_device_kernel(key):
    """The kernel table names a kernel that csrc defines for the key, and
    the key names the library entry point it launches through."""
    src = pathlib.Path(kernels.__file__).parent.parent / "csrc"
    kernel = kernels.KERNELS[key].split("<")[0]
    defined = "".join(f.read_text() for f in sorted(src.glob("*.cu")))
    assert f"\n{kernel}(" in defined
    assert kernels.ENTRY_POINTS[kernels._kernel_name(key)] in defined


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch finds none)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("env", [{}, {"TPURT_FUSE_BOUNCES": "1"},
                                 {"TPURT_FUSE_STAGES": "0"}],
                         ids=["stages", "whole", "unfused"])
def test_graphs_replay_bit_equal_to_eager_on_cuda(cuda_device, env):
    """Captured and replayed against the same programs run eagerly on
    the card, at a small size: the first batch (the warm-up, with the
    capture beside it), then replays with another first sample, seed
    and camera, each bit-equal in image and counters; the launches of a
    replay equal the eager batch's."""
    scene = bunny_standin(subdivisions=3)
    cfg = get_config("bunny", **BUNNY)
    graphs = _renderer(scene, cfg, env, device=cuda_device)
    eager = _renderer(scene, cfg, env, device=cuda_device, graphs=False)
    assert graphs.graphs and not eager.graphs
    cam = scene.camera
    moved = Camera(cam.position + torch.tensor([0.3, -0.1, 0.2]),
                   cam.look_at, cam.up, cam.vfov_deg)
    if "TPURT_FUSE_BOUNCES" not in env:  # else the first batch captures
        assert graphs.prewarm(cam, SEED, 0) == len(graphs.programs())
    for c, seed, s0 in ((cam, SEED, 0), (cam, SEED, 2), (cam, 9, 4),
                        (moved, SEED, 2)):
        kernels.reset_launch_counts()
        want = eager(c, seed, s0)
        want_launches = kernels.launch_counts()
        kernels.reset_launch_counts()
        got = graphs(c, seed, s0)
        assert kernels.launch_counts() == want_launches
        assert want_launches.get("tileloop", 0) > 0
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
