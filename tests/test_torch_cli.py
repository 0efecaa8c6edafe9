"""The port's command line (``python -m tpurt_torch``), checkpoints and
camera paths, on the CPU (``--cpu``), mirroring tests/unit/test_cli.py
and tests/unit/test_checkpoint.py, and against the reference where the
two packages share a format: checkpoints load in both directions, and
the flythrough cameras are the reference's.

Tolerances: resumed renders bit-identical to straight ones; camera
paths bit-equal, except an orbit whose sin/cos torch and XLA:CPU round
an ulp apart (rtol 1e-6, ROADMAP §3 transcendentals).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tpurt.render import checkpoint as ref_ck
from tpurt.scene import procedural as ref_proc
from tpurt_torch import render as port_render
from tpurt_torch.cli import main
from tpurt_torch.core.camera import Camera
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render import render_scene
from tpurt_torch.render.checkpoint import load_checkpoint, save_checkpoint
from tpurt_torch.render.png import read_png
from tpurt_torch.scene import procedural as port_proc
from tpurt_torch.utils.config import get_config

torch.set_num_threads(1)
TINY = ["--width", "32", "--height", "32", "--spp", "1", "--max-bounces",
        "0", "--cpu"]


@pytest.mark.parametrize("kind", ["auto", "bvh_tile", "bvh_pair",
                                  "bvh_packet"])
def test_render_documented_intersectors(tmp_path, kind):
    out = str(tmp_path / f"c_{kind}.png")
    assert main(["render", "--config", "cornell", "--intersector", kind,
                 "--out", out, *TINY]) == 0
    img = read_png(out)
    assert img.shape == (32, 32, 3) and img.max() > 0


@pytest.mark.parametrize("flags", [
    ["--multihost"], ["--sample-shards", "2"], ["--tile-shards", "2"],
    ["--pipeline", "mega"], ["--pipeline", "wavefront"],
    ["--intersector", "brute"], ["--intersector", "bvh"]],
    ids=lambda f: "".join(f).lstrip("-"))
def test_unported_flags_raise(tmp_path, flags):
    for cmd in ("render", "animate"):
        with pytest.raises(NotImplementedError, match="ROADMAP §1 item [56]"):
            main([cmd, "--config", "cornell", *TINY, *flags,
                  "--out" if cmd == "render" else "--out-dir",
                  str(tmp_path / "x")])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_without_cpu_flag_renders_on_the_card_or_raises(tmp_path):
    """No --cpu: the card, and without one an error — no CPU fallback."""
    args = ["--config", "cornell", "--width", "32", "--height", "32",
            "--spp", "1", "--max-bounces", "0"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["render", *args, "--out", str(tmp_path / "a.png")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["animate", *args, "--frames", "1", "--out-dir",
              str(tmp_path / "f")])
    assert not os.path.exists(tmp_path / "a.png")


def _accum(path):
    with np.load(path) as z:
        return z["accum"], int(z["n_samples"])


def test_checkpoint_resume_flags_bit_identical(tmp_path):
    """render 2 spp with --checkpoint, then --resume to 4 spp: the same
    accumulation as one 4-spp render, and the same PNG."""
    base = ["render", "--config", "cornell_pt", "--width", "24", "--height",
            "16", "--spp-per-batch", "1", "--max-bounces", "1", "--cpu"]
    ck, ck2, ck3 = (str(tmp_path / n) for n in ("a.npz", "b.npz", "c.npz"))
    assert main([*base, "--spp", "2", "--checkpoint", ck, "--out",
                 str(tmp_path / "a.png")]) == 0
    assert main([*base, "--spp", "4", "--resume", ck, "--checkpoint", ck2,
                 "--out", str(tmp_path / "b.png")]) == 0
    assert main([*base, "--spp", "4", "--checkpoint", ck3, "--out",
                 str(tmp_path / "c.png")]) == 0
    (a, n_a), (b, n_b), (c, n_c) = _accum(ck), _accum(ck2), _accum(ck3)
    assert (n_a, n_b, n_c) == (2, 4, 4)
    assert b.tobytes() == c.tobytes() and a.tobytes() != b.tobytes()
    np.testing.assert_array_equal(read_png(str(tmp_path / "b.png")),
                                  read_png(str(tmp_path / "c.png")))
    with np.load(ck) as z:
        assert sorted(z.files) == sorted(
            ["version", "accum", "n_samples", "seed", "batch_index",
             "config_json"])


def test_resume_bit_identical_api(tmp_path):
    """Stop after 2 of 4 batches, checkpoint, restart: bit-identical to
    the uninterrupted render (tests/unit/test_checkpoint.py)."""
    config = get_config("cornell_pt", width=32, height=24, spp=8,
                        spp_per_batch=2, max_bounces=2)
    straight, _ = render_scene(config, device="cpu")
    partial, _ = render_scene(dataclasses.replace(config, spp=4),
                              device="cpu")
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, partial, config)
    loaded, ck_config, _ = load_checkpoint(path, device="cpu")
    assert ck_config == config and loaded.n_samples == 4
    resumed, _ = render_scene(config, device="cpu", state=loaded)
    assert resumed.n_samples == straight.n_samples
    assert torch.equal(resumed.accum, straight.accum)


def test_checkpoints_load_in_both_packages(tmp_path):
    """A port checkpoint opens in the reference's load_checkpoint and a
    reference checkpoint in the port's: state, config and camera."""
    config = get_config("bunny", width=8, height=6, live_caps=(5, 3))
    state = fb.new_frame_state(8, 6, seed=42, device="cpu")
    state = fb.accumulate(state, torch.arange(144, dtype=torch.float32)
                          .reshape(6, 8, 3), 2)
    cam = Camera.make((1, 2, 3), (0, 0, 0), vfov_deg=60.0)
    p = str(tmp_path / "port.npz")
    save_checkpoint(p, state, config, camera=cam)
    r_state, r_config, r_cam = ref_ck.load_checkpoint(p)
    assert np.asarray(r_state.accum).tobytes() == state.accum.numpy().tobytes()
    assert (int(r_state.n_samples), int(r_state.seed),
            int(r_state.batch_index)) == (2, 42, 1)
    assert dataclasses.asdict(r_config) == dataclasses.asdict(config)
    np.testing.assert_array_equal(np.asarray(r_cam.position), [1, 2, 3])
    assert float(np.asarray(r_cam.vfov_deg)) == 60.0

    q = str(tmp_path / "ref.npz")
    ref_ck.save_checkpoint(q, r_state, r_config, camera=r_cam)
    with np.load(p) as a, np.load(q) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
    back, b_config, b_cam = load_checkpoint(q, device="cpu")
    assert torch.equal(back.accum, state.accum)
    assert (back.n_samples, back.seed, back.batch_index) == (2, 42, 1)
    assert b_config == config
    for f in ("position", "look_at", "up", "vfov_deg"):
        assert torch.equal(getattr(b_cam, f), getattr(cam, f))


def test_animate_with_readback_chunk(tmp_path):
    """Three frames flushed two at a time; one scene context for all."""
    out_dir = str(tmp_path / "frames")
    before = port_render.scene_context_builds()
    assert main(["animate", "--config", "cornell", *TINY, "--frames", "3",
                 "--readback-chunk", "2", "--out-dir", out_dir]) == 0
    assert port_render.scene_context_builds() == before + 1
    assert sorted(os.listdir(out_dir)) == [
        "frame_0000.png", "frame_0001.png", "frame_0002.png"]
    frames = [read_png(os.path.join(out_dir, f))
              for f in sorted(os.listdir(out_dir))]
    assert not np.array_equal(frames[0], frames[2])


def test_animate_frame0_equals_render(tmp_path):
    """Frame 0 of a flythrough is the preset camera: its PNG equals the
    render command's."""
    args = ["--config", "cornell", *TINY]
    assert main(["render", *args, "--out", str(tmp_path / "r.png")]) == 0
    assert main(["animate", *args, "--frames", "2", "--out-dir",
                 str(tmp_path / "f")]) == 0
    np.testing.assert_array_equal(read_png(str(tmp_path / "r.png")),
                                  read_png(str(tmp_path / "f" /
                                               "frame_0000.png")))


def test_animate_rerenders_capped_overflow_frames(tmp_path, monkeypatch):
    """Live caps too tight for the path: the deferred counters flag the
    frames, which are re-rendered uncapped (PNGs as an uncapped run's)."""
    from tpurt_torch.utils import autotune

    # the bunny (Cornell's all-pairs mode has no live caps) at 64×64:
    # 4096-ray waves, the caps rounded up to one 1024-ray tile
    args = ["--config", "bunny", "--width", "64", "--height", "64",
            "--spp", "1", "--spp-per-batch", "1", "--max-bounces", "2",
            "--frames", "2", "--cpu"]
    monkeypatch.setenv("TPURT_LIVE_TRUNC", "0")
    assert main(["animate", *args, "--out-dir", str(tmp_path / "u")]) == 0
    monkeypatch.setenv("TPURT_LIVE_TRUNC", "1")
    monkeypatch.setattr(autotune, "live_caps_for", lambda c: (16, 16))
    with pytest.warns(RuntimeWarning, match="re-rendering those frames"):
        assert main(["animate", *args, "--out-dir",
                     str(tmp_path / "c")]) == 0
    for f in ("frame_0000.png", "frame_0001.png"):
        np.testing.assert_array_equal(read_png(str(tmp_path / "c" / f)),
                                      read_png(str(tmp_path / "u" / f)))


def test_animate_autotune_records_caps(tmp_path, monkeypatch):
    table = str(tmp_path / "autotune.json")
    monkeypatch.setenv("TPURT_AUTOTUNE_PATH", table)
    assert main(["animate", "--config", "cornell_pt", "--width", "32",
                 "--height", "32", "--spp", "1", "--spp-per-batch", "1",
                 "--max-bounces", "2", "--frames", "2", "--autotune",
                 "--cpu", "--out-dir", str(tmp_path / "f")]) == 0
    assert "TPURT_AUTOTUNE_WRITE" not in os.environ
    from tpurt_torch.utils import autotune

    cfg = get_config("cornell_pt", width=32, height=32, spp=1,
                     spp_per_batch=1, max_bounces=2)
    caps = autotune.live_caps_for(cfg)
    assert len(caps) == 2 and all(c > 0 for c in caps)
    assert len(autotune.want_caps_for(cfg)) == 3


def test_export_subcommand(tmp_path):
    out = str(tmp_path / "cornell.glb")
    assert main(["export", "--config", "cornell", "--out", out]) == 0
    assert os.path.getsize(out) > 1000
    from tpurt_torch.scene.loader import load_scene

    assert load_scene(out).num_triangles > 0


def test_profile_writes_a_trace(tmp_path):
    prof = str(tmp_path / "prof")
    assert main(["render", "--config", "cornell", *TINY, "--out",
                 str(tmp_path / "p.png"), "--profile", prof]) == 0
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0


def test_info(capsys):
    assert main(["info", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out and "sponza" in out
    assert "native host library" in out and "CUDA kernels" in out


@pytest.mark.parametrize("name,frames,exact", [
    ("sponza", 8, True), ("bunny", 5, True), ("cornell", 7, False)])
def test_flythrough_cameras_match_reference(name, frames, exact):
    got = port_proc.flythrough_cameras(name, frames)
    want = ref_proc.flythrough_cameras(name, frames)
    assert len(got) == len(want) == frames
    for g, w in zip(got, want):
        for f in ("position", "look_at", "up", "vfov_deg"):
            a, b = getattr(g, f).numpy(), np.asarray(getattr(w, f))
            if exact:
                assert a.tobytes() == b.tobytes(), f
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f)
    if name == "sponza":
        cam = port_proc.sponza_standin(8, 3).camera
        for f in ("position", "look_at", "up", "vfov_deg"):
            assert torch.equal(getattr(got[0], f), getattr(cam, f))
