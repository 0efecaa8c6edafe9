"""``TPURT_CAPTURE_WAVES`` and ``TPURT_DEBUG_STAGES`` in tpurt_torch's
staged loop against the reference's, on one small render (the bunny
stand-in at 32×24 × 1 spp, 2 bounces, NEE).

The capture writes the reference's files with its keys, shapes and
dtypes. Their arrays come from shading (bounce origins, sampled
directions, light distances), where XLA:CPU's contracted multiply-adds
and torch's transcendentals round apart (ROADMAP §3), so they are held
within 1e-4 absolute (positions and directions of a unit-scale scene,
distances relative), with the masks (alive, want) equal on ≥ 99% of the
rays. Neither switch may change the image, and the capture forces the
default loop as the reference's does.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from tpurt.render import render_scene as ref_render
from tpurt.scene.procedural import bunny_standin as ref_bunny
from tpurt.utils.config import get_config as ref_config
from tpurt_torch import render as rd
from tpurt_torch.render.staged import StagedRenderer
from tpurt_torch.scene.procedural import bunny_standin as port_bunny
from tpurt_torch.utils.config import get_config

SMALL = dict(width=32, height=24, spp=1, spp_per_batch=1, max_bounces=2)
FILES = {f"bounce{b}_wave.npz": ("org", "dirn", "alive") for b in (1, 2)}
FILES.update({f"shadow{b}_wave.npz": ("org", "dirn", "tmax", "want")
              for b in (0, 1, 2)})
STAGES = ["raygen"] + [f"{s}[{b}]" for b in range(3)
                       for s in ("trace", "shade", "occlude")]


def _stage_names(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith("    [stage] ")]
    for ln in lines:
        assert ln.endswith("s") and ": " in ln, ln
        float(ln.rsplit(": ", 1)[1][:-1])
    return [ln[len("    [stage] "):].rsplit(": ", 1)[0] for ln in lines]


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """The reference's and the port's captures of the same render; the
    port's images without the switches, under both (and its stage
    lines), and of the sorted-wave config under the capture."""
    root = tmp_path_factory.mktemp("capture")
    scene = port_bunny(subdivisions=3)
    cfg = get_config("bunny", **SMALL)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPURT_CAPTURE_WAVES", str(root / "ref"))
        ref_render(ref_config("bunny", pipeline="staged",
                              intersector="bvh_tile", **SMALL),
                   scene=ref_bunny(subdivisions=3))
        mp.delenv("TPURT_CAPTURE_WAVES")
        plain, _ = rd.render_scene(cfg, device="cpu", scene=scene)
        mp.setenv("TPURT_CAPTURE_WAVES", str(root / "port"))
        mp.setenv("TPURT_DEBUG_STAGES", "1")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            captured, _ = rd.render_scene(cfg, device="cpu", scene=scene)
        mp.setenv("TPURT_CAPTURE_WAVES", str(root / "sorted"))
        mp.delenv("TPURT_DEBUG_STAGES")
        srt, _ = rd.render_scene(get_config("bunny", sorted_wave=True,
                                            **SMALL), device="cpu",
                                 scene=scene)
    return dict(root=root, plain=plain.accum, captured=captured.accum,
                sorted=srt.accum, stdout=out.getvalue())


@pytest.mark.parametrize("run", ["ref", "port", "sorted"])
def test_capture_files_names_and_keys(captures, run):
    """Each run writes the reference's files: bounce waves from bounce 1,
    shadow waves from bounce 0 (the sorted-wave config too: the capture
    forces the default loop)."""
    d = captures["root"] / run
    assert sorted(os.listdir(d)) == sorted(FILES)
    ref = captures["root"] / "ref"
    for name, keys in FILES.items():
        got, want = np.load(d / name), np.load(ref / name)
        assert sorted(got.files) == sorted(keys)
        for k in keys:
            assert got[k].dtype == want[k].dtype, (name, k)
            assert got[k].shape == want[k].shape, (name, k)
        assert got["org"].shape == (SMALL["width"] * SMALL["height"], 3)


@pytest.mark.parametrize("name", sorted(FILES))
def test_captured_waves_match_reference(captures, name):
    got = np.load(captures["root"] / "port" / name)
    want = np.load(captures["root"] / "ref" / name)
    mask = "alive" if "alive" in want.files else "want"
    same = got[mask] == want[mask]
    assert same.mean() >= 0.99, (name, same.mean())
    both = got[mask] & want[mask]
    assert both.sum() > 20  # the comparison covers real rays
    for k in ("org", "dirn"):
        np.testing.assert_allclose(got[k][both], want[k][both], atol=1e-4,
                                   err_msg=k)
    if mask == "want":
        np.testing.assert_allclose(got["tmax"][both], want["tmax"][both],
                                   rtol=1e-4, err_msg="tmax")
        # rays that want no shadow test are dead lanes in both packages
        np.testing.assert_array_equal(got["tmax"][~got[mask]], -1.0)


def test_switches_leave_the_image(captures):
    assert torch.equal(captures["captured"], captures["plain"])
    assert torch.equal(captures["sorted"], captures["plain"])


def test_debug_prints_every_stage(captures):
    assert _stage_names(captures["stdout"]) == STAGES


def test_capture_refuses_a_mesh(monkeypatch, tmp_path):
    """A rank holds only its shard's waves: the capture takes a
    single-process render."""

    class Shard:
        n_tile, n_sample, tile_id, sample_id = 2, 1, 0, 0

    monkeypatch.setenv("TPURT_CAPTURE_WAVES", str(tmp_path))
    scene = port_bunny(subdivisions=3)
    cfg = get_config("bunny", **SMALL)
    ds = rd.to_device(scene, device="cpu")
    meta = rd.scene_meta(scene)
    accel = rd.build_accel(cfg, ds, meta, scene=scene, device="cpu")
    with pytest.raises(ValueError, match="single-process"):
        StagedRenderer(ds, accel, meta=meta, config=cfg, device="cpu",
                       mesh=Shard())
