"""The port's megakernel (``render.integrator.render_batch``) against the
reference's ``render_batch_jit`` on identical scenes, seeds and configs,
on the CPU: the Cornell box through the brute force, a bunny subset
through the two-level LBVH and through the tile intersector (the
reference's in interpret mode), a run without NEE, and flat shading; and
``render_scene(pipeline="mega", intersector="bvh")`` — the path that made
the committed bunny golden — against ``bunny.npz``.

Tolerances: the ray counters equal; images within RMSE 1e-3 with under
2% of pixels off by more than 1e-3 (tests/test_torch_render.py: a
decision at the last ulp can reroute a path at a few pixels).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.golden.configs import GOLDENS
from tpurt.render import build_accel as ref_build_accel
from tpurt.render.integrator import render_batch_jit as ref_render_batch
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import procedural as ref_proc
from tpurt.scene.device import to_device as ref_to_device
from tpurt.utils.config import get_config as ref_config
from tpurt_torch.render import build_accel, render_scene
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render.integrator import render_batch
from tpurt_torch.render.intersectors import scene_meta
from tpurt_torch.scene import procedural
from tpurt_torch.scene.device import to_device
from tpurt_torch.utils.config import get_config

torch.set_num_threads(1)

SEED = 7


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def assert_close_images(img, want):
    assert img.shape == want.shape and np.isfinite(img).all()
    assert _rmse(img, want) <= 1e-3
    assert float((np.abs(img - want) > 1e-3).mean()) < 0.02


def both_batches(preset, scene_fn, **over):
    """One batch of each package's megakernel: (port image, port
    counters, reference image, reference counters)."""
    rs, ps = scene_fn(ref_proc), scene_fn(procedural)
    rc, pc = ref_config(preset, **over), get_config(preset, **over)
    rmeta, pmeta = ref_meta(rs), scene_meta(ps)
    rds, pds = ref_to_device(rs), to_device(ps, device="cpu")
    racc = ref_build_accel(rc, rds, rmeta, scene=rs)
    pacc = build_accel(pc, pds, pmeta, scene=ps, device="cpu")
    want, wrays = ref_render_batch(rds, rs.camera, jnp.uint32(SEED),
                                   jnp.uint32(0), racc, meta=rmeta, config=rc)
    img, rays = render_batch(pds, ps.camera, SEED, 0, pacc, meta=pmeta,
                             config=pc)
    return img.numpy(), rays.numpy(), np.asarray(want), np.asarray(wrays)


CASES = {
    "cornell_brute": ("cornell", lambda p: p.cornell_box(),
                      dict(width=32, height=32, spp_per_batch=2,
                           intersector="brute")),
    "bunny_bvh": ("bunny", lambda p: p.bunny_standin(subdivisions=3),
                  dict(width=32, height=24, spp_per_batch=2,
                       intersector="bvh")),
    "bunny_tile": ("bunny", lambda p: p.bunny_standin(subdivisions=3),
                   dict(width=32, height=32, spp_per_batch=1, max_bounces=0,
                        intersector="bvh_tile")),
    "cornell_pt_no_nee": ("cornell_pt",
                          lambda p: p.cornell_box(path_tracer=True),
                          dict(width=32, height=24, spp_per_batch=2,
                               max_bounces=3, use_nee=False,
                               intersector="brute")),
    "hello_flat": ("hello_triangle", lambda p: p.hello_triangle(),
                   dict(width=40, height=30, spp_per_batch=1,
                        intersector="brute")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_batch_matches_reference(case):
    preset, scene_fn, over = CASES[case]
    img, rays, want, wrays = both_batches(preset, scene_fn, **over)
    h, w = over["height"], over["width"]
    assert img.shape == (h, w, 3)
    np.testing.assert_array_equal(rays, wrays.astype(np.float64))
    assert rays[0] >= h * w * over["spp_per_batch"]
    assert_close_images(img, want)
    if over.get("use_nee", True) and preset != "hello_triangle":
        assert rays[1] > 0
    assert img.mean() > 0.01


def test_megakernel_bunny_golden():
    """The bunny golden's config through mega + bvh (the path that
    generated tests/golden/data/bunny.npz), full 82k-triangle bunny."""
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                  "data", "bunny.npz"))["image"]
    cfg = get_config("bunny", pipeline="mega", intersector="bvh",
                     **GOLDENS["bunny"])
    state, stats = render_scene(cfg, device="cpu")
    img = fb.resolve(state).numpy()
    assert img.shape == golden.shape
    assert _rmse(img, golden) <= 1e-3
    assert stats["spp"] == GOLDENS["bunny"]["spp"]
    assert not stats["live_overflow"] and stats["live_counts"] == []


def test_scene_cache_keys_the_leaf_size():
    """The LBVH's leaf size shapes its accel: a render with another leaf
    size builds its own (the walk tests ``leaf_size`` triangles a leaf),
    and ends as a fresh render of that config does."""
    scene = procedural.bunny_standin(subdivisions=3)
    cfg = get_config("bunny", width=32, height=24, spp=1, spp_per_batch=1,
                     pipeline="mega", intersector="bvh")
    render_scene(cfg, device="cpu", scene=scene)
    small = dataclasses.replace(cfg, bvh_leaf_size=1)
    state, _ = render_scene(small, device="cpu", scene=scene)
    fresh, _ = render_scene(small, device="cpu",
                            scene=procedural.bunny_standin(subdivisions=3))
    assert torch.equal(state.accum, fresh.accum)
