"""The port's wavefront loop (``render.wavefront``) against the reference's
``render_batch_wavefront_jit`` and against the port's own megakernel,
mirroring tests/unit/test_wavefront.py, on the CPU.

Tolerances: against the reference, the reference's own bar between its
two pipelines (ray counts within 0.5%, under 0.5% of values off by more
than 1e-4, RMSE under 1e-2: a borderline lane can flip where the two
sides round an ulp apart, ROADMAP §3). The port's wavefront against the
port's megakernel: the same estimator summed in another order, within
1e-5, counters equal. The ring's capacity changes only the order of the
sums (1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.render import build_accel as ref_build_accel
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.render.wavefront import render_batch_wavefront_jit as ref_wave
from tpurt.scene import procedural as ref_proc
from tpurt.scene.device import to_device as ref_to_device
from tpurt.utils.config import get_config as ref_config
from tpurt_torch.render import build_accel
from tpurt_torch.render.integrator import render_batch
from tpurt_torch.render.intersectors import scene_meta
from tpurt_torch.render.wavefront import render_batch_wavefront
from tpurt_torch.scene import procedural
from tpurt_torch.scene.device import to_device
from tpurt_torch.utils.config import get_config

torch.set_num_threads(1)

SEED = 7


def _port(config, scene):
    meta = scene_meta(scene)
    ds = to_device(scene, device="cpu")
    return ds, meta, build_accel(config, ds, meta, scene=scene,
                                 device="cpu")


def _assert_equivalent(img, rays, want, want_rays):
    np.testing.assert_allclose(rays, want_rays, rtol=5e-3)
    diff = np.abs(img - want)
    assert float((diff > 1e-4).mean()) < 5e-3
    assert float(np.sqrt((diff ** 2).mean())) < 1e-2


def _against_reference(**over):
    rc, pc = ref_config("cornell_pt", **over), get_config("cornell_pt",
                                                          **over)
    rs = ref_proc.cornell_box(path_tracer=True)
    ps = procedural.cornell_box(path_tracer=True)
    rmeta, rds = ref_meta(rs), ref_to_device(rs)
    racc = ref_build_accel(rc, rds, rmeta, scene=rs)
    want, wrays = ref_wave(rds, rs.camera, jnp.uint32(SEED), jnp.uint32(0),
                           racc, meta=rmeta, config=rc)
    ds, meta, acc = _port(pc, ps)
    img, rays = render_batch_wavefront(ds, ps.camera, SEED, 0, acc,
                                       meta=meta, config=pc)
    _assert_equivalent(img.numpy(), rays.numpy(), np.asarray(want),
                       np.asarray(wrays))
    return img, rays, (ds, meta, acc, ps, pc)


@pytest.mark.parametrize("material_sort", [True, False])
def test_wavefront_matches_reference(material_sort):
    img, rays, _ = _against_reference(
        width=48, height=32, spp_per_batch=2, max_bounces=3,
        wavefront_capacity=512, material_sort=material_sort,
        intersector="brute")
    assert img.shape == (32, 48, 3) and float(img.mean()) > 0.01
    assert rays[1] > 0


def test_wavefront_through_bvh_matches_reference_and_megakernel():
    img, rays, (ds, meta, acc, scene, cfg) = _against_reference(
        width=32, height=24, spp_per_batch=1, max_bounces=2,
        intersector="bvh", wavefront_capacity=256)
    mega, mrays = render_batch(ds, scene.camera, SEED, 0, acc, meta=meta,
                               config=cfg)
    np.testing.assert_allclose(img.numpy(), mega.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(rays, mrays)


@pytest.mark.parametrize("material_sort", [True, False])
def test_wavefront_matches_megakernel(material_sort):
    """The same estimator as the megakernel, summed in another order."""
    cfg = get_config("cornell_pt", width=32, height=24, spp_per_batch=2,
                     max_bounces=3, wavefront_capacity=300,
                     material_sort=material_sort, intersector="brute")
    scene = procedural.cornell_box(path_tracer=True)
    ds, meta, acc = _port(cfg, scene)
    img, rays = render_batch_wavefront(ds, scene.camera, SEED, 0, acc,
                                       meta=meta, config=cfg)
    mega, mrays = render_batch(ds, scene.camera, SEED, 0, acc, meta=meta,
                               config=cfg)
    np.testing.assert_allclose(img.numpy(), mega.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(rays, mrays)


def test_wavefront_capacity_invariance():
    """The ring's size is an execution detail: the same image up to the
    order of the sums, and the same counters."""
    scene = procedural.cornell_box(path_tracer=True)
    out = []
    for cap in (128, 4096):
        cfg = get_config("cornell_pt", width=24, height=16, spp_per_batch=2,
                         max_bounces=2, wavefront_capacity=cap,
                         intersector="brute")
        ds, meta, acc = _port(cfg, scene)
        out.append(render_batch_wavefront(ds, scene.camera, 3, 0, acc,
                                          meta=meta, config=cfg))
    np.testing.assert_allclose(out[0][0].numpy(), out[1][0].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(out[0][1], out[1][1])


def test_wavefront_same_seed_bit_equal():
    """Two renders with one seed are bit-equal (the frame sums lanes of a
    pixel in a fixed order)."""
    cfg = get_config("cornell_pt", width=24, height=16, spp_per_batch=4,
                     max_bounces=2, wavefront_capacity=256,
                     intersector="brute")
    scene = procedural.cornell_box(path_tracer=True)
    ds, meta, acc = _port(cfg, scene)
    a = render_batch_wavefront(ds, scene.camera, 5, 0, acc, meta=meta,
                               config=cfg)
    b = render_batch_wavefront(ds, scene.camera, 5, 0, acc, meta=meta,
                               config=cfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
