"""tpurt_torch's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA GPU and skips without one.

This file imports neither jax nor tpurt, so it also runs where only the
port's dependencies are installed (a GPU machine without jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances (as chip_smoke.py): the entry build bit-equal; the traversal
loop with the slot equal on ≥ 99.99% of live rays and bt within 1e-6
relative on those; a render on the card within RMSE 1e-3 of the same
render on the CPU (the plain versions, and torch's CPU and CUDA
elementwise kernels round transcendentals differently).
"""

import numpy as np
import pytest
import torch

from tpurt_torch.bvh.paircluster import build_pair_accel
from tpurt_torch.kernels import tilewave as tw
from tpurt_torch.render import framebuffer as fb
from tpurt_torch.render import render_scene
from tpurt_torch.render.intersectors import scene_meta
from tpurt_torch.scene.procedural import bunny_standin
from tpurt_torch.utils.config import get_config


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch finds none)")
    return torch.device("cuda", 0)


@pytest.fixture
def wave(cuda_device):
    """Three tiles of seeded random rays around bunny_standin(3) (14
    clusters), with capped tmax and some dead lanes, on the card."""
    scene = bunny_standin(subdivisions=3)
    accel = build_pair_accel(None, scene_meta(scene), scene=scene)
    rng = np.random.default_rng(7)
    n = 3 * tw.TILE
    center = (accel.cluster_lo.min(0) + accel.cluster_hi.max(0)) / 2
    org = center + rng.normal(size=(n, 3)) * 4.5
    d = center + rng.normal(size=(n, 3)) * 1.2 - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(n) % 9 == 0, -1.0, rng.uniform(2.0, 12.0, n))
    t = lambda x: torch.from_numpy(
        np.asarray(x, np.float32)).to(cuda_device)
    acc = accel.to(cuda_device)
    dirn = t(d)
    return dict(org=t(org), dirn=dirn, inv_d=tw._safe_inv(dirn),
                tmax=t(tmax), accel=acc,
                scale=tw.tn_scale_of(accel.cluster_lo, accel.cluster_hi))


@pytest.mark.cuda
def test_entries_cuda_matches_plain(cuda_device):
    rng = np.random.default_rng(3)
    n_tiles, n_c = 3, 200  # 200 clusters pad to 256 lanes
    n = n_tiles * tw.TILE
    org = rng.normal(size=(n, 3)) * 5.0
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.where(np.arange(n) % 7 == 0, -1.0, 30.0)
    lo = rng.uniform(-8, 6, size=(n_c, 3))
    hi = lo + rng.uniform(0.1, 2.0, size=(n_c, 3))
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(cuda_device)
    scale = tw.tn_scale_of(lo, hi)
    args = (t(org), tw._safe_inv(t(d)), t(tm), t(lo), t(hi), scale)
    before = tw.entries_cuda.launches
    got = tw.entries_cuda(*args)
    assert tw.entries_cuda.launches == before + 1
    want = tw.entries_plain(*args)
    assert got.shape == (n_tiles, 256)
    assert torch.equal(got, want)
    assert bool((got != tw.INT32_MAX).any())


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "lean_any"])
def test_tileloop_cuda_matches_plain(wave, any_hit):
    w = wave
    acc = w["accel"]
    entry = tw.entries_cuda(w["org"], w["inv_d"], w["tmax"], acc.cluster_lo,
                            acc.cluster_hi, w["scale"])
    counts = (entry != tw.INT32_MAX).sum(dim=1, dtype=torch.int32)
    entry = torch.sort(entry, dim=1).values
    args = (w["org"], w["dirn"], w["inv_d"], w["tmax"], acc.tri_rows, entry,
            counts, w["scale"], any_hit)
    kt, ku, kv, ks = tw.tileloop_cuda(*args)
    pt, pu, pv, ps = tw.tileloop_plain(*args)
    live = w["tmax"] >= 0
    same = live & (ks == ps)
    assert int(same.sum()) >= 0.9999 * int(live.sum())
    assert int((ps[live] >= 0).sum()) > 100  # the rays do hit the bunny
    rel = ((kt - pt).abs() / pt.abs().clamp_min(1e-30))[same]
    assert float(rel.max()) <= 1e-6


@pytest.mark.cuda
def test_render_on_cuda_matches_cpu(cuda_device):
    """The main path on the card launches both kernels, repeats bit for
    bit, and matches the CPU render (plain versions) of the same seed."""
    cfg = get_config("bunny", width=64, height=48, spp=2, spp_per_batch=2,
                     max_bounces=2)
    scene = bunny_standin(subdivisions=3)
    cpu, _ = render_scene(cfg, device="cpu", scene=scene)
    tw.reset_launch_counts()
    gpu, stats = render_scene(cfg, device=cuda_device, scene=scene)
    assert tw.entries_cuda.launches > 0 and tw.tileloop_cuda.launches > 0
    again, _ = render_scene(cfg, device=cuda_device, scene=scene)
    assert torch.equal(gpu.accum, again.accum)
    a = fb.resolve(gpu).cpu().numpy()
    b = fb.resolve(cpu).numpy()
    assert np.isfinite(a).all()
    assert float(np.sqrt(np.mean((a - b) ** 2))) <= 1e-3
    assert stats["rays_traced"] > 0
