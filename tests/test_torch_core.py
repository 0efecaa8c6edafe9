"""The port's core functions that no render path calls, against the
reference's on the same seeded numpy inputs: the brute-force closest-hit
oracle (``vecmath.closest_hit_brute_force``), the row-major pixel order
(``camera.full_frame_pixels``) and the MIS power heuristic
(``sampling.power_heuristic``).

Tolerances: the hit mask and the triangle id equal, t within 1e-6
relative and the barycentrics within 1e-4 (ROADMAP §3, "FMA
contraction": XLA:CPU contracts the multiply-adds the port rounds one by
one); the pixel order bit-equal; the heuristic within 1 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.core import camera as ref_camera
from tpurt.core import sampling as ref_sampling
from tpurt.core import vecmath as ref_vecmath
from tpurt_torch.core import camera, sampling, vecmath


def test_closest_hit_brute_force_matches_reference(rng):
    n_rays, n_tris = 512, 64
    org = rng.uniform(-1.0, 1.0, (n_rays, 3)).astype(np.float32)
    org[:, 2] -= 3.0
    target = rng.uniform(-0.6, 0.6, (n_rays, 3)).astype(np.float32)
    dirn = target - org
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    centers = rng.uniform(-0.8, 0.8, (n_tris, 3)).astype(np.float32)
    v0, v1, v2 = (centers + rng.normal(0.0, 0.3, (n_tris, 3)).astype(
        np.float32) for _ in range(3))
    t_min = np.full(n_rays, 1e-4, np.float32)
    t_max = np.full(n_rays, np.inf, np.float32)
    t_max[::7] = 2.0  # some rays stop short

    want = [np.asarray(x) for x in ref_vecmath.closest_hit_brute_force(
        *(jnp.asarray(a) for a in (org, dirn, v0, v1, v2, t_min, t_max)))]
    got = [x.numpy() for x in vecmath.closest_hit_brute_force(
        *(torch.from_numpy(a) for a in (org, dirn, v0, v1, v2, t_min,
                                        t_max)))]
    t, u, v, tri, hit = got
    w_t, w_u, w_v, w_tri, w_hit = want
    np.testing.assert_array_equal(hit, w_hit)
    assert 0.2 < hit.mean() < 1.0  # hits and misses both exercised
    np.testing.assert_array_equal(tri[hit], w_tri[hit])
    np.testing.assert_array_equal(tri[~hit], 0)
    assert np.isinf(t[~hit]).all() and np.isinf(w_t[~hit]).all()
    np.testing.assert_allclose(t[hit], w_t[hit], rtol=1e-6)
    np.testing.assert_allclose(u[hit], w_u[hit], atol=1e-4)
    np.testing.assert_allclose(v[hit], w_v[hit], atol=1e-4)


@pytest.mark.parametrize("width,height", [(1, 1), (5, 3), (40, 24),
                                          (800, 600)])
def test_full_frame_pixels_bit_equal(width, height):
    px, py = camera.full_frame_pixels(width, height)
    want_px, want_py = ref_camera.full_frame_pixels(width, height)
    assert px.dtype == py.dtype == torch.int32
    np.testing.assert_array_equal(px.numpy(), np.asarray(want_px))
    np.testing.assert_array_equal(py.numpy(), np.asarray(want_py))


def test_power_heuristic_within_one_ulp(rng):
    a = rng.uniform(0.0, 10.0, 4096).astype(np.float32)
    b = rng.uniform(0.0, 10.0, 4096).astype(np.float32)
    a[:4], b[:4] = [0.0, 0.0, 1e-12, 3.0], [0.0, 2.0, 0.0, 1e-30]
    want = np.asarray(ref_sampling.power_heuristic(jnp.asarray(a),
                                                   jnp.asarray(b)))
    got = sampling.power_heuristic(torch.from_numpy(a),
                                   torch.from_numpy(b)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
