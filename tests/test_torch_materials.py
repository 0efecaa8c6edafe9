"""tpurt_torch.materials against tpurt.materials on the same inputs: real
shade records of the bunny and Cornell path-tracer scenes (every material
family), random hits, and the same RNG stream.

Tolerance: atol 1e-6 plus 1e-6 relative (torch and XLA:CPU round
pow/cos/sqrt and contracted multiply-adds differently in the last bits;
the relative part covers Cornell's ~555-unit distances, where one f32 ulp
is 6e-5); the pow-heavy BRDF and light terms 1e-5 relative; boolean and
integer outputs exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt import materials as ref
from tpurt.bvh.paircluster import build_pair_accel as ref_build
from tpurt.core.prng import PixelSampler as RefSampler
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import procedural as ref_proc
from tpurt.scene.device import to_device as ref_to_device
from tpurt_torch import materials as port
from tpurt_torch.core.prng import PixelSampler as PortSampler
from tpurt_torch.scene import procedural as port_proc
from tpurt_torch.scene.device import to_device as port_to_device

ATOL = 1e-6
SCENES = {
    "bunny3": lambda m: m.bunny_standin(subdivisions=3),
    "cornell_pt": lambda m: m.cornell_box(path_tracer=True),
}
N = 4096


@pytest.fixture(scope="module", params=sorted(SCENES))
def hits(request):
    """Random hits on every slot kind of the scene, resolved by both."""
    rs = SCENES[request.param](ref_proc)
    ps = SCENES[request.param](port_proc)
    accel = ref_build(None, ref_meta(rs), scene=rs)
    rng = np.random.default_rng(5)
    n_slots = accel.shade_rows.shape[0]
    slot = rng.integers(-1, n_slots, N).astype(np.int32)
    org = rng.normal(size=(N, 3)).astype(np.float32) * 3.0
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.uniform(0.1, 5.0, N).astype(np.float32)
    u = rng.uniform(0.0, 0.6, N).astype(np.float32)
    v = (rng.uniform(0.0, 1.0, N) * (1.0 - u)).astype(np.float32)
    r_attrs = ref.resolve_hit_packed(jnp.asarray(accel.shade_rows),
                                     *map(jnp.asarray, (org, d, t, u, v,
                                                        slot)))
    T = torch.from_numpy
    p_attrs = port.resolve_hit_packed(T(accel.shade_rows), T(org), T(d),
                                      T(t), T(u), T(v), T(slot))
    pid = rng.integers(0, 800 * 600, N).astype(np.uint32)
    samplers = (RefSampler.make(3, jnp.uint32(16), jnp.asarray(pid)),
                PortSampler.make(3, 16, T(pid.astype(np.int64))))
    return dict(r=r_attrs, p=p_attrs, d=d, org=org, samplers=samplers,
                r_ds=ref_to_device(rs), p_ds=port_to_device(ps, device="cpu"))


def _eq(got, want, name):
    got = got.numpy()
    want = np.asarray(want)
    if got.dtype == bool or np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL,
                                   err_msg=name)


def test_resolve_hit_packed(hits):
    for f in ref.HitAttrs._fields:
        _eq(getattr(hits["p"], f), getattr(hits["r"], f), f)


def test_eval_brdf(hits):
    rng = np.random.default_rng(9)
    wi = rng.normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wo = -hits["d"]
    want = ref.eval_brdf(hits["r"], jnp.asarray(wo), jnp.asarray(wi))
    got = port.eval_brdf(hits["p"], torch.from_numpy(wo),
                         torch.from_numpy(wi))
    # Blinn-Phong's ndh**64 peak scales the last-bit pow difference
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=ATOL)
    assert (np.asarray(want) > 0).any()


@pytest.mark.parametrize("bounce", [0, 2])
def test_sample_bounce(hits, bounce):
    rs, ps = hits["samplers"]
    wo = -hits["d"]
    want = ref.sample_bounce(hits["r"], jnp.asarray(wo), rs, bounce)
    got = port.sample_bounce(hits["p"], torch.from_numpy(wo), ps, bounce)
    for f in ("wi", "is_specular", "offset_sign"):
        _eq(getattr(got, f), getattr(want, f), f)
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("bounce", [0, 1])
def test_sample_light(hits, bounce):
    rs, ps = hits["samplers"]
    pos = hits["org"]
    want = ref.sample_light(hits["r_ds"], jnp.asarray(pos), rs, bounce)
    got = port.sample_light(hits["p_ds"], torch.from_numpy(pos), ps, bounce)
    for name, g, w in zip(("wi", "dist", "radiance_over_pdf", "valid"),
                          got, want):
        if name == "radiance_over_pdf":  # emission · G, values up to ~1e3
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=ATOL)
        else:
            _eq(g, w, name)


def test_bounce_origin(hits):
    sign = np.where(np.arange(N) % 3 == 0, -1.0, 1.0).astype(np.float32)
    want = ref.bounce_origin(hits["r"], jnp.asarray(sign))
    got = port.bounce_origin(hits["p"], torch.from_numpy(sign))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=ATOL)
