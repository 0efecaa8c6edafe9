"""tpurt_torch.core.prng against tpurt.core.prng: the counter-based RNG
must give the reference's bits exactly (tolerance: bit-equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.core import prng as ref
from tpurt_torch.core import prng as port


def _u32(rng, n):
    x = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]  # edges of the 32-bit range
    return x


def test_pcg_hash_bit_equal(rng):
    x = _u32(rng, 50_000)
    want = np.asarray(ref.pcg_hash(jnp.asarray(x)))
    got = port.pcg_hash(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2 ** 32


@pytest.mark.parametrize("seed", [0, 5, 0xFFFFFFFF])
def test_pixel_sampler_bit_equal(rng, seed):
    sample = _u32(rng, 4096)
    pixel = rng.integers(0, 800 * 600, 4096).astype(np.uint32)
    s_ref = ref.PixelSampler.make(seed, jnp.asarray(sample),
                                  jnp.asarray(pixel))
    s_port = port.PixelSampler.make(
        seed, torch.from_numpy(sample.astype(np.int64)),
        torch.from_numpy(pixel.astype(np.int64)))
    np.testing.assert_array_equal(
        s_port.base.numpy().astype(np.uint32), np.asarray(s_ref.base))
    for tag in (ref.TAG_JITTER, ref.bounce_tag(0, ref.SITE_DIFFUSE),
                ref.bounce_tag(2, ref.SITE_FRESNEL), 1000):
        np.testing.assert_array_equal(s_port.u01(tag).numpy(),
                                      np.asarray(s_ref.u01(tag)))
        np.testing.assert_array_equal(s_port.u2(tag).numpy(),
                                      np.asarray(s_ref.u2(tag)))


def test_tag_layout_matches():
    names = ["TAG_JITTER", "BOUNCE_BASE", "BOUNCE_STRIDE", "SITE_LIGHT_PICK",
             "SITE_LIGHT_BARY", "SITE_DIFFUSE", "SITE_SPHERE", "SITE_FRESNEL"]
    for name in names:
        assert getattr(port, name) == getattr(ref, name), name
    for b in range(5):
        for site in range(8):
            assert port.bounce_tag(b, site) == ref.bounce_tag(b, site)
