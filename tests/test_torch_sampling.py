"""tpurt_torch.core.sampling's threefry keys against jax.random.

``batch_key`` is ``jax.random.fold_in`` and ``uniform2`` is
``jax.random.uniform(key, (*shape, 2))``: both are integer hashes and a
bit cast, so keys and uniforms must be bit-equal, for every seed, batch
index (0 and 2^32 - 1 included) and shape (odd sizes included).
"""

import jax
import numpy as np
import pytest
import torch

from tpurt_torch.core import sampling

SEEDS = [0, 1, 42, 2 ** 31 - 1, -1, 2 ** 33 + 5]
BATCHES = [0, 1, 7, 123456, 2 ** 32 - 1]


def _key_data(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_seed_matches_prng_key(seed):
    got = sampling._threefry_seed(seed)
    assert got.dtype == torch.int64 and got.shape == (2,)
    np.testing.assert_array_equal(got.numpy(),
                                  _key_data(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("batch", BATCHES)
def test_batch_key_matches_fold_in(seed, batch):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), batch))
    got = sampling.batch_key(sampling._threefry_seed(seed), batch)
    assert got.dtype == torch.int64 and got.shape == (2,)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (5,), (3, 7), (60, 80), (2, 3, 5)])
@pytest.mark.parametrize("seed,batch", [(0, 0), (42, 2 ** 32 - 1),
                                        (7, 3)])
def test_uniform2_bit_equal(seed, batch, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), batch)
    want = np.asarray(jax.random.uniform(key, shape + (2,),
                                         dtype=np.float32))
    got = sampling.uniform2(
        sampling.batch_key(sampling._threefry_seed(seed), batch), shape)
    assert got.dtype == torch.float32 and got.shape == shape + (2,)
    assert got.numpy().tobytes() == want.tobytes()
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


def test_threefry_matches_known_answer():
    """The Threefry-2x32 known-answer vector of jax's own tests (Random123):
    key (0x13198a2e, 0x03707344), counters (0x243f6a88, 0x85a308d3)."""
    key = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64)
    y0, y1 = sampling._threefry_2x32(key, torch.tensor([0x243F6A88]),
                                     torch.tensor([0x85A308D3]))
    assert (int(y0[0]), int(y1[0])) == (0xC4923A9C, 0x483DF7A0)
