"""The tile intersector's ray sort (``tpurt_torch.kernels.raysort``) on
the CPU: the card's 32-bit keys keep the order and the ties of
``_octant_sort_keys``'s int64 keys, so their stable sorts give the same
permutation, on waves with dead rays, ±0.0 directions, origins outside
the scene box and NaN or infinite origin components; the key kernel's
f32 steps (``csrc/raysort.cu``, written out in numpy here) give those
keys; a capped wave counts the live rays past its cut, and the restore
puts every output back with the dead-lane values past the cut. The
kernels themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from tpurt_torch.kernels import raysort as rs
from tpurt_torch.kernels import tilewave as tw

LO = torch.tensor([-1.0, -0.5, -2.0])
HI = torch.tensor([3.0, 2.5, 1.0])


def _wave(kind: str, n: int = 4096, seed: int = 5):
    """(org, dirn, tmv) f32: random rays around the scene box (some
    origins outside it), a third dead; ``edge`` adds ±0.0 direction
    components, origins on the box faces, NaN and ±inf origin components
    and NaN tmax on live rays, and whole runs of equal keys."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-3.0, 4.0, size=(n, 3)).astype(np.float32)
    dirn = rng.normal(size=(n, 3)).astype(np.float32)
    tmv = rng.uniform(0.0, 20.0, n).astype(np.float32)
    tmv[rng.random(n) < 0.33] = -1.0
    if kind == "edge":
        dirn[rng.random((n, 3)) < 0.1] = 0.0
        dirn[rng.random((n, 3)) < 0.1] = -0.0
        org[:64] = LO.numpy()
        org[64:128] = HI.numpy()
        org[128:256] = org[128]  # one key, alive and dead interleaved
        dirn[128:256] = dirn[128]
        for k, v in enumerate((np.nan, np.inf, -np.inf)):
            rows = rng.permutation(n)[:40]
            org[rows, k] = v
            tmv[rows[:20]] = 5.0
        tmv[rng.permutation(n)[:16]] = np.nan
        tmv[rng.permutation(n)[:16]] = -0.0
    elif kind == "all_dead":
        tmv[:] = -1.0
    elif kind == "all_live":
        tmv = np.abs(tmv)
    return tuple(torch.from_numpy(x) for x in (org, dirn, tmv))


def _kernel_keys(org, dirn, tmv, lo, hi):
    """raysort_keys_kernel's steps, ray by ray in f32 (numpy)."""
    f32 = np.float32
    o, d, t = (x.numpy() for x in (org, dirn, tmv))
    lo, hi = lo.numpy(), hi.numpy()
    e = hi - lo
    e = np.where(e < f32(1e-12), f32(1e-12), e)
    with np.errstate(invalid="ignore", divide="ignore"):
        q = (o - lo) / e
    nan = q != q
    q = np.where(nan, f32(0), np.where(q < 0, f32(0),
                                       np.where(q > 1, f32(1), q)))
    g = np.minimum((q * f32(64)).astype(np.int64), 63)
    g[nan] = 0

    def expand(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    octant = ((d[:, 0] >= 0).astype(np.int64)
              | (d[:, 1] >= 0).astype(np.int64) << 1
              | (d[:, 2] >= 0).astype(np.int64) << 2)
    key = (octant << 18 | expand(g[:, 0]) << 2 | expand(g[:, 1]) << 1
           | expand(g[:, 2]))
    return np.where(t < 0, rs.DEAD_KEY32, key)


@pytest.mark.parametrize("kind", ["random", "edge", "all_dead", "all_live"])
def test_keys32_keep_the_order_and_ties_of_the_int64_keys(kind):
    """Live keys equal, dead keys DEAD_KEY32 above every live one: the
    same order and the same ties as the int64 keys, within KEY_BITS."""
    org, dirn, tmv = _wave(kind)
    k64 = tw._octant_sort_keys(org, dirn, tmv, LO, HI)
    k32 = rs.octant_keys32_plain(org, dirn, tmv, LO, HI)
    assert k32.dtype == torch.int32
    dead = tmv < 0.0
    assert bool((k32[dead] == rs.DEAD_KEY32).all())
    assert torch.equal(k32[~dead].long(), k64[~dead])
    if bool((~dead).any()):
        assert int(k64[~dead].max()) < rs.DEAD_KEY32
    assert int(k32.max()) < 1 << rs.KEY_BITS
    a = k64[:, None]
    b = k32.long()[:, None]
    sub = slice(0, 512)  # every pair of a slice: < and == agree
    assert torch.equal(a[sub] < a[sub].T, b[sub] < b[sub].T)
    assert torch.equal(a[sub] == a[sub].T, b[sub] == b[sub].T)


@pytest.mark.parametrize("kind", ["random", "edge", "all_dead", "all_live"])
def test_stable_sorts_of_both_keys_give_one_permutation(kind):
    org, dirn, tmv = _wave(kind)
    k64 = tw._octant_sort_keys(org, dirn, tmv, LO, HI)
    k32 = rs.octant_keys32_plain(org, dirn, tmv, LO, HI)
    assert torch.equal(torch.sort(k32, stable=True).indices,
                       torch.sort(k64, stable=True).indices)
    assert torch.equal(rs.sort_perm(org, dirn, tmv, LO, HI),
                       torch.sort(k64, stable=True).indices)


@pytest.mark.parametrize("kind", ["random", "edge"])
def test_the_key_kernels_steps_give_the_keys(kind):
    """The kernel's per-ray f32 steps (an explicit NaN test before the
    clamp, a NaN cell 0) give ``octant_keys32_plain``'s keys, NaN and
    infinite origins and ±0.0 directions included."""
    org, dirn, tmv = _wave(kind)
    want = rs.octant_keys32_plain(org, dirn, tmv, LO, HI).numpy()
    np.testing.assert_array_equal(_kernel_keys(org, dirn, tmv, LO, HI),
                                  want)


@pytest.mark.parametrize("keep", [0, 1024, 2048, 3072, 4096])
def test_a_capped_wave_counts_the_live_rays_past_its_cut(keep):
    """Live rays sort first, so the live rays past the cut are
    max(0, live − keep) where no tmax is NaN; the sorted wave's first
    ``keep`` rays are the ones kept."""
    org, dirn, tmv = _wave("random")
    perm, o, d, t, over = rs.sort_rays(org, dirn, tmv, LO, HI, keep)
    n_live = int((tmv >= 0).sum())
    assert over.dtype == torch.float32 and over.shape == ()
    assert float(over) == max(0, n_live - keep)
    assert float(over) == float((tmv[perm][keep:] >= 0).sum())
    assert torch.equal(o, org[perm][:keep])
    assert torch.equal(d, dirn[perm][:keep])
    assert torch.equal(t, tmv[perm][:keep])


def test_nan_tmax_counts_as_the_tail_sum():
    """A NaN tmax sorts with the live rays but is no live ray past the
    cut: the count is the sorted tail's (tmv >= 0)."""
    org, dirn, tmv = _wave("edge")
    perm, *_, over = rs.sort_rays(org, dirn, tmv, LO, HI, 1024)
    assert float(over) == float((tmv[perm][1024:] >= 0).sum())


@pytest.mark.parametrize("fields,keep", [(4, (0, 1, 2, 3)), (5, range(5)),
                                         (4, (3,))],
                         ids=["closest", "two_level", "any_hit"])
@pytest.mark.parametrize("n_keep", [4096, 2048, 0])
def test_restore_puts_outputs_back_with_dead_values_past_the_cut(
        fields, keep, n_keep):
    org, dirn, tmv = _wave("edge")
    perm = rs.sort_perm(org, dirn, tmv, LO, HI)
    n = perm.shape[0]
    gen = torch.Generator().manual_seed(3)
    out = tuple(torch.rand(n_keep, generator=gen) for _ in range(fields))
    got = rs.restore(out, perm, n, keep)
    assert len(got) == fields
    for k in range(fields):
        if k not in keep:
            assert got[k] is out[k]
            continue
        want = torch.full((n,), rs.DEAD_VALUES[k])
        want[perm[:n_keep]] = out[k]
        assert torch.equal(got[k], want)
