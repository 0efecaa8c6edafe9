"""The tile intersector's ray coherence sort (``csrc/raysort.cu``): a
bounce or shadow wave in octant order (direction signs first, origin
Morton second, dead rays last), and the traversal's outputs back in the
caller's order.

On the card three kernels and CUB's radix sort do the ``sort`` step of
``make_tile_intersector``'s waves: ``raysort`` builds a 32-bit key a ray
in registers and sorts the keys' low KEY_BITS bits with int32 ray
indices (stable), ``raygather`` writes the sorted org, dirn and tmax of
the rays a wave keeps in one pass and counts the live rays past a live
cap, and ``rayrestore`` writes the outputs back (``r[perm[i]] =
out[i]``) with the dead-lane values past a truncated wave's cut. The key
is ``_octant_sort_keys``'s value on every live ray and DEAD_KEY32 (above
every live key) on dead ones: a strictly monotone map of its int64 keys
that keeps ties, so the stable sort gives the same permutation and every
later output is bit-equal.

The ``*_plain`` functions are the torch ops the step ran before the
kernels (int64 keys, ``torch.sort``, indexing, ``torch.cat`` and a
scatter an output); ``sort_rays``, ``restore`` and ``sort_perm`` take
them for CPU tensors. The "morton" order (``_ray_sort_keys``) keeps its
int64 keys and ``torch.sort`` on the card too, then the same gather and
restore.
"""

from __future__ import annotations

import functools

import torch

from tpurt_torch import kernels
from tpurt_torch.kernels.packet import _ray_sort_keys
from tpurt_torch.kernels.tilewave import _check, _octant_sort_keys

DEAD_KEY32 = 1 << 21  # a dead ray's key: above every 21-bit live key
KEY_BITS = 22  # the bits the card's sort orders
DEAD_VALUES = (-1.0, 0.0, 0.0, -1.0, -1.0)  # bt, bu, bv, bs, bi past a cut


def octant_keys32_plain(org, dirn, tmv, lo, hi):
    """The card's 32-bit keys: ``_octant_sort_keys``'s on live rays,
    DEAD_KEY32 where tmv < 0, as int32."""
    keys = _octant_sort_keys(org, dirn, tmv, lo, hi)
    return torch.where(tmv < 0.0, DEAD_KEY32, keys).to(torch.int32)


def sort_perm_plain(org, dirn, tmv, lo, hi, morton: bool = False):
    """The stable permutation (int64) into coherence order."""
    keyfn = _ray_sort_keys if morton else _octant_sort_keys
    return torch.sort(keyfn(org, dirn, tmv, lo, hi), stable=True).indices


def sort_rays_plain(org, dirn, tmv, lo, hi, keep: int, morton=False):
    """(perm, org, dirn, tmv of the first ``keep`` sorted rays, the live
    rays past them as an f32 count)."""
    perm = sort_perm_plain(org, dirn, tmv, lo, hi, morton)
    org, dirn, tmv = org[perm], dirn[perm], tmv[perm]
    live_over = (tmv[keep:] >= 0.0).sum(dtype=torch.float32)
    return perm, org[:keep], dirn[:keep], tmv[:keep], live_over


def restore_plain(out, perm, n: int, keep):
    """``out`` (outputs of the first sorted rays) with the fields of
    ``keep`` put back in the caller's order over ``n`` rays, the rays
    past a truncated wave's cut given DEAD_VALUES; the other fields as
    they were."""
    out = list(out)
    for k in keep:
        f = out[k]
        if f.shape[0] < n:
            f = torch.cat([f, torch.full((n - f.shape[0],), DEAD_VALUES[k],
                                         device=f.device)])
        r = torch.empty_like(f)
        r[perm] = f
        out[k] = r
    return tuple(out)


@functools.lru_cache(maxsize=64)
def _temp_bytes(n: int) -> int:
    """The scratch bytes CUB's sort of ``n`` keys takes (a host query)."""
    import ctypes

    from tpurt_torch.kernels import cuda_build

    got = ctypes.c_size_t(0)
    lib = cuda_build.load().lib
    err = lib.tpurt_raysort_temp_bytes(n, ctypes.byref(got))
    if err:
        raise RuntimeError(f"raysort scratch query failed: cudaError {err}")
    return got.value


def _wave_args(name, org, dirn, tmv):
    dev = org.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    n = org.shape[0]
    _check("org", org, torch.float32, (n, 3), dev)
    _check("dirn", dirn, torch.float32, (n, 3), dev)
    _check("tmv", tmv, torch.float32, (n,), dev)
    return dev, n


def sort_keys_cuda(org, dirn, tmv, lo, hi):
    """The key kernel's keys (int32, ``octant_keys32_plain``'s values)
    and the octant permutation (int32) that CUB's stable radix sort
    gives them, on the current stream."""
    dev, n = _wave_args("sort_keys_cuda", org, dirn, tmv)
    _check("lo", lo, torch.float32, (3,), dev)
    _check("hi", hi, torch.float32, (3,), dev)
    keys, keys_sorted, index, perm = (
        torch.empty(n, dtype=torch.int32, device=dev) for _ in range(4))
    temp = torch.empty(_temp_bytes(n) if n else 0, dtype=torch.uint8,
                       device=dev)
    kernels.launch("raysort", dev, org.data_ptr(), dirn.data_ptr(),
                   tmv.data_ptr(), lo.data_ptr(), hi.data_ptr(), n,
                   keys.data_ptr(), keys_sorted.data_ptr(), index.data_ptr(),
                   perm.data_ptr(), temp.data_ptr(), temp.shape[0],
                   work=n > 0)
    return keys, perm


def gather_cuda(perm, org, dirn, tmv, keep: int):
    """The first ``keep`` rays of ``perm``'s order in one pass, and the
    live rays (tmv >= 0) past them as an f32 count."""
    dev, n = _wave_args("gather_cuda", org, dirn, tmv)
    _check("perm", perm, torch.int32, (n,), dev)
    if not 0 <= keep <= n:
        raise ValueError(f"keep {keep} of {n} rays")
    f32 = torch.float32
    org_s = torch.empty((keep, 3), dtype=f32, device=dev)
    dirn_s = torch.empty((keep, 3), dtype=f32, device=dev)
    tmv_s = torch.empty((keep,), dtype=f32, device=dev)
    live_over = torch.zeros((), dtype=f32, device=dev)
    kernels.launch("raygather", dev, perm.data_ptr(), org.data_ptr(),
                   dirn.data_ptr(), tmv.data_ptr(), n, keep,
                   org_s.data_ptr(), dirn_s.data_ptr(), tmv_s.data_ptr(),
                   live_over.data_ptr() if keep < n else None,
                   work=n > 0)
    return org_s, dirn_s, tmv_s, live_over


def sort_rays_cuda(org, dirn, tmv, lo, hi, keep: int, morton=False):
    """``sort_rays_plain`` on the card: the permutation (int32) from the
    key kernel and CUB (the morton order: its torch keys and sort), then
    one gather."""
    org, dirn, tmv = (x.contiguous() for x in (org, dirn, tmv))
    if morton:
        perm = sort_perm_plain(org, dirn, tmv, lo, hi, True).to(torch.int32)
    else:
        perm = sort_keys_cuda(org, dirn, tmv, lo.contiguous(),
                              hi.contiguous())[1]
    return (perm, *gather_cuda(perm, org, dirn, tmv, keep))


def restore_cuda(out, perm, n: int, keep):
    """``restore_plain`` in one pass over the ``n`` rays."""
    dev = perm.device
    _check("perm", perm, torch.int32, (n,), dev)
    n_keep = out[0].shape[0]
    if len(out) > len(DEAD_VALUES) or n_keep > n:
        raise ValueError(f"{len(out)} outputs of {n_keep} rays, {n} slots")
    out = list(out)
    ins, outs = [None] * len(DEAD_VALUES), [None] * len(DEAD_VALUES)
    for k in keep:
        _check(f"out[{k}]", out[k], torch.float32, (n_keep,), dev)
        ins[k] = out[k]
        outs[k] = out[k] = torch.empty(n, dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    kernels.launch("rayrestore", dev, perm.data_ptr(), n, n_keep,
                   *map(ptr, ins), *map(ptr, outs), work=n > 0)
    return tuple(out)


def sort_perm(org, dirn, tmv, lo, hi):
    """The octant permutation: the card's (int32) for CUDA tensors, the
    plain version's (int64) for CPU tensors."""
    if org.device.type == "cuda":
        return sort_keys_cuda(org.contiguous(), dirn.contiguous(),
                              tmv.contiguous(), lo.contiguous(),
                              hi.contiguous())[1]
    return sort_perm_plain(org, dirn, tmv, lo, hi)


def sort_rays(org, dirn, tmv, lo, hi, keep: int, morton=False):
    """A wave in coherence order ("octant", or "morton" with ``morton``),
    cut to its first ``keep`` rays: (perm, org, dirn, tmv, live rays past
    the cut as an f32 count). The kernels for CUDA tensors, the plain
    version for CPU tensors."""
    fn = sort_rays_cuda if org.device.type == "cuda" else sort_rays_plain
    return fn(org, dirn, tmv, lo, hi, keep, morton)


def restore(out, perm, n: int, keep):
    """The fields ``keep`` of ``out`` back in the caller's order over
    ``n`` rays (``sort_rays``'s ``perm``); the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    fn = restore_cuda if perm.device.type == "cuda" else restore_plain
    return fn(out, perm, n, keep)
