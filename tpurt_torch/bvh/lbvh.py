"""LBVH builder — port of ``tpurt.bvh.lbvh``.

Builds a BVH over primitive boxes with vector ops on the boxes' device:

  1. 30-bit Morton codes of the box centroids; equal codes are told apart
     by primitive index, so the radix-tree keys are unique;
  2. a stable sort by code;
  3. the Karras (2012) radix tree: every internal node finds its range and
     split with masked doubling and binary searches of fixed length;
  4. bottom-up box refit and subtree sizes as a fixpoint (each pass
     propagates one tree level);
  5. leaf collapse to ``leaf_size`` (a Karras node covers a contiguous
     sorted range, so a collapsed leaf is a (first, count) slice);
  6. a depth-first (preorder) layout: the hit successor of node n is n+1
     and the miss successor ``skip[n]`` = its preorder rank plus its
     active subtree size (stackless skip links).

Node arrays have 2T slots (T primitives); slots [0, n_active) are live.
The integer tables equal the reference's bit for bit and the boxes
exactly (``tests/test_torch_lbvh.py``). The fixpoints are Python loops
with the reference's bound and equality test: one device sync a pass,
at build time only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_M32 = 0xFFFFFFFF
# passes of a fixpoint: the tree is at most 64 levels deep with unique
# 64-bit-equivalent keys
MAX_FIXPOINT_PASSES = 72


class Bvh(NamedTuple):
    """A flattened BVH in depth-first order. ``count``: 0 = internal node
    (hit successor n+1), >0 = leaf of ``count`` sorted primitives from
    ``first``. ``skip[n]``: the node after n's subtree; the root's ends
    at ``n_active``. ``perm[s]``: the primitive of sorted slot s."""

    bmin: torch.Tensor  # (2T, 3) f32
    bmax: torch.Tensor  # (2T, 3) f32
    first: torch.Tensor  # (2T,) i32
    count: torch.Tensor  # (2T,) i32
    skip: torch.Tensor  # (2T,) i32
    n_active: torch.Tensor  # () i32
    perm: torch.Tensor  # (T,) i32

    @property
    def capacity(self) -> int:
        return self.bmin.shape[0]

    @property
    def num_prims(self) -> int:
        return self.perm.shape[0]


def _expand_bits10(v: torch.Tensor) -> torch.Tensor:
    """The low 10 bits of v spread two zero bits apart (int64 lanes)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(centroids: torch.Tensor, scene_min: torch.Tensor,
                 scene_max: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64 lanes) of points normalized to the
    scene box."""
    extent = torch.clamp_min(scene_max - scene_min, 1e-12)
    q = torch.clamp((centroids - scene_min) / extent, 0.0, 1.0)
    grid = torch.clamp_max((q * 1024.0).to(torch.int64), 1023)
    x = _expand_bits10(grid[:, 0])
    y = _expand_bits10(grid[:, 1])
    z = _expand_bits10(grid[:, 2])
    return (x << 2) | (y << 1) | z


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of uint32 values held in int64 (32 for 0)."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        small = x < (1 << (32 - s))
        n = n + small.to(torch.int64) * s
        x = torch.where(small, (x << s) & _M32, x)
    return n + (x == 0).to(torch.int64)


def _make_delta(codes: torch.Tensor):
    """Karras delta(i, j): the common-prefix length of keys i and j, -1
    when j is out of range. Equal codes fall back to the index bits
    (+32), so the keys are unique."""
    t = codes.shape[0]

    def delta(i, j):
        valid = (j >= 0) & (j < t)
        jc = torch.clamp(j, 0, t - 1)
        x = codes[i] ^ codes[jc]
        d = torch.where(x == 0, 32 + _clz32(i ^ jc), _clz32(x))
        return torch.where(valid, d, -1)

    return delta


def _karras_topology(codes_sorted: torch.Tensor):
    """The radix tree of T sorted keys: for every internal node i in
    [0, T-2] its range and split, by masked doubling and binary searches
    of fixed length. Returns (left, right, parent): a child id below T-1
    is an internal node, T-1 + k is leaf k (sorted slot k)."""
    t = codes_sorted.shape[0]
    n_internal = t - 1
    dev = codes_sorted.device
    delta = _make_delta(codes_sorted)
    i = torch.arange(n_internal, dtype=torch.int64, device=dev)

    d = torch.where(delta(i, i + 1) > delta(i, i - 1), 1, -1)
    delta_min = delta(i, i - d)

    # exponential search for an upper bound of the range length
    l_max = torch.full_like(i, 2)
    done = torch.zeros_like(i, dtype=torch.bool)
    for _ in range(32):
        cond = ~done & (delta(i, i + l_max * d) > delta_min)
        l_max = torch.where(cond, l_max * 2, l_max)
        done = done | ~cond

    # binary search for the range length l
    length = torch.zeros_like(i)
    step = l_max // 2
    for _ in range(32):
        take = (step > 0) & (delta(i, i + (length + step) * d) > delta_min)
        length = torch.where(take, length + step, length)
        step = step // 2
    j = i + length * d
    delta_node = delta(i, j)

    # binary search for the split s: widths ceil(l/2), ceil(l/4), …, 1,
    # each used once (done stops width 1 from being applied again)
    s = torch.zeros_like(i)
    step = (length + 1) // 2
    done = length <= 1
    for _ in range(33):
        take = (~done & (delta(i, i + (s + step) * d) > delta_node)
                & (s + step < length))
        s = torch.where(take, s + step, s)
        done = done | (step <= 1)
        step = torch.clamp_min((step + 1) // 2, 1)
    gamma = i + s * d + torch.clamp_max(d, 0)

    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    left = torch.where(lo == gamma, n_internal + gamma, gamma)
    right = torch.where(hi == gamma + 1, n_internal + gamma + 1, gamma + 1)
    parent = torch.full((2 * t - 1,), -1, dtype=torch.int64, device=dev)
    parent[left] = i
    parent[right] = i
    return left, right, parent


def _fixpoint(step_fn, state, max_iters: int = MAX_FIXPOINT_PASSES):
    """Apply ``step_fn`` until the state (a tensor or a tuple of tensors)
    stops changing, at most ``max_iters`` times."""
    for _ in range(max_iters):
        new = step_fn(state)
        pairs = (zip(state, new) if isinstance(state, tuple)
                 else [(state, new)])
        same = all(torch.equal(a, b) for a, b in pairs)
        state = new
        if same:
            break
    return state


def _scatter_layout(out_idx, active, vals, cap: int):
    """``vals`` scattered to ``out_idx`` in a (cap, …) zero array. The
    inactive nodes all point at the dump slot cap-1, which keeps the last
    of them, as the reference's serial scatter does."""
    out = torch.zeros((cap + 1,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    out[torch.where(active, out_idx, cap)] = vals  # row cap: thrown away
    out = out[:cap]
    order = torch.arange(active.shape[0], device=vals.device)
    last = torch.where(active, -1, order).amax()
    out[cap - 1] = torch.where(last >= 0, vals[torch.clamp_min(last, 0)],
                               out[cap - 1])
    return out


def build_lbvh(prim_bmin: torch.Tensor, prim_bmax: torch.Tensor,
               leaf_size: int = 4) -> Bvh:
    """An LBVH over primitives given their boxes, on the boxes' device.
    ``leaf_size`` > 1 collapses small subtrees into contiguous-range
    leaves."""
    t = prim_bmin.shape[0]
    dev = prim_bmin.device
    prim_bmin = prim_bmin.to(torch.float32)
    prim_bmax = prim_bmax.to(torch.float32)
    i32 = dict(dtype=torch.int32, device=dev)

    if t == 1:
        return Bvh(
            bmin=torch.cat([prim_bmin, prim_bmin]),
            bmax=torch.cat([prim_bmax, prim_bmax]),
            first=torch.zeros(2, **i32),
            count=torch.tensor([1, 0], **i32),
            skip=torch.tensor([1, 1], **i32),
            n_active=torch.tensor(1, **i32),
            perm=torch.zeros(1, **i32),
        )

    centroids = 0.5 * (prim_bmin + prim_bmax)
    codes = morton_codes(centroids, prim_bmin.amin(dim=0),
                         prim_bmax.amax(dim=0))
    perm = torch.sort(codes, stable=True).indices
    left, right, parent = _karras_topology(codes[perm])

    n_internal = t - 1
    n_nodes = 2 * t - 1
    node = torch.arange(n_nodes, dtype=torch.int64, device=dev)
    is_internal = node < n_internal
    slot_of = node - n_internal  # leaf slots

    # --- bottom-up: boxes (refit), subtree sizes, range starts
    def up_step(st):
        bmin, bmax, size, start = st
        upd = lambda full, internal: torch.cat([internal, full[n_internal:]])
        return (upd(bmin, torch.minimum(bmin[left], bmin[right])),
                upd(bmax, torch.maximum(bmax[left], bmax[right])),
                upd(size, size[left] + size[right]),
                upd(start, torch.minimum(start[left], start[right])))

    big = 3.4e38
    bmin0 = torch.cat([torch.full((n_internal, 3), big, device=dev),
                       prim_bmin[perm]])
    bmax0 = torch.cat([torch.full((n_internal, 3), -big, device=dev),
                       prim_bmax[perm]])
    size0 = torch.cat([torch.zeros(n_internal, dtype=torch.int64,
                                   device=dev),
                       torch.ones(t, dtype=torch.int64, device=dev)])
    start0 = torch.cat([torch.full((n_internal,), t, dtype=torch.int64,
                                   device=dev),
                        torch.arange(t, dtype=torch.int64, device=dev)])
    bmin, bmax, size, start = _fixpoint(up_step,
                                        (bmin0, bmax0, size0, start0))

    # --- leaf collapse: internal nodes of at most leaf_size prims whose
    # parent is bigger become leaves over [start, start + size)
    pclamp = torch.clamp_min(parent, 0)
    parent_size = torch.where(parent >= 0, size[pclamp], t + 1)
    collapsed = is_internal & (size <= leaf_size) & (parent_size > leaf_size)

    # --- top-down: under a collapsed ancestor
    def under_step(under):
        return torch.where(parent >= 0, under[pclamp] | collapsed[pclamp],
                           False)

    under = _fixpoint(under_step,
                      torch.zeros(n_nodes, dtype=torch.bool, device=dev))
    active_leaf = ~under & (collapsed | (~is_internal & ~collapsed))
    active_internal = ~under & is_internal & ~collapsed
    active = active_leaf | active_internal

    # --- bottom-up: active subtree node counts
    one = torch.ones((), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def asize_step(a):
        internal = torch.where(
            active_internal[:n_internal], 1 + a[left] + a[right],
            torch.where(active_leaf[:n_internal], one, zero))
        return torch.cat([internal,
                          torch.where(active_leaf[n_internal:], one, zero)])

    asize = _fixpoint(asize_step, torch.zeros(n_nodes, dtype=torch.int64,
                                              device=dev))
    n_active = asize[0]

    # --- top-down: preorder rank (children of active internal nodes)
    i_am_left = left[pclamp] == node
    has_p = parent >= 0

    def rank_step(rank):
        from_parent = torch.where(i_am_left, rank[pclamp] + 1,
                                  rank[pclamp] + 1 + asize[left[pclamp]])
        new = torch.where(has_p & active & active_internal[pclamp],
                          from_parent, rank)
        new[0] = 0
        return new

    rank = _fixpoint(rank_step, torch.zeros(n_nodes, dtype=torch.int64,
                                            device=dev))

    # --- the depth-first output arrays (2T slots; slot 2T-1 is the dump
    # of inactive nodes, never read: rank < n_active <= 2T-1)
    cap = 2 * t
    leaf_first = torch.where(is_internal, start, slot_of)
    leaf_count = torch.where(is_internal, size, 1)
    first_vals = torch.where(active_leaf, leaf_first, 0)
    count_vals = torch.where(active_leaf, leaf_count, 0)
    lay = lambda v: _scatter_layout(rank, active, v, cap)
    return Bvh(
        bmin=lay(bmin),
        bmax=lay(bmax),
        first=lay(first_vals).to(torch.int32),
        count=lay(count_vals).to(torch.int32),
        skip=lay(rank + asize).to(torch.int32),
        n_active=n_active.to(torch.int32),
        perm=perm.to(torch.int32),
    )


def tri_aabbs(v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor):
    """Per-triangle boxes (bmin, bmax)."""
    return (torch.minimum(torch.minimum(v0, v1), v2),
            torch.maximum(torch.maximum(v0, v1), v2))
