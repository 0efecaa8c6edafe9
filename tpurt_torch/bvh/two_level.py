"""Two-level LBVH accel and its stackless walk — port of
``tpurt.bvh.two_level``.

One LBVH per mesh (the BLASes) and one over the instances' world boxes
(the TLAS), built by ``bvh.lbvh`` on the scene's device, packed into ONE
node address space [TLAS | BLAS_0 | BLAS_1 | …]. The walk advances every
ray one node a step with masked updates, stackless through the preorder
skip links. Two-level nesting needs a stack of depth one, so a ray
carries two registers (``ret`` and its instance): entering an instance
leaf moves the ray into object space and jumps to its BLAS; a BLAS skip
that runs off the end returns to ``ret`` and restores the world ray.

Node encoding: count == 0 internal (hit successor node+1, miss → skip);
count > 0 a leaf of ``count`` sorted triangles from ``first`` (a global
slot); count < 0 a TLAS instance leaf, ``first`` its instance. Skip
sentinels: DONE (-2) ends the walk, EXIT (-1) leaves the current BLAS.

This walk is plain tensor code, as the reference's is jnp code (no
Pallas kernel): on the card it is a few dozen elementwise kernels a
step. A finished ray's state no longer changes, so the walk tests for
running rays only every ``CHECK_EVERY`` steps, and drops the finished
rays from its working set when they are at least half of it; neither
changes an output.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch.bvh.lbvh import build_lbvh, tri_aabbs
from tpurt_torch.core.vecmath import intersect_tris, ray_aabb, safe_inv_dir
from tpurt_torch.render.intersectors import Hit, SceneMeta

DONE = -2
EXIT = -1
# steps between two tests for running rays (one host sync each)
CHECK_EVERY = 8


class SceneAccel(NamedTuple):
    """The unified two-level accel (tensors on one device)."""

    node_bmin: torch.Tensor  # (Ntot, 3) f32
    node_bmax: torch.Tensor  # (Ntot, 3) f32
    node_first: torch.Tensor  # (Ntot,) i32
    node_count: torch.Tensor  # (Ntot,) i32
    node_skip: torch.Tensor  # (Ntot,) i32 — global, with DONE/EXIT
    inst_entry: torch.Tensor  # (I,) i32 — BLAS entry node per instance
    prim_v0: torch.Tensor  # (Ttot, 3) f32 — Morton-sorted object-space tris
    prim_v1: torch.Tensor
    prim_v2: torch.Tensor
    prim_id: torch.Tensor  # (Ttot,) i32 — global triangle id

    @property
    def num_nodes(self) -> int:
        return self.node_bmin.shape[0]

    def to(self, device) -> "SceneAccel":
        return SceneAccel(*(t.to(device) for t in self))


def scene_accel_from_arrays(arrays, device) -> SceneAccel:
    """A SceneAccel on ``device`` from its arrays in field order (numpy,
    or anything ``np.array`` takes) — e.g. the reference's accel, to hold
    the walk apart from the build."""
    return SceneAccel(*(torch.from_numpy(np.array(a)).to(device)
                        for a in arrays))


def _affine(m, x, translate: bool = True):
    """``m[..., :3] x (+ m[..., 3])`` for (..., 3, 4) affines ``m``, as
    the reference's einsum computes it on XLA:CPU: the chain
    fma(m2, x2, fma(m1, x1, m0 x0)), then the translation. The products
    are exact in f64, so the chain rounds as the fused one does."""
    m = m.double()
    x = x.double()[..., None, :]
    f32 = lambda v: v.to(torch.float32).double()
    acc = f32(m[..., 0] * x[..., 0])
    acc = f32(m[..., 1] * x[..., 1] + acc)
    acc = f32(m[..., 2] * x[..., 2] + acc)
    if translate:
        acc = acc + m[..., 3]
    return acc.to(torch.float32)


def instance_world_aabbs(ds, root_bmin: torch.Tensor,
                         root_bmax: torch.Tensor):
    """World box per instance: the 8 corners of its BLAS root box
    (root_bmin/bmax are (M, 3), per mesh) through its transform."""
    mesh = ds.inst_mesh.long()
    bmin = root_bmin[mesh]
    bmax = root_bmax[mesh]
    corners = torch.stack(
        [torch.where(torch.tensor([(k >> 0) & 1, (k >> 1) & 1, (k >> 2) & 1],
                                  dtype=torch.bool, device=bmin.device),
                     bmax, bmin)
         for k in range(8)], dim=1)  # (I, 8, 3)
    world = _affine(ds.inst_transform[:, None], corners)
    return world.amin(dim=1), world.amax(dim=1)


def build_scene_accel(ds, meta: SceneMeta, leaf_size: int = 4) -> SceneAccel:
    """All BLASes and the TLAS, packed into the unified node arrays, on
    the DeviceScene's device."""
    i32 = torch.int32
    n_inst = len(meta.inst_mesh)
    blas = [
        build_lbvh(*tri_aabbs(ds.tri_v0[start:start + count],
                              ds.tri_v1[start:start + count],
                              ds.tri_v2[start:start + count]),
                   leaf_size=leaf_size)
        for start, count in meta.mesh_tri_ranges
    ]
    root_bmin = torch.stack([b.bmin[0] for b in blas])
    root_bmax = torch.stack([b.bmax[0] for b in blas])
    tlas = build_lbvh(*instance_world_aabbs(ds, root_bmin, root_bmax),
                      leaf_size=1)

    # the static layout of the unified node address space
    blas_off = []
    off = tlas.capacity
    for b in blas:
        blas_off.append(off)
        off += b.capacity

    # TLAS leaves become instance leaves (count -1, first = instance id)
    leaf = tlas.count > 0
    t_first = tlas.perm[torch.clamp(tlas.first, 0, n_inst - 1).long()]
    parts = dict(
        bmin=[tlas.bmin], bmax=[tlas.bmax],
        first=[torch.where(leaf, t_first, 0).to(i32)],
        count=[torch.where(leaf, -1, 0).to(i32)],
        skip=[torch.where(tlas.skip >= tlas.n_active, DONE,
                          tlas.skip).to(i32)],
        v0=[], v1=[], v2=[], pid=[])
    tri_slot_off = 0
    for b, (start, count), off_m in zip(blas, meta.mesh_tri_ranges,
                                        blas_off):
        perm = b.perm.long()
        parts["bmin"].append(b.bmin)
        parts["bmax"].append(b.bmax)
        # a leaf's first: mesh-local sorted slot → global sorted slot
        parts["first"].append(torch.where(b.count > 0,
                                          b.first + tri_slot_off, 0).to(i32))
        parts["count"].append(b.count)
        parts["skip"].append(torch.where(b.skip >= b.n_active, EXIT,
                                         b.skip + off_m).to(i32))
        # Morton-sorted copies of the mesh's triangles (object space)
        for key, v in (("v0", ds.tri_v0), ("v1", ds.tri_v1),
                       ("v2", ds.tri_v2)):
            parts[key].append(v[start:start + count][perm])
        parts["pid"].append((b.perm + start).to(i32))
        tri_slot_off += count

    entry = torch.tensor(blas_off, dtype=i32, device=ds.tri_v0.device)
    cat = lambda k: torch.cat(parts[k])
    return SceneAccel(
        node_bmin=cat("bmin"), node_bmax=cat("bmax"),
        node_first=cat("first"), node_count=cat("count"),
        node_skip=cat("skip"), inst_entry=entry[ds.inst_mesh.long()],
        prim_v0=cat("v0"), prim_v1=cat("v1"), prim_v2=cat("v2"),
        prim_id=cat("pid"),
    )


class _Walk(NamedTuple):
    """Per-ray state of the walk (one row a ray of the working set)."""

    node: torch.Tensor  # current unified node or DONE (int64)
    ret: torch.Tensor  # TLAS node to resume after a BLAS exit
    inst: torch.Tensor  # the instance whose BLAS the ray is in
    org_c: torch.Tensor  # (n, 3) current-space ray
    dir_c: torch.Tensor
    best_t: torch.Tensor
    best_u: torch.Tensor
    best_v: torch.Tensor
    best_slot: torch.Tensor
    best_inst: torch.Tensor
    found: torch.Tensor
    # constants of the ray (carried so the working set compacts whole)
    org: torch.Tensor
    dirn: torch.Tensor
    t_min: torch.Tensor


def _tables(ds, accel: SceneAccel):
    """The accel's integer tables as int64 (index tensors), once a walk."""
    return dict(first=accel.node_first.long(), count=accel.node_count.long(),
                skip=accel.node_skip.long(), entry=accel.inst_entry.long(),
                inv=ds.inst_inv)


def _step(s: _Walk, accel: SceneAccel, tab, leaf_size: int,
          any_hit: bool) -> _Walk:
    """One node for every ray (masked; a finished ray is left as it is)."""
    n_nodes = accel.num_nodes
    n_prims = accel.prim_v0.shape[0]
    n_inst = tab["entry"].shape[0]
    active = s.node >= 0
    if any_hit:
        active = active & ~s.found
    nid = torch.clamp(s.node, 0, n_nodes - 1)
    skipv = tab["skip"][nid]
    cnt = tab["count"][nid]
    fst = tab["first"][nid]
    hit_box = ray_aabb(s.org_c, safe_inv_dir(s.dir_c), accel.node_bmin[nid],
                       accel.node_bmax[nid], s.t_min, s.best_t) & active

    # leaf triangle tests (masked)
    best_t, best_u, best_v = s.best_t, s.best_u, s.best_v
    best_slot, best_inst, found = s.best_slot, s.best_inst, s.found
    do_tris = hit_box & (cnt > 0)
    for k in range(leaf_size):
        slot = torch.clamp(fst + k, 0, n_prims - 1)
        t, u, v, h = intersect_tris(s.org_c, s.dir_c, accel.prim_v0[slot],
                                    accel.prim_v1[slot], accel.prim_v2[slot],
                                    s.t_min, best_t)
        upd = do_tris & (k < cnt) & h
        best_t = torch.where(upd, t, best_t)
        best_u = torch.where(upd, u, best_u)
        best_v = torch.where(upd, v, best_v)
        best_slot = torch.where(upd, slot, best_slot)
        best_inst = torch.where(upd, s.inst, best_inst)
        found = found | upd

    # the next node
    enter = hit_box & (cnt < 0)
    nxt = torch.where(hit_box & (cnt == 0), s.node + 1, skipv)
    new_inst = torch.where(enter, fst, s.inst)
    inst_c = torch.clamp(new_inst, 0, n_inst - 1)
    nxt = torch.where(enter, tab["entry"][inst_c], nxt)
    new_ret = torch.where(enter, skipv, s.ret)
    exited = active & (nxt == EXIT)
    node_next = torch.where(exited, s.ret, nxt)
    node_next = torch.where(active, node_next, s.node)
    new_ret = torch.where(exited, DONE, new_ret)

    # the ray's space (enter: world → object; exit: back to world)
    inv = tab["inv"][inst_c]  # (n, 3, 4)
    obj_org = _affine(inv, s.org)
    obj_dir = _affine(inv, s.dirn, translate=False)
    e3, x3 = enter[:, None], exited[:, None]
    org_c = torch.where(e3, obj_org, torch.where(x3, s.org, s.org_c))
    dir_c = torch.where(e3, obj_dir, torch.where(x3, s.dirn, s.dir_c))
    return s._replace(node=node_next, ret=new_ret, inst=new_inst,
                      org_c=org_c, dir_c=dir_c, best_t=best_t, best_u=best_u,
                      best_v=best_v, best_slot=best_slot,
                      best_inst=best_inst, found=found)


def _traverse(ds, accel: SceneAccel, org, dirn, t_min, t_max,
              leaf_size: int, any_hit: bool) -> _Walk:
    """The walk of every ray to its end (DONE, or with ``any_hit`` its
    first hit), at most ``num_nodes + num_instances + 64`` steps as in the
    reference. Returns the final per-ray state in the rays' order."""
    n = org.shape[0]
    dev = org.device
    per_ray = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                        device=dev).expand(n).contiguous()
    t_min, t_max = per_ray(t_min), per_ray(t_max)
    max_steps = accel.num_nodes + ds.num_instances + 64
    i64 = dict(dtype=torch.int64, device=dev)
    s = _Walk(
        node=torch.zeros(n, **i64), ret=torch.full((n,), DONE, **i64),
        inst=torch.zeros(n, **i64), org_c=org, dir_c=dirn,
        best_t=torch.where(torch.isfinite(t_max), t_max, 3.4e38),
        best_u=torch.zeros(n, device=dev), best_v=torch.zeros(n, device=dev),
        best_slot=torch.zeros(n, **i64), best_inst=torch.zeros(n, **i64),
        found=torch.zeros(n, dtype=torch.bool, device=dev),
        org=org, dirn=dirn, t_min=t_min)
    tab = _tables(ds, accel)
    out = s  # the final state of every ray, filled at each compaction
    rows = None  # the working set's rows of ``out`` (None: all rays)
    for step in range(max_steps):
        if step % CHECK_EVERY == 0:
            running = s.node != DONE
            if any_hit:
                running = running & ~s.found
            n_run = int(running.sum())
            if n_run == 0:
                break
            if n_run <= running.shape[0] // 2:
                out = _write_back(out, s, rows)
                keep = torch.nonzero(running).squeeze(1)
                rows = keep if rows is None else rows[keep]
                s = _Walk(*(f[keep] for f in s))
        s = _step(s, accel, tab, leaf_size, any_hit)
    return _write_back(out, s, rows)


def _write_back(out: _Walk, s: _Walk, rows) -> _Walk:
    if rows is None:
        return s
    fields = []
    for full, part in zip(out, s):
        full = full.clone()
        full[rows] = part
        fields.append(full)
    return _Walk(*fields)


def make_two_level_intersector(ds, accel: SceneAccel, leaf_size: int = 4):
    """Closest/any-hit pair over the two-level accel (the brute force's
    interface). ``Hit.slot`` is -1: this accel has no shade records.
    ``host_read(n)`` on both names the walk's host read (it counts its
    running rays to compact them)."""

    def closest(org, dirn, t_min, t_max) -> Hit:
        s = _traverse(ds, accel, org, dirn, t_min, t_max, leaf_size, False)
        slot = torch.clamp(s.best_slot, 0, accel.prim_id.shape[0] - 1)
        tri = accel.prim_id[slot]
        return Hit(
            t=torch.where(s.found, s.best_t, torch.inf), u=s.best_u,
            v=s.best_v, tri=tri, inst=s.best_inst.to(torch.int32),
            valid=s.found, slot=torch.full_like(tri, -1),
        )

    def any_hit(org, dirn, t_min, t_max) -> torch.Tensor:
        return _traverse(ds, accel, org, dirn, t_min, t_max, leaf_size,
                         True).found

    closest.host_read = any_hit.host_read = lambda n: (
        "the LBVH walk reads its running-ray count to compact them")
    return closest, any_hit
