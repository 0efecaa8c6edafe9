"""tilewave.tileloop_work_plain: the box and row tests a front-to-back walk
over a tile's entries cannot avoid (the work chip_smoke.py's K1 and K4
bounds count).

On a hand-built two-cluster scene the counts are known exactly. On the
bunny stand-in and the sponza stand-ins (two-level, superclusters) they
are held to a per-ray walk written out here in float32 numpy — the
kernel's slab arithmetic, entry by entry — and to the properties the
count must have: a dead ray counts nothing, a hit ray counts the row of
its hit, no ray counts more rows than its counted units hold. Counts are
integers and compared exactly.
"""

import numpy as np
import pytest
import torch

from tpurt_torch.bvh.paircluster import build_pair_accel, \
    build_pair_accel_two_level
from tpurt_torch.kernels import tilewave as tw
from tpurt_torch.render.intersectors import scene_meta
from tpurt_torch.scene.procedural import bunny_standin, cornell_box, \
    sponza_standin

FAR_AWAY = 1e4  # the box of an empty row: a point no ray passes


def _two_cluster_rows():
    """Two clusters of 8 rows: cluster 0 holds one triangle at z = 5
    covering x + y <= 0 of the square [-1, 1]^2 (slot 0), cluster 1 two
    triangles covering the whole square at z = 10 (slots 1, 2); cluster
    boxes [-2, 2]^2 x [4, 6] and [-2, 2]^2 x [9, 11]; empty rows boxed far
    away."""
    rows = np.zeros((16, 128), np.float32)
    rows[:, 9:120:10] = -1.0  # empty triangle slots
    rows[:, 120:126] = FAR_AWAY

    def tri(row, lane, v0, v1, v2, slot):
        v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
        rows[row, 10 * lane:10 * lane + 10] = [*v0, *(v1 - v0), *(v2 - v0),
                                               slot]

    tri(0, 0, (-1, -1, 5), (1, -1, 5), (-1, 1, 5), 0)
    rows[0, 120:126] = [-1, -1, 5, 1, 1, 5]
    tri(8, 0, (-1, -1, 10), (1, -1, 10), (-1, 1, 10), 1)
    tri(8, 1, (1, 1, 10), (-1, 1, 10), (1, -1, 10), 2)
    rows[8, 120:126] = [-1, -1, 10, 1, 1, 10]
    for c, (z0, z1) in enumerate(((4, 6), (9, 11))):
        box = np.array([-2, -2, z0, 2, 2, z1], np.float32)
        rows[8 * c:8 * c + 3, 126:128] = box.reshape(3, 2)
    lo = np.array([[-2, -2, 4], [-2, -2, 9]], np.float32)
    hi = np.array([[2, 2, 6], [2, 2, 11]], np.float32)
    return torch.from_numpy(rows), torch.from_numpy(lo), torch.from_numpy(hi)


# ray kinds of the constructed tile: (x, y, tmax), and the expected
# (box tests, row tests) of the closest walk and of the any-hit walk
KINDS = [
    ((-0.5, -0.5, 20.0), (1, 1), (1, 1)),  # hits cluster 0 at t = 5
    ((0.5, 0.5, 20.0), (2, 2), (2, 2)),    # passes row 0 of cluster 0,
    #                                        hits cluster 1 at t = 10
    ((1.5, 1.5, 20.0), (2, 0), (2, 0)),    # inside both boxes, no row
    ((0.5, 0.5, 8.0), (1, 1), (1, 1)),     # stops before cluster 1
    ((-0.5, -0.5, 3.0), (0, 0), (0, 0)),   # stops before either
    ((0.0, 0.0, -1.0), (0, 0), (0, 0)),    # dead
]


def _constructed_wave():
    n = tw.TILE
    kind = np.arange(n) % len(KINDS)
    xyt = np.array([k[0] for k in KINDS], np.float32)[kind]
    org = np.stack([xyt[:, 0], xyt[:, 1], np.zeros(n, np.float32)], 1)
    dirn = np.tile(np.array([0, 0, 1], np.float32), (n, 1))
    t = torch.from_numpy
    org, dirn, tmax = t(org), t(dirn), t(np.ascontiguousarray(xyt[:, 2]))
    return org, dirn, tw._safe_inv(dirn), tmax, kind


def _entries(org, inv_d, tmax, lo, hi):
    scale = tw.tn_scale_of(lo.numpy(), hi.numpy())
    entry = tw.entries_plain(org, inv_d, tmax, lo, hi, scale)
    counts = (entry != tw.INT32_MAX).sum(dim=1, dtype=torch.int32)
    return torch.sort(entry, dim=1).values, counts, scale


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_constructed_wave_counts_exactly(any_hit):
    rows, lo, hi = _two_cluster_rows()
    org, dirn, inv_d, tmax, kind = _constructed_wave()
    entry, counts, scale = _entries(org, inv_d, tmax, lo, hi)
    assert counts.tolist() == [2]
    res = tw.tileloop_plain(org, dirn, inv_d, tmax, rows, entry, counts,
                            scale, any_hit)
    boxes, n_rows = tw.tileloop_work_plain(
        org, dirn, inv_d, tmax, rows, entry, counts, scale, any_hit,
        bt=res[0], bs=res[3])
    want = np.array([k[2 if any_hit else 1] for k in KINDS])[kind]
    assert boxes.tolist() == want[:, 0].tolist()
    assert n_rows.tolist() == want[:, 1].tolist()
    if not any_hit:
        # the walk's hits: t = 5 in cluster 0, t = 10 in cluster 1
        assert res[0][kind == 0].eq(5.0).all()
        assert res[0][kind == 1].eq(10.0).all()


def _walk_counts(r, org, inv_d, tmax, rows, entry, counts, scale, any_hit,
                 res, dirn, pair_meta=None, inv_xform=None, sc_meta=None):
    """The walk of ray r written out: its tile's entries in order, each
    unit whose distance is at most F a box test, each row of an entered
    cluster whose sub-box is entered a row test (closest: and the hit's
    row; any-hit: up to the first occluding row)."""
    f32 = np.float32
    blocks = rows.numpy().reshape(-1, 8, 128)
    tile = r // tw.TILE
    if float(tmax[r]) < 0:
        return 0, 0
    far = f32(tmax[r]) if any_hit else f32(res[0][r])
    slot = float(res[3][r])
    inst = float(res[4][r]) if pair_meta is not None and not any_hit else -1

    def box(o, iv, lo, hi):
        with np.errstate(over="ignore"):  # clamped 1/d times a far face
            t0, t1 = (lo - o) * iv, (hi - o) * iv
        mn, mx = np.minimum(t0, t1), np.maximum(t0, t1)
        tn = max(max(mn[0], mn[1]), max(mn[2], f32(0)))
        tf = min(min(mx[0], mx[1]), min(mx[2], far))
        return tn <= tf

    n_box = n_row = 0
    for p in range(int(counts[tile])):
        word = int(entry[tile, p])
        if f32(word >> 16) * f32(scale) > far:
            continue
        cid = word & 0xFFFF
        first, kids = cid, 1
        if sc_meta is not None:
            v = int(sc_meta[cid])
            first, kids = v & 0xFFFF, v >> 16
        o, d, iv = org[r], dirn[r], inv_d[r]
        mine_inst = -1
        if pair_meta is not None:
            o, d = tw._to_object(o[None], d[None], inv_xform[first][None])
            o, d = o[0], d[0]
            iv = tw._safe_inv(d)
            mine_inst = float(int(pair_meta[first]) >> 20)
        o, d, iv = (x.numpy() for x in (o, d, iv))
        for k in range(kids):
            c = first + k
            n_box += 1
            row0 = (int(pair_meta[c]) & 0xFFFFF if pair_meta is not None
                    else 8 * c)
            blk = blocks[row0 // 8]
            own = (not any_hit and slot >= 0 and mine_inst == inst
                   and bool(np.any(blk[:, 9:120:10] == slot)))
            lo = np.array([blk[0, 126], blk[0, 127], blk[1, 126]], f32)
            hi = np.array([blk[1, 127], blk[2, 126], blk[2, 127]], f32)
            if not (box(o, iv, lo, hi) or own):
                continue
            for rr in range(8):
                rb = blk[rr, 120:126]
                hit_row = own and bool(np.any(blk[rr, 9:120:10] == slot))
                if not (box(o, iv, rb[:3], rb[3:]) or hit_row):
                    continue
                n_row += 1
                if any_hit and bool(tw._row_tests(
                        torch.from_numpy(blk[rr][None].copy()),
                        torch.from_numpy(o[None]), torch.from_numpy(d[None]),
                        tmax[r][None], True).any()):
                    return n_box, n_row
    return n_box, n_row


def _random_wave(accel, n_tiles, seed, lo, hi):
    lo_all = accel.cluster_lo.amin(0).numpy()
    hi_all = accel.cluster_hi.amax(0).numpy()
    rng = np.random.default_rng(seed)
    n = n_tiles * tw.TILE
    org = lo_all + rng.uniform(-0.2, 1.2, size=(n, 3)) * (hi_all - lo_all)
    d = lo_all + rng.uniform(size=(n, 3)) * (hi_all - lo_all) - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    diag = float(np.linalg.norm(hi_all - lo_all))
    tmax = np.where(np.arange(n) % 9 == 0, -1.0,
                    rng.uniform(0.2, 1.5, n) * diag)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    org, dirn, tmax = t(org), t(d), t(tmax)
    inv_d = tw._safe_inv(dirn)
    return (org, dirn, inv_d, tmax), _entries(org, inv_d, tmax, lo, hi)


def _case(mode):
    if mode == "flat":
        scene = bunny_standin(subdivisions=3)
        accel = build_pair_accel(None, scene_meta(scene),
                                 scene=scene).to("cpu")
        return accel, accel.cluster_lo, accel.cluster_hi, {}
    scene = sponza_standin() if mode == "tl_sc" else sponza_standin(8, 3)
    accel = build_pair_accel_two_level(None, scene_meta(scene),
                                       scene=scene).to("cpu")
    tl = dict(pair_meta=accel.pair_meta, inv_xform=accel.inv_xform)
    if mode == "tl_sc":
        return accel, accel.sc_lo, accel.sc_hi, dict(tl, sc_meta=accel.sc_meta)
    return accel, accel.cluster_lo, accel.cluster_hi, tl


@pytest.mark.parametrize("mode", ["flat", "tl", "tl_sc"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_counts_follow_the_walk(mode, any_hit):
    """Per ray, the counts equal the walk written out (on every 11th ray);
    dead rays count nothing; a closest hit counts its row; no ray counts
    more rows than 8 per counted unit."""
    accel, lo, hi, tl = _case(mode)
    (org, dirn, inv_d, tmax), (entry, counts, scale) = _random_wave(
        accel, 2, 5, lo, hi)
    res = tw.tileloop_plain(org, dirn, inv_d, tmax, accel.tri_rows, entry,
                            counts, scale, any_hit, **tl)
    boxes, n_rows = tw.tileloop_work_plain(
        org, dirn, inv_d, tmax, accel.tri_rows, entry, counts, scale,
        any_hit, bt=res[0], bs=res[3], bi=res[4] if len(res) == 5 else None,
        **tl)
    dead = tmax < 0
    assert int(boxes[dead].sum()) == 0 and int(n_rows[dead].sum()) == 0
    assert bool((n_rows <= 8 * boxes).all())
    if any_hit:
        occluded = (res[3] >= 0) & ~dead
        assert int(occluded.sum()) > 20
        assert bool((n_rows[occluded] >= 1).all())
    else:
        hit = res[3] >= 0
        assert int(hit.sum()) > 20
        assert bool((n_rows[hit] >= 1).all()) and bool((boxes[hit] >= 1).all())
    assert int(n_rows.sum()) > 0
    for r in range(0, org.shape[0], 11):
        want = _walk_counts(r, org, inv_d, tmax, accel.tri_rows, entry,
                            counts, scale, any_hit, res, dirn, **tl)
        assert (int(boxes[r]), int(n_rows[r])) == want, r


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_all_pairs_rows_count_every_cluster(any_hit):
    """The all-pairs row (scale 0, no distance bits): every live ray
    counts a box test for each cluster its walk reaches — all of them,
    unless an any-hit walk stops at an occluder."""
    scene = cornell_box(path_tracer=True)
    accel = build_pair_accel(None, scene_meta(scene), scene=scene).to("cpu")
    n_c = accel.cluster_lo.shape[0]
    (org, dirn, inv_d, tmax), _ = _random_wave(accel, 1, 9, accel.cluster_lo,
                                               accel.cluster_hi)
    entry = torch.arange(n_c, dtype=torch.int32)[None]
    counts = torch.tensor([n_c], dtype=torch.int32)
    res = tw.tileloop_plain(org, dirn, inv_d, tmax, accel.tri_rows, entry,
                            counts, 0.0, any_hit)
    boxes, n_rows = tw.tileloop_work_plain(
        org, dirn, inv_d, tmax, accel.tri_rows, entry, counts, 0.0, any_hit,
        bt=res[0], bs=res[3])
    live = tmax >= 0
    if any_hit:
        assert bool((boxes[live] >= 1).all() & (boxes[live] <= n_c).all())
        free = live & (res[3] < 0)  # no occluder: the whole row
        assert bool((boxes[free] == n_c).all())
    else:
        assert bool((boxes[live] == n_c).all())
    assert int(boxes[~live].sum()) == 0 and int(n_rows.sum()) > 0
