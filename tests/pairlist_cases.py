"""Shared cases of the tile intersector's pair-list tests
(tests/test_torch_pairseg.py, tests/test_torch_tilegrid.py): the scenes
built by both packages, waves prepared as the intersector prepares them,
recorders that stand in for the reference's launchers, and the per-ray
comparison with its tolerances."""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from tpurt.bvh import paircluster as ref_pc
from tpurt.kernels import tilewave as ref_tw
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import procedural as ref_proc
from tpurt.scene.device import to_device as ref_to_device
from tpurt_torch.bvh import paircluster as port_pc
from tpurt_torch.kernels import tilewave as tw
from tpurt_torch.render import render_scene
from tpurt_torch.render.intersectors import scene_meta as port_meta
from tpurt_torch.scene import procedural as port_proc
from tpurt_torch.utils.config import get_config


@functools.lru_cache(maxsize=None)
def setup(name):
    """bunny_standin(3) (14 clusters, flat), sponza_standin(8, 3) (126
    instance-clusters, two-level) or the Cornell box (all-pairs), built by
    both packages."""
    if name == "bunny":
        rs, ps = ref_proc.bunny_standin(3), port_proc.bunny_standin(3)
        builds = ref_pc.build_pair_accel, port_pc.build_pair_accel
    elif name == "cornell":
        rs, ps = ref_proc.cornell_box(), port_proc.cornell_box()
        builds = ref_pc.build_pair_accel, port_pc.build_pair_accel
    else:
        rs = ref_proc.sponza_standin(column_segments=8, column_rings=3)
        ps = port_proc.sponza_standin(column_segments=8, column_rings=3)
        builds = (ref_pc.build_pair_accel_two_level,
                  port_pc.build_pair_accel_two_level)
    r_acc = builds[0](ref_to_device(rs), ref_meta(rs), scene=rs)
    p_acc = builds[1](None, port_meta(ps), scene=ps).to("cpu")
    lo, hi = r_acc.cluster_lo, r_acc.cluster_hi
    return dict(r_acc=r_acc, p_acc=p_acc, lo=lo, hi=hi,
                diag=float(np.linalg.norm(hi.max(0) - lo.min(0))))


def wave(name, n_tiles, sort, any_hit, seed=0):
    """Tiles of rays from a small region toward the scene's middle (some
    dead), prepared as the intersector prepares them: scene-exit tmax
    cap, octant sort for sorted waves. Returns numpy (org, d, tmv)."""
    s = setup(name)
    lo, hi = s["lo"].min(0), s["hi"].max(0)
    center, ext = (lo + hi) / 2, hi - lo
    rng = np.random.default_rng(seed)
    n = n_tiles * tw.TILE
    org = center + np.asarray([0.1, 0.05, 0.6]) * ext \
        + rng.normal(size=(n, 3)) * 0.02 * ext
    d = center + rng.normal(size=(n, 3)) * 0.15 * ext - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(np.arange(n) % 9 == 0, -1.0,
                    rng.uniform(0.3, 1.0, n) * s["diag"] if any_hit
                    else 3.4e38)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    org, d, tmv = t(org), t(d), t(tmax)
    lo_t, hi_t = t(lo), t(hi)
    ext_t = hi_t - lo_t
    diag = torch.sqrt(ext_t[0] * ext_t[0] + ext_t[1] * ext_t[1]
                      + ext_t[2] * ext_t[2])
    tmv = tw._scene_exit_cap(org, d, tmv, lo_t, hi_t, diag)
    if sort:
        perm = torch.sort(tw._octant_sort_keys(org, d, tmv, lo_t, hi_t),
                          stable=True).indices
        org, d, tmv = org[perm], d[perm], tmv[perm]
    return org.numpy(), d.numpy(), tmv.numpy()


def recorder(calls, n_out, stats_of):
    """A stand-in launcher: records its arguments, returns dead-lane
    outputs."""
    def record(*args, **kwargs):
        calls.append((args, kwargs))
        n = next(a for a in args if getattr(a, "ndim", 0) == 2
                 and a.shape[1] == 3).shape[0]
        z = jnp.zeros(n) if isinstance(args[0], jnp.ndarray) or \
            args[0] is None else torch.zeros(n)
        out = tuple(z - 1.0 for _ in range(n_out))
        return out + stats_of(kwargs) if stats_of else out
    return record


def ref_stats(kwargs):
    return (jnp.zeros(1),  # bi
            jnp.stack([jnp.asarray(kwargs["n_pairs"], jnp.float32),
                       jnp.asarray(kwargs["overflow"], jnp.float32)]))


def tl_tables(s):
    acc = s["p_acc"]
    return dict(pair_meta=getattr(acc, "pair_meta", None),
                inv_xform=getattr(acc, "inv_xform", None))


def kernel_case(name, n_tiles, any_hit, k, grid, monkeypatch):
    """A wave and its pair list, built by the reference's host side (its
    launcher recorded), for the kernel comparisons."""
    s = setup(name)
    org, d, tmv = wave(name, n_tiles, True, any_hit, seed=1)
    n_c = s["lo"].shape[0]
    calls = []
    args = (jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmv),
            jnp.asarray(s["lo"]), jnp.asarray(s["hi"]),
            jnp.asarray(s["r_acc"].tri_rows))
    with monkeypatch.context() as mp:
        if grid:
            mp.setattr(ref_tw, "_launch_tiles",
                       recorder(calls, 4, ref_stats))
            all_pairs = name == "cornell"
            ref_tw._trace_tiles(
                *args, n_clusters=n_c,
                pair_cap=n_tiles * (n_c if all_pairs else k),
                per_tile_clamp=k, interpret=True, all_pairs=all_pairs)
        else:
            mp.setenv("TPURT_ENTRY_ROWS", "0")
            mp.setattr(ref_tw, "_launch_tiles_loop",
                       recorder(calls, 4, ref_stats))
            ref_tw._trace_tiles_loop(
                *args, n_clusters=n_c, pcap=n_tiles * n_c, per_tile_clamp=k,
                interpret=True, any_hit=any_hit, exact_ok=False)
    (lists, kw) = calls[0]
    return s, (org, d, tmv), lists, kw


def compare(s, got, want, tmv, any_hit, uv_atol):
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    live = tmv >= 0
    if any_hit:
        np.testing.assert_array_equal(got[3] >= 0, want[3] >= 0)
        assert 0 < (got[3][live] >= 0).sum() < live.sum()
        return
    hit = want[3] >= 0
    np.testing.assert_array_equal(got[3] >= 0, hit)
    assert hit.sum() > 50
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-6,
                               atol=1e-6 * s["diag"])
    same = hit & (got[3] == want[3])
    assert same.sum() >= 0.999 * hit.sum()  # else an exact-t tie
    for k in (1, 2):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=0,
                                   atol=uv_atol)
    if len(got) == 5:
        np.testing.assert_array_equal(got[4][same], want[4][same])


SMALL = dict(width=64, height=48, spp=2, spp_per_batch=2, max_bounces=2,
             intersector="bvh_tile")


@functools.lru_cache(maxsize=None)
def entry_row_render(name):
    scene = (port_proc.bunny_standin(3) if name == "bunny"
             else port_proc.sponza_standin(8, 3))
    cfg = get_config("bunny" if name == "bunny" else "sponza", **SMALL)
    state, _ = render_scene(cfg, device="cpu", scene=scene)
    return cfg, scene, state


def count_modes(monkeypatch):
    """Count the tile intersector's traversal calls by mode."""
    ran = {"seg": 0, "grid": 0, "rows": 0}
    for fn, key in (("tileloop_seg", "seg"), ("tilegrid", "grid"),
                    ("tileloop", "rows")):
        orig = getattr(tw, fn)

        def counted(*a, _orig=orig, _key=key, **kw):
            ran[_key] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(tw, fn, counted)
    return ran
