"""The port's render sharding (``tpurt_torch.parallel``) in one process,
with no process group: every shard of a mesh is computed in turn by the
shard's own function (``StagedRenderer(mesh=...).shard``,
``render_shard``) and merged by the port's merge (``merge_shards``), as
a world of ranks merges after its gather. Mirrors
tests/distributed/test_sharding.py.

Tolerances: a sharded render is bit-identical to the single-device
render of the same sample window (``assert_array_equal``), with its
closest and shadow counters equal where no pad pixel traces; against
the reference's ``render_batch_distributed`` the port's megakernel rule
(tests/test_torch_mega.py): RMSE ≤ 1e-3 with under 2% of pixels off by
more than 1e-3, and the counters equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.parallel import mesh as ref_mesh
from tpurt.render.intersectors import scene_meta as ref_meta
from tpurt.scene import procedural as ref_proc
from tpurt.scene.device import to_device as ref_to_device
from tpurt.utils.config import get_config as ref_config
from tpurt_torch.bvh.paircluster import build_pair_accel_two_level
from tpurt_torch.parallel.mesh import (
    RenderMesh,
    distributed_spec,
    make_render_mesh,
    merge_shards,
    render_shard,
)
from tpurt_torch.render import build_accel
from tpurt_torch.render.integrator import render_batch
from tpurt_torch.render.intersectors import scene_meta
from tpurt_torch.render.staged import StagedRenderer
from tpurt_torch.scene import procedural
from tpurt_torch.scene.device import to_device
from tpurt_torch.utils.config import get_config

torch.set_num_threads(1)

SEED = 7
CPU = torch.device("cpu")


def _setup(scene, preset, **over):
    cfg = get_config(preset, **over)
    meta = scene_meta(scene)
    ds = to_device(scene, device="cpu")
    return cfg, meta, ds


def staged_sharded(ds, accel, meta, cfg, cam, n_sample, n_tile):
    """Every shard of the staged loop's batch, merged: ((H, W, 3), counters)."""
    parts, counts = [], []
    for rank in range(n_sample * n_tile):
        r = StagedRenderer(ds, accel, meta=meta, config=cfg, device=CPU,
                           mesh=RenderMesh(n_sample, n_tile, rank, CPU))
        part, c = r.shard(cam, SEED, 0)
        parts.append(part)
        counts.append(c)
    total, counts = merge_shards(parts, counts, n_sample, n_tile)
    single = StagedRenderer(ds, accel, meta=meta, config=cfg, device=CPU)
    return single.frame(total, counts), r


def staged_window(ds, accel, meta, cfg, cam, n_sample):
    """The single-device staged loop over the same sample window:
    n_sample batches of spp_per_batch samples, summed in order."""
    r = StagedRenderer(ds, accel, meta=meta, config=cfg, device=CPU)
    img = counts = None
    for sid in range(n_sample):
        i, c = r(cam, SEED, sid * cfg.spp_per_batch)
        img = i if img is None else img + i
        counts = c if counts is None else counts + c
    return img, counts


@pytest.fixture(scope="module")
def cornell_pt():
    scene = procedural.cornell_box(path_tracer=True)
    cfg, meta, ds = _setup(scene, "cornell_pt", width=40, height=24, spp=2,
                           spp_per_batch=1, max_bounces=2,
                           intersector="bvh_tile", pipeline="staged")
    return scene, cfg, meta, ds, build_accel(cfg, ds, meta, scene=scene,
                                             device="cpu")


@pytest.mark.parametrize("n_sample,n_tile", [(1, 2), (2, 1), (2, 2), (1, 7)])
def test_staged_sharded_equals_single(cornell_pt, n_sample, n_tile):
    """Tile shards assemble the frame, sample shards cover disjoint
    windows: bit-equal to the single-device render of the window. 7 tile
    shards pad the 960-pixel stream by 6 pixels, which trace and are
    dropped at the resolve."""
    scene, cfg, meta, ds, accel = cornell_pt
    (img, counts), shard = staged_sharded(ds, accel, meta, cfg,
                                          scene.camera, n_sample, n_tile)
    want, want_counts = staged_window(ds, accel, meta, cfg, scene.camera,
                                      n_sample)
    assert img.shape == (cfg.height, cfg.width, 3)
    np.testing.assert_array_equal(img.numpy(), want.numpy())
    pad = shard.n_local * n_tile - shard.n_px
    assert pad == (6 if n_tile == 7 else 0)
    if not pad:
        np.testing.assert_array_equal(counts[:2].numpy(),
                                      want_counts[:2].numpy())


def test_staged_flat_shading_sharded(cornell_pt):
    """Flat shading (hello_triangle) shards like the rest."""
    scene = procedural.hello_triangle()
    cfg, meta, ds = _setup(scene, "hello_triangle", width=40, height=24)
    accel = build_accel(cfg, ds, meta, scene=scene, device="cpu")
    (img, _), _ = staged_sharded(ds, accel, meta, cfg, scene.camera, 1, 3)
    want, _ = staged_window(ds, accel, meta, cfg, scene.camera, 1)
    assert float(img.amax()) > 0
    np.testing.assert_array_equal(img.numpy(), want.numpy())


def test_staged_twolevel_sharded_equals_single():
    """The two-level instanced accel on a 2×2 mesh (mirrors
    test_sharding.py::test_staged_twolevel_distributed_equals_single)."""
    scene = procedural.sponza_standin(column_segments=8, column_rings=3)
    cfg, meta, ds = _setup(scene, "sponza", width=48, height=24, spp=1,
                           spp_per_batch=1, max_bounces=1,
                           intersector="bvh_tile", pipeline="staged")
    accel = build_pair_accel_two_level(ds, meta, scene=scene).to("cpu")
    (img, counts), _ = staged_sharded(ds, accel, meta, cfg, scene.camera,
                                      2, 2)
    want, want_counts = staged_window(ds, accel, meta, cfg, scene.camera, 2)
    np.testing.assert_array_equal(img.numpy(), want.numpy())
    np.testing.assert_array_equal(counts[:2].numpy(), want_counts[:2].numpy())


def mega_sharded(ds, accel, meta, cfg, cam, n_sample, n_tile):
    """Every shard of the megakernel's batch, merged and cropped."""
    mesh0 = RenderMesh(n_sample, n_tile, 0, CPU)
    rows, _ = distributed_spec(cfg, mesh0)
    parts, counts = [], []
    for rank in range(n_sample * n_tile):
        part, c = render_shard(ds, cam, SEED, 0, accel, meta=meta,
                               config=cfg,
                               mesh=RenderMesh(n_sample, n_tile, rank, CPU),
                               rows_per_shard=rows)
        parts.append(part)
        counts.append(c)
    total, counts = merge_shards(parts, counts, n_sample, n_tile)
    return total.reshape(-1, cfg.width, 3)[:cfg.height], counts


@pytest.fixture(scope="module")
def cornell():
    scene = procedural.cornell_box(False)
    cfg, meta, ds = _setup(scene, "cornell", width=32, height=24, spp=4,
                           spp_per_batch=1, max_bounces=1)
    return scene, cfg, meta, ds


def test_mega_lbvh_sharded_equals_single(cornell):
    """The megakernel's shards through the two-level LBVH on a 2×2 mesh
    equal its single-device batches (mirrors
    test_sharding.py::test_distributed_with_bvh)."""
    import dataclasses

    scene, cfg, meta, ds = cornell
    cfg = dataclasses.replace(cfg, intersector="bvh")
    accel = build_accel(cfg, ds, meta, device="cpu")
    img, counts = mega_sharded(ds, accel, meta, cfg, scene.camera, 2, 2)
    want = want_counts = None
    for sid in range(2):
        i, c = render_batch(ds, scene.camera, SEED, sid, accel, meta=meta,
                            config=cfg)
        want = i if want is None else want + i
        want_counts = c if want_counts is None else want_counts + c
    assert img.shape == (cfg.height, cfg.width, 3)
    np.testing.assert_array_equal(img.numpy(), want.numpy())
    np.testing.assert_array_equal(counts.numpy(), want_counts.numpy())


def test_mega_sharded_matches_reference_distributed(cornell):
    """The port's sharded megakernel against the reference's
    render_batch_distributed on the 8-device CPU mesh, 2×2, the brute
    force on both sides."""
    import dataclasses

    scene, cfg, meta, ds = cornell
    cfg = dataclasses.replace(cfg, intersector="brute")
    img, counts = mega_sharded(ds, None, meta, cfg, scene.camera, 2, 2)

    rs = ref_proc.cornell_box(False)
    rcfg = ref_config("cornell", width=32, height=24, spp=4,
                      spp_per_batch=1, max_bounces=1, intersector="brute")
    rmesh = ref_mesh.make_render_mesh(2, 2)
    rows, added = ref_mesh.distributed_spec(rcfg, rmesh)
    want, want_counts = ref_mesh.render_batch_distributed(
        ref_to_device(rs), rs.camera, jnp.uint32(SEED), jnp.uint32(0), None,
        meta=ref_meta(rs), config=rcfg, mesh=rmesh, rows_per_shard=rows)
    want = np.asarray(want)[:cfg.height]
    assert added == 2
    got = img.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert float(np.sqrt(np.mean((got - want) ** 2))) <= 1e-3
    assert float((np.abs(got - want) > 1e-3).mean()) < 0.02
    np.testing.assert_array_equal(counts.numpy()[:2],
                                  np.asarray(want_counts, np.float64)[:2])


@pytest.mark.parametrize("n_sample,n_tile", [(1, 8), (8, 1), (2, 4), (2, 2),
                                             (1, 1)])
@pytest.mark.parametrize("preset,over", [
    ("cornell", dict(width=32, height=24, spp_per_batch=1)),
    ("bunny", {}),
    ("sponza", dict(height=1081))])
def test_distributed_spec_matches_reference(preset, over, n_sample, n_tile):
    rcfg, cfg = ref_config(preset, **over), get_config(preset, **over)
    want = ref_mesh.distributed_spec(
        rcfg, ref_mesh.make_render_mesh(n_sample, n_tile))
    assert distributed_spec(cfg, RenderMesh(n_sample, n_tile, 0, CPU)) == want
    assert distributed_spec(cfg, None) == ref_mesh.distributed_spec(rcfg,
                                                                    None)


def test_mesh_coordinates_sample_major():
    """Rank r is shard (r // n_tile, r % n_tile)."""
    coords = [(m.sample_id, m.tile_id) for m in
              (RenderMesh(2, 3, r, CPU) for r in range(6))]
    assert coords == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]


@pytest.mark.parametrize("n_sample,n_tile", [(2, 2), (1, 2), (3, 1)])
def test_make_render_mesh_needs_a_world(n_sample, n_tile):
    """One process is a world of one rank: a bigger mesh raises, naming
    the world it needs and how to launch it."""
    need = n_sample * n_tile
    with pytest.raises(ValueError, match=f"world of {need} ranks") as e:
        make_render_mesh(n_sample, n_tile, device="cpu")
    assert "--multihost" in str(e.value) and "torchrun" in str(e.value)


def test_make_render_mesh_takes_the_reference_call():
    """The reference's call (``n_sample_shards``, ``n_tile_shards``,
    ``devices``) in one process, a world of one rank: rank 0 on
    ``devices[0]``, and its merge is the shard itself, with no group to
    gather over; a ``devices`` list shorter than the mesh raises, as the
    reference's does."""
    mesh = make_render_mesh(n_sample_shards=1, n_tile_shards=1,
                            devices=["cpu"])
    assert mesh == RenderMesh(1, 1, 0, CPU)
    assert make_render_mesh(1, 1, None, device="cpu") == mesh
    part, counts = torch.arange(6.0).reshape(2, 3), torch.ones(4)
    total, total_counts = mesh.merge(part, counts)
    assert torch.equal(total, part) and torch.equal(total_counts, counts)
    with pytest.raises(ValueError, match="need 1 devices"):
        make_render_mesh(1, 1, [])
