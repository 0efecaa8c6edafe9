"""Render sharding over ``torch.distributed`` — port of
``tpurt.parallel.mesh``.

A ("sample", "tile") mesh of ranks, one process a shard:

  axis "tile"   (X1): the frame's pixels are split between the tile
                      shards; the scene, the accel and the camera are
                      replicated;
  axis "sample" (X2): each sample shard renders its pixels over its own
                      window of the counter-based sample stream.

Rank r is shard (s, t) = (r // n_tile, r % n_tile): sample-major, as the
reference's flat ray axis ``P(("sample", "tile"))``. The reference runs
one controller over every device; here every shard is a process of its
own, on one host (``torchrun --nproc-per-node N``) or many
(``--multihost``).

A shard's result is a per-pixel sum over its samples. The merge gathers
every rank's sums and adds the sample shards of each tile shard in the
fixed order g[0] + g[1] + … — never a reduction that reassociates — so
an N-shard render is bit-identical to the single-device render of the
same sample window. The merge is a pure function (``merge_shards``) apart
from the gather: a single process can compute every shard in turn and
merge them with the same code, with no process group. Counters are
integer-valued f64, so their sum is exact in any order; every rank ends
a batch with the world's counters, so every rank takes the same
re-render and retry decisions.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from tpurt_torch.core.camera import Camera
from tpurt_torch.render.integrator import render_pixels
from tpurt_torch.render.intersectors import SceneMeta
from tpurt_torch.scene.device import torch_device
from tpurt_torch.utils.config import RenderConfig

# a collective that waits longer than this fails its rank (a hung peer
# never holds the world forever)
TIMEOUT_S = 300.0


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: the CPU for CPU ranks; for ``"cuda"``
    with no index, card (LOCAL_RANK or rank) % device count."""
    device = torch_device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def pick_backend(device, world: int) -> str:
    """gloo for CPU ranks and for ranks that share a card (NCCL refuses
    two ranks on one GPU); NCCL where every rank of a host has a card of
    its own. A host's rank count is torchrun's LOCAL_WORLD_SIZE, else the
    whole world."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *, device="cuda"):
    """Join this process to the world of ranks; returns (rank, world).

    With ``coordinator_address`` ("host:port", served by rank 0) the
    world is ``num_processes`` ranks and this one is ``process_id``; with
    none, torchrun's environment (``env://``: MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE) says so. The backend is picked from the devices
    before the group starts (``pick_backend``), and the rank's card
    (``rank_device``) becomes the current one. Collectives time out after
    ``TIMEOUT_S``. The group is destroyed when the interpreter exits
    (``leave_world``). A second call is a no-op."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    else:
        init_method = "env://"
        world = int(num_processes if num_processes is not None
                    else os.environ.get("WORLD_SIZE", 1))
        rank = int(process_id if process_id is not None
                   else os.environ.get("RANK", 0))
    device = rank_device(device, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        pick_backend(device, world), init_method=init_method,
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    atexit.register(leave_world)
    return dist.get_rank(), dist.get_world_size()


def leave_world() -> None:
    """Destroy this process's group, joining its threads, while the
    interpreter still runs: a group left to the interpreter's teardown
    can abort the process as its threads are torn down under it (a rank
    that rendered correctly then exits with SIGABRT). Nothing else may
    hold the group (``RenderMesh`` gathers over the default one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """The ("sample", "tile") mesh as rank ``rank`` sees it: its shard,
    its device, and the backend of the world its merges gather over (a
    single process can also compute every shard in turn and merge them
    itself with ``merge_shards``)."""

    n_sample: int
    n_tile: int
    rank: int
    device: torch.device
    backend: str = "gloo"

    @property
    def sample_id(self) -> int:
        return self.rank // self.n_tile

    @property
    def tile_id(self) -> int:
        return self.rank % self.n_tile

    def all_gather(self, x: torch.Tensor) -> list:
        """Every rank's ``x`` (one shape on every rank), in rank order, on
        this rank's device; gloo gathers through the host."""
        if self.n_sample * self.n_tile == 1:
            return [x.to(self.device)]
        src = (x if self.backend == "nccl" else x.cpu()).contiguous()
        out = [torch.empty_like(src) for _ in range(self.n_sample
                                                     * self.n_tile)]
        dist.all_gather(out, src)
        return [t.to(self.device) for t in out]

    def merge(self, part: torch.Tensor, counts: torch.Tensor):
        """This rank's (per-pixel sums, counters) → the world's: the tile
        shards' merged sums concatenated in shard order, and the summed
        counters, the same on every rank."""
        return merge_shards(self.all_gather(part), self.all_gather(counts),
                            self.n_sample, self.n_tile)


def merge_shards(parts, counts, n_sample: int, n_tile: int):
    """Rank-ordered per-shard (sums, counters) → (the tile shards' sums in
    shard order, each the fixed-order sample sum g[0] + g[1] + … of its
    sample shards, concatenated along the first axis; the counters'
    sum)."""
    tiles = []
    for t in range(n_tile):
        total = parts[t]
        for s in range(1, n_sample):
            total = total + parts[s * n_tile + t]
        tiles.append(total)
    total_counts = counts[0]
    for c in counts[1:]:
        total_counts = total_counts + c
    return torch.cat(tiles), total_counts


def make_render_mesh(n_sample_shards: int = 1, n_tile_shards: int = 1,
                     devices=None, *, device="cuda") -> RenderMesh:
    """This rank's view of an ``n_sample_shards`` × ``n_tile_shards`` mesh
    over the world of ranks, one a shard; ValueError where the world's
    size is not ``n_sample_shards * n_tile_shards`` (a single process has
    a world of one). ``devices``, where given, lists the ranks' devices
    (rank r on ``devices[r]``); else every rank takes ``rank_device(device,
    rank)``."""
    n_sample, n_tile = n_sample_shards, n_tile_shards
    need = n_sample * n_tile
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"a {n_sample}x{n_tile} mesh needs a world of {need} ranks, one "
            f"a shard; this world has {world}: launch {need} processes, "
            f"e.g. torchrun --nproc-per-node {need} -m tpurt_torch render "
            "--multihost ..., or python -m tpurt_torch render --multihost "
            f"--coordinator HOST:PORT --num-processes {need} --process-id I "
            "... once for each rank I")
    if not dist.is_initialized():  # a world of one: no group to gather
        rank, backend = 0, "gloo"
    else:
        rank, backend = dist.get_rank(), dist.get_backend()
    if devices is not None:
        if len(devices) < need:
            raise ValueError(f"need {need} devices for a {n_sample}x"
                             f"{n_tile} mesh, have {len(devices)}")
        mine = torch_device(devices[rank])
    else:
        mine = rank_device(device, rank)
    return RenderMesh(n_sample, n_tile, rank, mine, backend)


def distributed_spec(config: RenderConfig, mesh: Optional[RenderMesh]):
    """(rows_per_shard, samples added per batch) for a config on a mesh."""
    if mesh is None:
        return config.height, config.spp_per_batch
    rows_per_shard = -(-config.height // mesh.n_tile)
    return rows_per_shard, config.spp_per_batch * mesh.n_sample


def render_shard(ds, cam: Camera, seed, sample0, accel=None, *,
                 meta: SceneMeta, config: RenderConfig, mesh: RenderMesh,
                 rows_per_shard: int):
    """The megakernel's batch on shard (s, t): rows t·rows_per_shard +
    [0, rows_per_shard) in row-major order (rows past the frame trace as
    pads), over the global sample indices sample0 + s·spp_per_batch + [0,
    spp_per_batch): ((rows_per_shard · W, 3) sums, counters)."""
    w = config.width
    dev = ds.tri_v0.device
    rows = mesh.tile_id * rows_per_shard + torch.arange(
        rows_per_shard, dtype=torch.int32, device=dev)
    py = rows.repeat_interleave(w)
    px = torch.arange(w, dtype=torch.int32, device=dev).repeat(
        rows_per_shard)
    return render_pixels(
        ds, cam, seed, sample0 + mesh.sample_id * config.spp_per_batch,
        accel, px, py, meta=meta, config=config)


def render_batch_distributed(ds, cam: Camera, seed, sample0, accel=None, *,
                             meta: SceneMeta, config: RenderConfig,
                             mesh: RenderMesh, rows_per_shard: int):
    """One distributed batch of the megakernel → ((H_padded, W, 3) sum,
    counters), the same on every rank. Adds ``config.spp_per_batch *
    mesh.n_sample`` samples a pixel; H is padded to ``rows_per_shard *
    n_tile`` rows and the caller crops."""
    part, counts = render_shard(ds, cam, seed, sample0, accel, meta=meta,
                                config=config, mesh=mesh,
                                rows_per_shard=rows_per_shard)
    total, counts = mesh.merge(part, counts)
    return total.reshape(-1, config.width, 3), counts
