"""The port's counterpart of a one-axis device mesh (cf.
``chemprop_tpu/parallel/sharding.py``): a ``torch.distributed`` process group,
one process per GPU, with its rank, world size and device.

The JAX package shards global batch arrays over a mesh and lets GSPMD
partition the step (``batch_shardings``, ``shard_batch``). PyTorch has no
counterpart of that: here every rank collates only its own shard of a batch
(``data.collate.collate_sharded``, ``DataLoader(n_shards=..., shard_index=...)``)
and runs the explicit per-rank step of ``parallel/shard_train.py``. The two
names stay, and raise with that divergence stated.

Launch several GPUs with ``torchrun --nproc-per-node N ...``; on the CPU the
group is gloo's."""

from __future__ import annotations

from dataclasses import dataclass

import torch

DATA_AXIS = "data"

GSPMD_DIVERGENCE = (
    "the port has no GSPMD sharding of global arrays: each rank collates its own shard "
    "(data.collate.collate_sharded, DataLoader(n_shards=..., shard_index=...)) and runs "
    "the explicit per-rank step (parallel.shard_train)"
)


@dataclass(frozen=True)
class Mesh:
    """A process group as a one-axis mesh: ``group`` (None: the default
    group), this process's ``rank`` in it, its ``size`` and the ``device``
    this rank computes on."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis_name: str = DATA_AXIS


def make_mesh(devices=None, axis_name: str = DATA_AXIS,
              device: str | torch.device | None = None) -> Mesh:
    """The mesh of this process's group: initialises ``torch.distributed``
    from torchrun's variables first where it is not (``distributed.initialize``;
    on ``cuda`` unless ``device`` says otherwise, which raises without a GPU).
    ``devices``: None for every rank, an int ``n`` or a list of ranks for a
    subgroup (every rank must call this alike, as ``new_group`` requires)."""
    import torch.distributed as dist

    from chemprop_tpu_torch.parallel import distributed

    if not dist.is_initialized():
        distributed.initialize(device=device)
    group = None
    if devices is not None:
        ranks = list(range(devices)) if isinstance(devices, int) else list(devices)
        if ranks != list(range(dist.get_world_size())):
            group = dist.new_group(ranks)
            if dist.get_rank() not in ranks:
                raise ValueError(f"rank {dist.get_rank()} is not in the mesh's ranks {ranks}")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                distributed.local_device(), axis_name)


def current_mesh() -> Mesh | None:
    """The mesh of the default group, or None where ``torch.distributed`` is
    not initialised."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    from chemprop_tpu_torch.parallel import distributed

    return Mesh(None, dist.get_rank(), dist.get_world_size(), distributed.local_device())


def replicate(tree, mesh: Mesh):
    """Make every tensor of ``tree`` (a tensor, or a dict, list or tuple of
    them, nested) rank 0's, in place, by broadcasts over the mesh's group;
    returns ``tree``."""
    import torch.distributed as dist

    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)

    def visit(x):
        if isinstance(x, torch.Tensor):
            with torch.no_grad():
                buf = x.detach()
                dist.broadcast(buf, src, group=mesh.group)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    if mesh.size > 1:
        visit(tree)
    return tree


def batch_shardings(mesh, batch):
    """Not in the port: GSPMD names the shardings of global arrays."""
    raise NotImplementedError(GSPMD_DIVERGENCE)


def shard_batch(batch, mesh):
    """Not in the port: GSPMD puts a global batch across the mesh."""
    raise NotImplementedError(GSPMD_DIVERGENCE)
