"""Multi-process set-up (cf. ``chemprop_tpu/parallel/distributed.py``): one
process per GPU in a ``torch.distributed`` process group.

The JAX package reads ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID``; the port reads torchrun's ``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, or takes them as arguments:

    torchrun --nproc-per-node 4 -m chemprop_tpu_torch.cli train ... --devices 4

The backend is NCCL on a CUDA device (``cuda:LOCAL_RANK``) and gloo on the
CPU (``device="cpu"``). Nothing on the machine tells a process of a
cluster: without torchrun's variables a single process forms a group of
one at ``tcp://localhost`` on a free port. The JAX package's
``host_local_array_to_global`` and ``host_local_batch_to_global`` assemble
global arrays for GSPMD and have no counterpart here (each rank keeps its
own shard); they raise with that stated."""

from __future__ import annotations

import os
import socket

import torch

from chemprop_tpu_torch.parallel.sharding import GSPMD_DIVERGENCE

_DEVICE: list[torch.device] = []


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
    device: str | torch.device | None = None,
) -> None:
    """Initialise the default process group, once. ``coordinator_address``
    is ``host:port`` (default ``MASTER_ADDR:MASTER_PORT``), ``num_processes``
    the world size (``WORLD_SIZE``), ``process_id`` the rank (``RANK``),
    ``local_device_ids[0]`` the GPU index (``LOCAL_RANK``). ``device``: None
    for the GPU (raises without one), ``"cpu"`` for gloo."""
    import torch.distributed as dist

    from chemprop_tpu_torch.utils.device import resolve_device

    if dist.is_initialized():
        return
    dev = resolve_device(device)
    env = os.environ
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    local = (local_device_ids[0] if local_device_ids else int(env.get("LOCAL_RANK", rank)))
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif world == 1:
            coordinator_address = f"localhost:{_free_port()}"
        else:
            raise ValueError("a group of several processes needs a coordinator address "
                             "(MASTER_ADDR and MASTER_PORT, as torchrun sets them)")
    kwargs = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
        kwargs["device_id"] = dev
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank, **kwargs)
    _DEVICE[:] = [dev]


def local_device() -> torch.device:
    """The device this rank computes on (set by :func:`initialize`; the
    first CUDA device, or the CPU for a gloo group initialised elsewhere)."""
    import torch.distributed as dist

    if _DEVICE:
        return _DEVICE[0]
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shutdown() -> None:
    """Destroy the default group (where there is one)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE.clear()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_shard(n: int) -> slice:
    """The [start, stop) row range this process owns out of ``n`` rows."""
    per = -(-n // process_count())
    lo = process_index() * per
    return slice(lo, min(lo + per, n))


def host_local_array_to_global(x, mesh, spec=None):
    """Not in the port (GSPMD's global arrays)."""
    raise NotImplementedError(GSPMD_DIVERGENCE)


def host_local_batch_to_global(batch, mesh):
    """Not in the port (GSPMD's global arrays)."""
    raise NotImplementedError(GSPMD_DIVERGENCE)
