"""Data-parallel training over a process group: the train, eval and predict
steps of one rank (cf. ``chemprop_tpu/parallel/shard_train.py``).

One process per GPU; every rank holds whole graphs, its shard of each batch
(``data.collate.Shard``: ``collate_sharded`` on the rank's own rows, or a
plain batch cut on the host with ``partition_shards``), and runs the port's
single-device model on it, kernels and all. The only traffic between ranks:

* the sum of the criterion's streaming state (the exact global-batch loss,
  for a nonlinear ``compute`` such as RMSE too);
* the sum of the gradients;
* the sum of the batch-norm moments (``nn.batchnorm.BatchNorm.mesh``), so
  that sharded training equals single-device training.

The loss is built as the JAX package builds it: the gradient of the
criterion's local state is taken through the local forward, chained with
``d compute / d state`` at the summed global state, and the chained
gradients are summed. Differentiating ``compute`` of an all-reduced state
directly would run an all-reduce in the backward and make every gradient
world-size times too large; ``DistributedDataParallel`` averages per-rank
means instead of taking the global loss. Neither is used. The Adam step is
then the same on every rank (replicated parameters). Dropout masks come from
one ``torch.Generator`` per rank seeded from ``(seed, rank)``
(:func:`rank_generator`; rank 0's is the single-device trainer's), where
the JAX package folds the axis index into its key.

The steps are the ``Trainer``'s (``Trainer(mesh=...)``), built here:
:func:`make_sharded_train_step`, :func:`make_sharded_eval_step`,
:func:`make_sharded_apply`."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from chemprop_tpu_torch.data.collate import Shard, TrainingBatch, shard_of_batch
from chemprop_tpu_torch.parallel.sharding import Mesh


def is_sharded_batch(batch) -> bool:
    """Whether ``batch`` is one rank's shard of a global batch."""
    return isinstance(batch, Shard)


def local_shard(batch, mesh: Mesh | None = None) -> TrainingBatch:
    """The rank's own rows of ``batch``: a ``Shard``'s batch; a plain batch
    cut on the host into the mesh's whole-graph shards (left whole on a mesh
    of one)."""
    return as_shard(batch, mesh).batch


def as_shard(batch, mesh: Mesh | None) -> Shard:
    if isinstance(batch, Shard):
        if mesh is not None and (batch.n_shards, batch.index) != (mesh.size, mesh.rank):
            raise ValueError(f"shard {batch.index} of {batch.n_shards} on rank {mesh.rank} of "
                             f"{mesh.size}")
        return batch
    if mesh is None or mesh.size == 1:
        rows = list(range(int(batch.pad_mask.sum())))
        return Shard(batch, [rows], 0)
    return shard_of_batch(batch, mesh.size, mesh.rank)


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The dropout generator of ``rank``: seeded from ``seed + rank * 2**32``,
    so that rank 0's masks are the single-device trainer's."""
    return torch.Generator(device=device).manual_seed(seed + rank * 2**32)


def group_sum_(tensors: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Each tensor summed over the mesh's group (contiguous, as NCCL takes
    them; a contiguous tensor in place)."""
    import torch.distributed as dist

    out = [t.contiguous() for t in tensors]
    for t in out:
        dist.all_reduce(t, group=mesh.group)
    return out


def sum_state(state: dict, mesh: Mesh) -> dict:
    """A criterion state summed over the group (a new dict of new tensors)."""
    keys = list(state)
    return dict(zip(keys, group_sum_([state[k].detach().clone() for k in keys], mesh)))


def sharded_grads(model, batch: TrainingBatch, params: list[torch.Tensor], mesh: Mesh,
                  generator: torch.Generator | None) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The global loss over every rank's shard and its gradient in
    ``params``, summed over the group: ``(loss, grads)``."""
    from chemprop_tpu_torch.train.trainer import _targets

    criterion = model.criterion
    preds = model.train_step_preds(batch.bmg, batch.V_d, batch.X_d, is_training=True,
                                   generator=generator)
    mask, targets, lt, gt = _targets(batch)
    local = criterion.update_state(criterion.init_state(), preds, targets, mask, batch.w[:, 0],
                                   lt, gt)
    glob = sum_state(local, mesh)
    keys = [k for k in local if local[k].requires_grad]
    for k in keys:
        glob[k].requires_grad_()
    loss = criterion.compute(glob)
    d_state = torch.autograd.grad(loss, [glob[k] for k in keys])
    grads = torch.autograd.grad([local[k] for k in keys], params, grad_outputs=d_state,
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return loss.detach(), group_sum_(grads, mesh)


def make_sharded_train_step(trainer, mesh: Mesh) -> Callable:
    """The trainer's step over ``mesh``: ``step(batch) -> loss`` (a ``Shard``
    or a plain batch to cut), with the trainer's clipping, schedule, Adam
    and frozen parameters."""

    def step(batch):
        return trainer.train_step(batch)

    return step


def make_sharded_eval_step(model, criterion, mesh: Mesh) -> Callable:
    """``eval_step(batch) -> (state, preds)``: the criterion's state over
    every rank's shard (summed over the group) and this rank's
    validation-space predictions of its shard's real rows."""

    from chemprop_tpu_torch.train.trainer import _targets

    @torch.inference_mode()
    def eval_step(batch):
        shard = as_shard(batch, mesh)
        b = shard.batch.to(mesh.device)
        Z = model.fingerprint(b.bmg, b.V_d, b.X_d, False)
        mask, targets, lt, gt = _targets(b)
        state = criterion.update_state(criterion.init_state(), model.predictor.train_step(Z, False),
                                       targets, mask, b.w[:, 0], lt, gt)
        n = len(shard.groups[shard.index])
        return sum_state(state, mesh), model.predictor.val_step(Z)[:n]

    return eval_step


def make_sharded_apply(model, mesh: Mesh, method: str | None = None, **apply_kwargs) -> Callable:
    """``apply(batch) -> [n_real, ...]``: inference over every rank's shard,
    gathered and put back in the global batch's row order, on every rank
    (``method``: a method of the model, ``forward`` by default)."""
    fn = getattr(model, method) if method else model

    @torch.inference_mode()
    def apply(batch):
        shard = as_shard(batch, mesh)
        b = shard.batch.to(mesh.device)
        preds = fn(b.bmg, b.V_d, b.X_d, **apply_kwargs)
        return gather_rows(preds[: len(shard.groups[shard.index])], shard, mesh)

    return apply


def gather_rows(local: torch.Tensor, shard: Shard, mesh: Mesh) -> np.ndarray:
    """Every rank's rows of a global batch (``local``: this rank's, in its
    group's order), gathered in shard order (:func:`unstack_preds`) and put
    back in the global batch's row order."""
    import torch.distributed as dist

    mine = local.float().cpu().numpy()
    parts = [mine]
    if mesh.size > 1:
        parts = [None] * mesh.size
        dist.all_gather_object(parts, mine, group=mesh.group)
    flat = unstack_preds(parts)
    order = np.concatenate([np.asarray(g, np.int64) for g in shard.groups])
    out = np.empty_like(flat)
    out[order] = flat
    return out


def unstack_preds(preds) -> np.ndarray:
    """Per-shard predictions (a list of ``[B_k, ...]``, or an array ``[S,
    B, ...]``) as one ``[sum B_k, ...]`` array in shard order."""
    if isinstance(preds, np.ndarray):
        return preds.reshape((-1,) + preds.shape[2:])
    return np.concatenate([np.asarray(p) for p in preds], axis=0)
