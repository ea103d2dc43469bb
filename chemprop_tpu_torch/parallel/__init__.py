"""Multi-GPU training and inference (cf. ``chemprop_tpu/parallel``): whole
graphs per rank over a ``torch.distributed`` process group
(``shard_train``), and giant molecules cut across shards with their halo
exchange (``partitioned_mp``, over ``ops.edge_partition``)."""

from chemprop_tpu_torch.parallel import distributed
from chemprop_tpu_torch.parallel.shard_train import (
    is_sharded_batch,
    local_shard,
    make_sharded_apply,
    make_sharded_eval_step,
    make_sharded_train_step,
    unstack_preds,
)
from chemprop_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    Mesh,
    batch_shardings,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "batch_shardings",
    "distributed",
    "is_sharded_batch",
    "local_shard",
    "make_mesh",
    "make_sharded_apply",
    "make_sharded_eval_step",
    "make_sharded_train_step",
    "replicate",
    "shard_batch",
    "unstack_preds",
]
