"""The port's kernels: each wrapper launches a hand-written CUDA kernel on a
CUDA tensor and takes its plain PyTorch version on a CPU tensor."""

from chemprop_tpu_torch.ops.build import LAUNCHES, build_all
from chemprop_tpu_torch.ops.gather import row_gather
from chemprop_tpu_torch.ops.message import (
    bwd_message,
    bwd_message_nodes,
    bwd_message_premul,
    fused_iter,
    loop_readout,
    message,
)
from chemprop_tpu_torch.ops.segment import sorted_segment_sum, sorted_segment_sum_counts

__all__ = [
    "LAUNCHES",
    "build_all",
    "bwd_message",
    "bwd_message_nodes",
    "bwd_message_premul",
    "fused_iter",
    "loop_readout",
    "message",
    "row_gather",
    "sorted_segment_sum",
    "sorted_segment_sum_counts",
]
