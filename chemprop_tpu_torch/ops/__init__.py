"""The port's kernels: each wrapper launches a hand-written CUDA kernel on a
CUDA tensor and takes its plain PyTorch version on a CPU tensor."""

from chemprop_tpu_torch.ops.build import LAUNCHES, build_all
from chemprop_tpu_torch.ops.message import fused_iter, message
from chemprop_tpu_torch.ops.segment import sorted_segment_sum, sorted_segment_sum_counts

__all__ = [
    "LAUNCHES",
    "build_all",
    "fused_iter",
    "message",
    "sorted_segment_sum",
    "sorted_segment_sum_counts",
]
