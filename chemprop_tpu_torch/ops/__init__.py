"""The port's kernels: each wrapper launches a hand-written CUDA kernel on a
CUDA tensor and takes its plain PyTorch version on a CPU tensor.

The forward launches are ``torch.library`` custom ops, registered when this
package is imported: ``chemprop_tpu_torch::message`` (A),
``::fused_iter`` (B), ``::fused_iter2`` (D), ``::seg_sum`` and
``::seg_sum_counts`` (C), ``::row_gather`` (I). A wrapper checks its inputs
and calls its op; the op launches the kernel (or takes the plain version)
and counts it, and its fake impl gives ``torch.export`` the output shapes,
so an exported program (``models.export``) holds the ops and launches the
kernels. The backward kernels E-H and J stay ctypes calls."""

from chemprop_tpu_torch.ops.build import LAUNCHES, UNSERVED, build_all
from chemprop_tpu_torch.ops.gather import gather_rev, gather_src, row_gather
from chemprop_tpu_torch.ops.grad_weight import grad_weight
from chemprop_tpu_torch.ops.message import (
    bwd_message,
    bwd_message_nodes,
    bwd_message_premul,
    depth_loop,
    first_iter,
    fused_iter,
    fused_iter2,
    iter_bwd,
    loop_readout,
    message,
    message_iter,
)
from chemprop_tpu_torch.ops.options import KernelOptions
from chemprop_tpu_torch.ops.segment import sorted_segment_sum, sorted_segment_sum_counts

__all__ = [
    "LAUNCHES",
    "UNSERVED",
    "KernelOptions",
    "build_all",
    "bwd_message",
    "bwd_message_nodes",
    "bwd_message_premul",
    "depth_loop",
    "first_iter",
    "fused_iter",
    "fused_iter2",
    "gather_rev",
    "gather_src",
    "grad_weight",
    "iter_bwd",
    "loop_readout",
    "message",
    "message_iter",
    "row_gather",
    "sorted_segment_sum",
    "sorted_segment_sum_counts",
]
