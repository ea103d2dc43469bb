"""Sorted segment sum (cf. ``chemprop_tpu/ops/segment.py`` and
``chemprop_tpu/ops/sorted_segments.py``): the edge->node readout ``M_v`` and
the node->graph mean readout.

``data`` rows are sorted by segment id ``ids``, and ``ptr`` holds the CSR
row pointers of ``ids`` (segment ``s`` is rows ``[ptr[s], ptr[s+1])``); the
number of segments is ``len(ptr) - 1``. Sums accumulate in f32 and are cast
once to ``out_dtype``. On a CUDA tensor the kernel in ``csrc/segment.cu``
runs, for the dtype pairs of ``KERNEL_DTYPES`` (another pair raises); on a
CPU tensor the plain version below.

Both entry points are differentiable in ``data`` (cf. the custom VJPs of
``sorted_segments.py``): the cotangent of a sum is the gather ``g[ids]``, a
plain indexing as in the JAX package, and for bfloat16 ``data`` the sum with
counts (the mean readout) expands it with the row-gather kernel of
``ops/gather.py``."""

from __future__ import annotations

import torch

from chemprop_tpu_torch.ops.build import LAUNCHES, call, library
from chemprop_tpu_torch.ops.gather import row_gather

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (data, out) dtype pairs the kernel is built for: those of the readouts
KERNEL_DTYPES = {
    (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32),
}


def sorted_segment_sum(
    data: torch.Tensor, ids: torch.Tensor, ptr: torch.Tensor, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """``[len(ptr) - 1, d]`` segment sums; ``out_dtype`` defaults to ``data``'s."""
    return _SegmentSum.apply(data, ids, ptr, out_dtype or data.dtype, False)[0]


def sorted_segment_sum_counts(
    data: torch.Tensor, ids: torch.Tensor, ptr: torch.Tensor, out_dtype: torch.dtype = torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Segment sums and the f32 row count of each segment."""
    return _SegmentSum.apply(data, ids, ptr, out_dtype, True)


def sorted_segment_sum_plain(
    data: torch.Tensor, ids: torch.Tensor, ptr: torch.Tensor, out_dtype: torch.dtype,
    with_counts: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The plain PyTorch version of the kernel."""
    n_seg = ptr.numel() - 1
    out = torch.zeros((n_seg, data.shape[1]), dtype=torch.float32, device=data.device)
    out.index_add_(0, ids.long(), data.float())
    counts = (ptr[1:] - ptr[:-1]).float() if with_counts else None
    return out.to(out_dtype), counts


def _check(data, ids, ptr, out_dtype):
    if data.dim() != 2 or not data.is_contiguous():
        raise ValueError("data must be a contiguous [n, d] table")
    if data.dtype not in DTYPES or out_dtype not in DTYPES:
        raise TypeError(f"dtypes must be float32 or bfloat16, got {data.dtype} -> {out_dtype}")
    if ids.dtype != torch.int32 or ptr.dtype != torch.int32:
        raise TypeError("ids and ptr must be int32")
    if ids.shape != (data.shape[0],) or ptr.dim() != 1 or ptr.numel() < 1:
        raise ValueError(f"ids {tuple(ids.shape)} / ptr {tuple(ptr.shape)} do not fit data")
    if ids.device != data.device or ptr.device != data.device:
        raise ValueError("data, ids and ptr must be on one device")


def _segment_sum(data, ids, ptr, out_dtype, with_counts):
    _check(data, ids, ptr, out_dtype)
    if data.device.type == "cpu":
        return sorted_segment_sum_plain(data, ids, ptr, out_dtype, with_counts)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if (data.dtype, out_dtype) not in KERNEL_DTYPES:
        raise TypeError(f"the segment-sum kernel takes no {data.dtype} -> {out_dtype}")
    n, d = data.shape
    if d % 4 != 0 or data.data_ptr() % 16 != 0:
        raise ValueError(f"width {d} must be a multiple of 4, rows 16-byte aligned")
    ids, ptr = ids.contiguous(), ptr.contiguous()
    n_seg = ptr.numel() - 1
    lib = library("segment")
    out = torch.empty((n_seg, d), dtype=out_dtype, device=data.device)
    counts = torch.empty(n_seg, dtype=torch.float32, device=data.device) if with_counts else None
    scratch = torch.empty((lib.seg_scratch_rows(n), d), dtype=torch.float32, device=data.device)
    call(
        lib, "seg_sum", data, ids, ptr, out, counts, scratch, n, n_seg, d,
        DTYPES[data.dtype], DTYPES[out_dtype],
    )
    LAUNCHES["sorted_segment_sum"] += 1
    return out, counts


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, ptr, out_dtype, with_counts):
        out, counts = _segment_sum(data, ids, ptr, out_dtype, with_counts)
        ctx.save_for_backward(ids)
        ctx.data_dtype, ctx.with_counts = data.dtype, with_counts
        if with_counts:
            ctx.mark_non_differentiable(counts)
        return out, counts

    @staticmethod
    def backward(ctx, g, _g_counts):
        (ids,) = ctx.saved_tensors
        if g is None:
            return None, None, None, None, None
        if ctx.with_counts and ctx.data_dtype == torch.bfloat16:
            # casting the small table first equals casting the expanded one
            return row_gather(g.to(torch.bfloat16).contiguous(), ids), None, None, None, None
        return g[ids.long()].to(ctx.data_dtype), None, None, None, None
