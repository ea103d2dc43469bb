"""Sorted segment sum (cf. ``chemprop_tpu/ops/segment.py`` and
``chemprop_tpu/ops/sorted_segments.py``): the edge->node readout ``M_v`` and
the node->graph mean readout.

``data`` rows are sorted by segment id ``ids``, and ``ptr`` holds the CSR
row pointers of ``ids`` (segment ``s`` is rows ``[ptr[s], ptr[s+1])``); the
number of segments is ``len(ptr) - 1``. Sums accumulate in f32 and are cast
once to ``out_dtype``. On a CUDA tensor the kernel in ``csrc/segment.cu``
runs, for the dtype pairs of ``KERNEL_DTYPES`` (another pair raises), over
ranges of rows whose size :func:`range_geometry` picks; on a CPU tensor the
plain version below. The launch is two ``torch.library`` ops,
``chemprop_tpu_torch::seg_sum`` and ``::seg_sum_counts``.

Both entry points are differentiable in ``data`` (cf. the custom VJPs of
``sorted_segments.py``): the cotangent of a sum is the gather ``g[ids]``, a
plain indexing as in the JAX package, and for bfloat16 ``data`` the sum with
counts (the mean readout) expands it with the row-gather kernel of
``ops/gather.py``.

The kernel takes widths that are multiples of 4 columns, and bulk-copies a
range where a row is a multiple of 16 bytes. The atom-message table
``[H ; E]`` (``AtomMessagePassing``) is 384 + 14 columns wide: its caller
lays it out as ``[H ; E ; 0]`` to the next multiple of 8 columns (400, so
16-byte rows in both dtypes), and ``W_h`` takes zero rows at the pad, where
the JAX package sums the 314 unpadded columns. The zero columns sum to zero
and meet zero weights, so the real columns are JAX's; the kernel keeps one
width rule and its bulk copies, where teaching it odd widths would add a
second staging route for one caller.

:func:`segment_softmax_weights` is the attentive readout's softmax within
each segment, in plain PyTorch as the JAX package's is in plain ``jax.ops``
(its sums are one column wide: no kernel takes them)."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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
# the kernel's ranges: rows per range R, a power of two in [8, 64]: as many
# rows as RANGE_BYTES holds, or twice the mean segment's, whichever is more,
# so that a segment is rarely cut (a segment of more than R rows is summed in
# pieces), while two stages of up to 2R rows (a range ends at a cut) fit
# SMEM_BYTES. Stages: a block's ring of about RING_BYTES, so that two blocks
# share an SM's shared memory where the stages are small. FAN_IN: children
# of a node of the tree that adds a long segment's pieces
MIN_RANGE, MAX_RANGE = 8, 64
RANGE_BYTES = 24576
RING_BYTES = 98304
SMEM_BYTES = 200704
MIN_STAGES, MAX_STAGES = 2, 8
FAN_IN = 8
# the kernel's counters, one table per (device, stream): zero before every
# launch, and every launch leaves them zero
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


class RangeGeometry(NamedTuple):
    range_rows: int  # rows per range, R
    stages: int  # stages of a block's ring
    scratch_rows: int  # f32 rows of the scratch table: two slots per range
    counters: int  # ints of the counter table: two per range and level of the tree


@functools.lru_cache(maxsize=64)
def range_geometry(n_rows: int, n_seg: int, d: int, dtype: torch.dtype) -> RangeGeometry:
    """The kernel's ranges for ``n_rows`` rows of width ``d`` in ``dtype`` in
    ``n_seg`` segments. Rows whose bytes are not a multiple of 16 are not
    bulk-copied: the ring then holds only the ids."""
    row_bytes = d * dtype.itemsize
    mean = n_rows / max(n_seg, 1)
    r = MIN_RANGE
    while r < MAX_RANGE and (2 * r * row_bytes <= RANGE_BYTES or r < 2 * mean):
        r *= 2
    staged = row_bytes % 16 == 0
    while staged and r > MIN_RANGE and 2 * (2 * r * row_bytes) > SMEM_BYTES:
        r //= 2
    stage_bytes = 2 * r * row_bytes if staged else 0
    stages = MAX_STAGES if stage_bytes == 0 else RING_BYTES // stage_bytes
    stages = min(MAX_STAGES, max(MIN_STAGES, stages))
    n_ranges = -(-n_rows // r)
    levels = 1
    while FAN_IN**levels < n_ranges:
        levels += 1
    return RangeGeometry(r, stages, 2 * n_ranges, levels * 2 * n_ranges)


def sorted_segment_sum(
    data: torch.Tensor, ids: torch.Tensor, ptr: torch.Tensor, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """``[len(ptr) - 1, d]`` segment sums; ``out_dtype`` defaults to ``data``'s."""
    if torch.is_grad_enabled() and data.requires_grad:
        return _SegmentSum.apply(data, ids, ptr, out_dtype or data.dtype, False)[0]
    return _segment_sum(data, ids, ptr, out_dtype or data.dtype, False)[0]


def sorted_segment_sum_counts(
    data: torch.Tensor, ids: torch.Tensor, ptr: torch.Tensor, out_dtype: torch.dtype = torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Segment sums and the f32 row count of each segment."""
    if torch.is_grad_enabled() and data.requires_grad:
        return _SegmentSum.apply(data, ids, ptr, out_dtype, True)
    return _segment_sum(data, ids, ptr, out_dtype, True)


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
    if with_counts:
        return torch.ops.chemprop_tpu_torch.seg_sum_counts(data, ids, ptr, out_dtype)
    return torch.ops.chemprop_tpu_torch.seg_sum(data, ids, ptr, out_dtype), None


def _seg_sum_launch(data, ids, ptr, out_dtype, with_counts):
    """Kernel C on checked tables; on a CPU tensor the plain version."""
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
    out = torch.empty((n_seg, d), dtype=out_dtype, device=data.device)
    counts = torch.empty(n_seg, dtype=torch.float32, device=data.device) if with_counts else None
    if n_seg == 0:
        return out, counts
    geo = range_geometry(n, n_seg, d, data.dtype)
    scratch = torch.empty((geo.scratch_rows, d), dtype=torch.float32, device=data.device)
    call(
        library("segment"), "seg_sum", data, ids, ptr, out, counts, scratch,
        _counters(data.device, geo.counters), n, n_seg, d, geo.range_rows, geo.stages,
        DTYPES[data.dtype], DTYPES[out_dtype],
    )
    LAUNCHES["sorted_segment_sum"] += 1
    return out, counts


# kernel C as two ops, ``chemprop_tpu_torch::seg_sum`` and ``::seg_sum_counts``
@torch.library.custom_op("chemprop_tpu_torch::seg_sum", mutates_args=())
def _seg_sum_op(data: torch.Tensor, ids: torch.Tensor, ptr: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    return _seg_sum_launch(data, ids, ptr, out_dtype, False)[0]


@_seg_sum_op.register_fake
def _(data, ids, ptr, out_dtype):
    return data.new_empty((ptr.shape[0] - 1, data.shape[1]), dtype=out_dtype)


@torch.library.custom_op("chemprop_tpu_torch::seg_sum_counts", mutates_args=())
def _seg_sum_counts_op(data: torch.Tensor, ids: torch.Tensor, ptr: torch.Tensor,
                       out_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    return _seg_sum_launch(data, ids, ptr, out_dtype, True)


@_seg_sum_counts_op.register_fake
def _(data, ids, ptr, out_dtype):
    n_seg = ptr.shape[0] - 1
    return (data.new_empty((n_seg, data.shape[1]), dtype=out_dtype),
            data.new_empty((n_seg,), dtype=torch.float32))


def _counters(device: torch.device, size: int) -> torch.Tensor:
    """The kernel's counters for a launch on the current stream of ``device``:
    launches on one stream run one after another, and each leaves the
    counters zero for the next."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    table = _COUNTERS.get(key)
    if table is None or table.numel() < size:
        size = max(size, 0 if table is None else 2 * table.numel())
        table = _COUNTERS[key] = torch.zeros(size, dtype=torch.int32, device=device)
    return table


def sorted_segment_sum_info(
    n_rows: int, n_seg: int, d: int, dtype: torch.dtype, out_dtype: torch.dtype
) -> dict[str, int]:
    """The shape of the kernel's launch on the current card: rows per range,
    stages, shared memory per block, the grid, the blocks one SM runs at
    once, and whether the rows are bulk-copied."""
    geo = range_geometry(n_rows, n_seg, d, dtype)
    info = (ctypes.c_int * 4)()
    err = library("segment").seg_sum_info(n_rows, n_seg, d, geo.range_rows, geo.stages,
                                          DTYPES[dtype], DTYPES[out_dtype], info)
    if err != 0:
        raise RuntimeError(f"seg_sum_info: CUDA error {err}")
    return dict(range_rows=geo.range_rows, stages=geo.stages, smem_bytes=info[0], grid=info[1],
                blocks_per_sm=info[2], bulk_copied=bool(info[3]))


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


def segment_softmax_weights(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
                            ) -> torch.Tensor:
    """Per-segment softmax weights of ``[n, k]`` logits (cf.
    ``chemprop_tpu/ops/segment.py:segment_softmax_weights``): each segment's
    maximum is subtracted before the exponent, an empty segment's (``-inf``)
    counts as 0, and the denominator is floored at ``1e-12``. The maximum
    is a constant of the softmax, so no gradient flows through it, where the
    JAX package's flows through one and sums to zero."""
    idx = segment_ids.long()
    seg_max = logits.new_full((num_segments, logits.shape[1]), float("-inf")).scatter_reduce(
        0, idx[:, None].expand_as(logits), logits.detach(), "amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    expl = torch.exp(logits - seg_max[idx])
    denom = expl.new_zeros((num_segments, logits.shape[1])).index_add(0, idx, expl)
    return expl / denom[idx].clamp_min(1e-12)
