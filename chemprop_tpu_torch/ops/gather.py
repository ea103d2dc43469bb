"""Row gather with a zero rule (cf. ``chemprop_tpu/ops/window_gather.py``):

    out[j] = M[ids[j]],   and the sacrificial id ``len(M) - 1`` gives zeros

It expands the mean readout's graph cotangent to the node table: padding
nodes belong to the sacrificial graph, the last row, whose cotangent is zero
by construction. On a CUDA tensor the kernel in ``csrc/gather.cu`` runs; on a
CPU tensor the plain version below; the launch is the ``torch.library`` op
``chemprop_tpu_torch::row_gather``.

:func:`gather_src` and :func:`gather_rev` are the edge gathers of atom
message passing with the JAX package's scatter-free transposes
(``chemprop_tpu/ops/gather.py``). Every edge ``e`` has a reverse ``rev[e]``
with ``src[e] == dst[rev[e]]`` and ``rev[rev[e]] == e`` (the identity on
padding, whose edges run from the last node to itself), so

* the transpose of ``M[src]`` is the sorted segment sum by ``dst`` of
  ``g[rev]``: kernel C over the edges' CSR pointers;
* the transpose of ``H[rev]`` is the gather ``g[rev]``: in bfloat16 the row
  gather above, whose zero rule takes the last row, a padding edge read only
  by itself, whose cotangent is zero (a padding edge feeds only the
  sacrificial node and graph); where the batch has no padding edge it is a
  library gather, counted in ``UNSERVED["row_gather"]``.

No backward runs a generic scatter."""

from __future__ import annotations

import torch

from chemprop_tpu_torch.ops.build import LAUNCHES, UNSERVED, call, library


def row_gather_plain(M: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel."""
    out = M[ids.long()]
    out.masked_fill_((ids == M.shape[0] - 1)[:, None], 0)
    return out


def row_gather(M: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``[len(ids), d]`` rows of the ``[m, d]`` table ``M``; rows whose id is
    ``m - 1`` are zero. A row must be a multiple of 16 bytes on the card."""
    if M.dim() != 2 or not M.is_contiguous() or M.shape[0] < 1:
        raise ValueError("M must be a contiguous [m, d] table with at least one row")
    if ids.dtype != torch.int32 or ids.dim() != 1 or ids.device != M.device:
        raise ValueError(f"ids must be a 1-d int32 tensor on {M.device}")
    return torch.ops.chemprop_tpu_torch.row_gather(M, ids)


@torch.library.custom_op("chemprop_tpu_torch::row_gather", mutates_args=())
def _row_gather_op(M: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Kernel I as an op (checked by :func:`row_gather`); on a CPU tensor the
    plain version."""
    if M.device.type == "cpu":
        return row_gather_plain(M, ids)
    if M.device.type != "cuda":
        raise ValueError(f"unsupported device {M.device}")
    row_bytes = M.shape[1] * M.element_size()
    if row_bytes % 16 != 0 or M.data_ptr() % 16 != 0:
        raise ValueError(f"rows of {row_bytes} bytes: the kernel needs a multiple of 16, aligned")
    out = torch.empty((ids.numel(), M.shape[1]), dtype=M.dtype, device=M.device)
    call(library("gather"), "row_gather", M, ids.contiguous(), out, ids.numel(), M.shape[0],
         row_bytes)
    LAUNCHES["row_gather"] += 1
    return out


@_row_gather_op.register_fake
def _(M, ids):
    return M.new_empty((ids.shape[0], M.shape[1]))


def gather_src(M: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, rev: torch.Tensor,
               edge_ptr: torch.Tensor) -> torch.Tensor:
    """``M[src]`` for a ``[n_nodes, d]`` node table, differentiable in ``M``:
    its backward is kernel C by ``dst`` (``edge_ptr`` its CSR pointers) of
    the cotangent gathered by ``rev``, in the cotangent's dtype."""
    return _GatherSrc.apply(M, src, dst, rev, edge_ptr)


def gather_rev(H: torch.Tensor, rev: torch.Tensor, last_edge_padding: bool) -> torch.Tensor:
    """``H[rev]`` for an ``[n_edges, d]`` edge table, differentiable in ``H``;
    its backward gathers by ``rev`` again. ``last_edge_padding`` says that
    the last row is a padding edge (the row gather's zero rule is then
    exact)."""
    return _GatherRev.apply(H, rev, last_edge_padding)


class _GatherSrc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, M, src, dst, rev, edge_ptr):
        ctx.save_for_backward(dst, rev, edge_ptr)
        return M[src.long()]

    @staticmethod
    def backward(ctx, g):
        from chemprop_tpu_torch.ops.segment import sorted_segment_sum

        dst, rev, edge_ptr = ctx.saved_tensors
        return sorted_segment_sum(g[rev.long()], dst, edge_ptr, g.dtype), None, None, None, None


class _GatherRev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H, rev, last_edge_padding):
        ctx.save_for_backward(rev)
        ctx.last_edge_padding = last_edge_padding
        return H[rev.long()]

    @staticmethod
    def backward(ctx, g):
        (rev,) = ctx.saved_tensors
        if g.dtype == torch.bfloat16:
            if ctx.last_edge_padding:
                return row_gather(g.contiguous(), rev), None, None
            UNSERVED["row_gather"] += 1
        return g[rev.long()], None, None
