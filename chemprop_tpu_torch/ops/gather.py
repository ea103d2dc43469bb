"""Row gather with a zero rule (cf. ``chemprop_tpu/ops/window_gather.py``):

    out[j] = M[ids[j]],   and the sacrificial id ``len(M) - 1`` gives zeros

It expands the mean readout's graph cotangent to the node table: padding
nodes belong to the sacrificial graph, the last row, whose cotangent is zero
by construction. On a CUDA tensor the kernel in ``csrc/gather.cu`` runs; on a
CPU tensor the plain version below."""

from __future__ import annotations

import torch

from chemprop_tpu_torch.ops.build import LAUNCHES, call, library


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
