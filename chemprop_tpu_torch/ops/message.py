"""The D-MPNN message and the fused depth iteration (cf.
``chemprop_tpu/ops/fused_message.py``):

    message:     M[e] = sum_{k : dst[k] == src[e]} H[k] - H[rev[e]]
    fused_iter:  y[e] = relu(H0[e] + bf16(M[e]) @ W [+ b])

Edges are sorted by ``dst`` and ``ptr`` is the CSR of ``dst`` (the in-edges
of node ``v`` are rows ``[ptr[v], ptr[v+1])``). Padding edges (``src`` is the
padding node, the last one) get a zero message, so their rows differ from
the JAX kernels', which leave garbage there; no real row depends on them.
On a CUDA tensor the kernels in ``csrc/message.cu`` run; on a CPU tensor the
plain versions below."""

from __future__ import annotations

import torch

from chemprop_tpu_torch.ops.build import LAUNCHES, call, library
from chemprop_tpu_torch.ops.segment import DTYPES


def message_plain(
    H: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version of the message kernel: f32 sums, one cast."""
    n_nodes = ptr.numel() - 1
    Hf = H.float()
    M_node = torch.zeros((n_nodes, H.shape[1]), dtype=torch.float32, device=H.device)
    M_node.index_add_(0, dst.long(), Hf)
    M = M_node[src.long()] - Hf[rev.long()]
    M.masked_fill_((src == n_nodes - 1)[:, None], 0.0)
    return M.to(H.dtype)


def fused_iter_plain(
    H: torch.Tensor,
    H0: torch.Tensor,
    W: torch.Tensor,
    b: torch.Tensor | None,
    src: torch.Tensor,
    dst: torch.Tensor,
    rev: torch.Tensor,
    ptr: torch.Tensor,
    relu_stream: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of the fused iteration: the bf16 message
    times W with f32 accumulation, then H0, the bias and the ReLU in f32."""
    M = message_plain(H.clamp_min(0) if relu_stream else H, src, dst, rev, ptr)
    z = M.float() @ W.float()
    if b is not None:
        z = z + b.float()
    return torch.relu(H0.float() + z).to(H.dtype)


def _check_graph(H, src, dst, rev, ptr):
    if H.dim() != 2 or not H.is_contiguous():
        raise ValueError("H must be a contiguous [E, d] table")
    n = H.shape[0]
    for name, t in (("src", src), ("dst", dst), ("rev", rev), ("ptr", ptr)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.device != H.device:
            raise ValueError(f"{name} must be a 1-d int32 tensor on {H.device}")
    if not (src.numel() == dst.numel() == rev.numel() == n) or ptr.numel() < 2:
        raise ValueError("src/dst/rev must have one entry per edge row, ptr at least two")
    if H.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {H.device}")


def message(
    H: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor
) -> torch.Tensor:
    """``M = message(H)`` for a float32 or bfloat16 edge table. The kernel is
    float32 only (the bfloat16 forward forms its messages in
    :func:`fused_iter`), so a bfloat16 table on the card raises."""
    _check_graph(H, src, dst, rev, ptr)
    if H.dtype not in DTYPES:
        raise TypeError(f"H must be float32 or bfloat16, got {H.dtype}")
    if H.device.type == "cpu":
        return message_plain(H, src, dst, rev, ptr)
    if H.dtype != torch.float32:
        raise TypeError(f"the message kernel takes float32, got {H.dtype}")
    n, d = H.shape
    if d % 4 != 0 or H.data_ptr() % 16 != 0:
        raise ValueError(f"width {d} must be a multiple of 4, rows 16-byte aligned")
    out = torch.empty_like(H)
    call(
        library("message"), "plain_message", H, src.contiguous(), rev.contiguous(),
        ptr.contiguous(), out, n, d, ptr.numel() - 2,
    )
    LAUNCHES["message"] += 1
    return out


def fused_iter(
    H: torch.Tensor,
    H0: torch.Tensor,
    W: torch.Tensor,
    b: torch.Tensor | None,
    src: torch.Tensor,
    dst: torch.Tensor,
    rev: torch.Tensor,
    ptr: torch.Tensor,
    relu_stream: bool = False,
) -> torch.Tensor:
    """One bfloat16 depth iteration ``relu(H0 + message(H) @ W [+ b])``.
    ``relu_stream`` applies the ReLU to the gathered rows of ``H`` (the first
    iteration passes ``H = H0``); the residual always adds raw ``H0``. ``W``
    is ``[d, d]`` in (in, out) layout, ``d`` a multiple of 128."""
    _check_graph(H, src, dst, rev, ptr)
    n, d = H.shape
    if H.dtype != torch.bfloat16 or H0.dtype != torch.bfloat16 or W.dtype != torch.bfloat16:
        raise TypeError("fused_iter takes bfloat16 H, H0 and W")
    if H0.shape != H.shape or W.shape != (d, d) or d % 128 != 0:
        raise ValueError(f"H0 {tuple(H0.shape)} / W {tuple(W.shape)} do not fit H {(n, d)}")
    if b is not None and (b.dtype != torch.bfloat16 or b.shape != (d,)):
        raise ValueError("b must be a bfloat16 [d] vector")
    tensors = [H0, W] + ([b] if b is not None else [])
    if any(t.device != H.device or not t.is_contiguous() for t in tensors):
        raise ValueError("H0, W and b must be contiguous and on H's device")
    if H.device.type == "cpu":
        return fused_iter_plain(H, H0, W, b, src, dst, rev, ptr, relu_stream)
    if any(t.data_ptr() % 16 != 0 for t in [H] + tensors):
        raise ValueError("fused_iter needs 16-byte aligned tables")
    y = torch.empty_like(H)
    call(
        library("message"), "fused_iter", H, H0, W, b, src.contiguous(), rev.contiguous(),
        ptr.contiguous(), y, n, d, ptr.numel() - 2, int(relu_stream),
    )
    LAUNCHES["fused_iter"] += 1
    return y
