"""The weight gradient of a dense layer over a tall table (cf.
``chemprop_tpu/ops/grad_weight.py``):

    grad_weight(X, G) = X^T G      [n, dx]^T [n, dg] -> [dx, dg], float32

with f32 accumulation whatever the tables' dtype. With ``use_kernel`` the
hand-written kernel of ``csrc/grad_weight.cu`` runs on a CUDA tensor
(bfloat16 tables, ``dx`` and ``dg`` multiples of 128; anything else raises)
and the plain version below on a CPU tensor; without it the product is one
library call, as the JAX package leaves it to XLA by default. The kernel
splits the rows over blocks and adds the splits' partial sums in a fixed
order, so it gives the same bits in every run."""

from __future__ import annotations

import functools

import torch

from chemprop_tpu_torch.ops.build import LAUNCHES, call, library


def grad_weight_plain(X: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel."""
    return X.float().t() @ G.float()


@functools.lru_cache(maxsize=64)
def _splits(lib, n: int, dx: int, dg: int) -> int:
    """The kernel's partial sums for these shapes, fixed for the card."""
    return lib.grad_weight_splits(n, dx, dg)


def grad_weight(X: torch.Tensor, G: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """``X^T G`` as float32."""
    if X.dim() != 2 or G.dim() != 2 or X.shape[0] != G.shape[0] or X.device != G.device:
        raise ValueError(f"X {tuple(X.shape)} and G {tuple(G.shape)} must share rows and device")
    if not use_kernel:
        if X.dtype == G.dtype == torch.bfloat16 and X.device.type == "cuda":
            return torch.mm(X.t(), G, out_dtype=torch.float32)
        return grad_weight_plain(X, G)
    if X.dtype != torch.bfloat16 or G.dtype != torch.bfloat16:
        raise TypeError(f"the grad_weight kernel takes bfloat16 tables, got {X.dtype}, {G.dtype}")
    (n, dx), dg = X.shape, G.shape[1]
    if dx % 128 != 0 or dg % 128 != 0:
        raise ValueError(f"widths {dx} and {dg} must be multiples of 128")
    if not X.is_contiguous() or not G.is_contiguous():
        raise ValueError("X and G must be contiguous")
    if X.device.type == "cpu":
        return grad_weight_plain(X, G)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if X.data_ptr() % 16 != 0 or G.data_ptr() % 16 != 0:
        raise ValueError("grad_weight needs 16-byte aligned tables")
    lib = library("grad_weight")
    # the output, then the kernel's partial sums, in one allocation
    buf = torch.empty((1 + _splits(lib, n, dx, dg), dx, dg), dtype=torch.float32, device=X.device)
    call(lib, "grad_weight", X, G, buf.data_ptr() + dx * dg * 4, buf, n, dx, dg)
    LAUNCHES["grad_weight"] += 1
    return buf[0]


def matmul(x: torch.Tensor, k: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """``x @ k`` whose kernel gradient ``x^T g`` goes through
    :func:`grad_weight`; the forward and the data gradient ``g @ k^T`` are
    library products. A drop-in for the product of a dense layer."""
    return _MatMul.apply(x, k, use_kernel)


class _MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, use_kernel):
        ctx.save_for_backward(x, k)
        ctx.use_kernel = use_kernel
        return x @ k

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        xf = x.reshape(-1, x.shape[-1]).contiguous()
        gf = g.reshape(-1, g.shape[-1]).contiguous()
        dx = g @ k.t() if ctx.needs_input_grad[0] else None
        return dx, grad_weight(xf, gf, ctx.use_kernel).to(k.dtype), None
