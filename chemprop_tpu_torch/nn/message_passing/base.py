"""Bond (D-MPNN) message passing, for training and inference (cf.
``chemprop_tpu/nn/message_passing/base.py``):

    H0_e  = W_i([V[src_e] ; E_e])
    H_e   = tau(H0_e)
    H_e   = dropout(tau(H0_e + W_h M_e)),  M_e = sum_{k: dst_k = src_e} H_k - H_{rev(e)}
                                                    (depth - 1 times)
    M_v   = sum_{e: dst_e = v} H_e
    H_v   = dropout(tau(W_o([V_v ; M_v])))

With ``undirected`` every iteration first averages each edge's state with its
reverse's, ``H = (H + H[rev]) / 2``.

The edge tables keep the JAX layout: the hidden width ``d_h`` is zero-padded
to a multiple of 128 (300 -> 384), with zero weight columns, so the kernels
see the reference's shapes and the padding columns stay exact zeros. The
dispatch is the JAX package's. With ReLU, directed edges and ``depth >= 2``
the iterations run fused: where nothing needs their outputs (``depth >= 3``,
no dropout drawn in this call, ``kernel_options.fused_readout``) the whole
depth loop and the ``M_v`` readout are one differentiable op,
``ops.loop_readout``; otherwise each iteration is one op, ``ops.first_iter``
then ``ops.message_iter``, with the dropout between them, and ``M_v`` a
``sorted_segment_sum``. All three have hand-written backwards over the CUDA
kernels (``ops/message.py``); in float32 the products are ``torch.matmul``,
as JAX leaves them to XLA. Another activation, or ``undirected``, composes
``ops.message``, the products and ``sorted_segment_sum`` through autograd in
either dtype. Every message kernel takes the batch's tile table
(``bmg.tile_ptr``). With ``kernel_options.grad_w`` in bfloat16 W_i's weight
gradient, and W_h's where ``iter_bwd`` does not form it (the composed path's
included), are ``grad_weight`` kernel launches, as in the JAX package. The parameters stay float32 masters: the padded copies in the
compute dtype are made in every forward, so gradients flow through the pad
and the cast."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from chemprop_tpu_torch.data.collate import BatchMolGraph
from chemprop_tpu_torch.nn.utils import Dropout, get_activation_function
from chemprop_tpu_torch.ops.grad_weight import matmul
from chemprop_tpu_torch.ops.message import first_iter, loop_readout, message, message_iter
from chemprop_tpu_torch.ops.options import KernelOptions
from chemprop_tpu_torch.ops.segment import sorted_segment_sum


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad a 2-d (or, with ``rows=0``, 1-d) tensor at its end."""
    if x.dim() == 1:
        return F.pad(x, (0, cols - x.shape[0]))
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


class BondMessagePassing(nn.Module):
    """Parameters in ``torch.nn.Linear`` layout under the reference's names
    (``W_i``, ``W_h``, ``W_o``), so a reference state dict loads as it is.
    ``kernel_options`` selects the opt-in kernels; None reads the JAX
    package's environment variables once, here."""

    def __init__(
        self,
        d_v: int = 72,
        d_e: int = 14,
        d_h: int = 300,
        bias: bool = False,
        depth: int = 3,
        activation: str = "relu",
        compute_dtype: torch.dtype = torch.float32,
        dropout: float = 0.0,
        undirected: bool = False,
        kernel_options: KernelOptions | None = None,
    ):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {compute_dtype}")
        self.d_v, self.d_e, self.d_h, self.depth = d_v, d_e, d_h, depth
        self.activation = activation.lower()
        self.tau = get_activation_function(activation)
        self.compute_dtype = compute_dtype
        self.undirected = undirected
        self.kernel_options = kernel_options or KernelOptions.from_env()
        self.d_pad = -(-d_h // 128) * 128
        self.W_i = nn.Linear(d_v + d_e, d_h, bias=bias)
        self.W_h = nn.Linear(d_h, d_h, bias=bias)
        self.W_o = nn.Linear(d_v + d_h, d_h, bias=True)
        self.drop = Dropout(dropout)

    @property
    def output_dim(self) -> int:
        return self.d_h

    @property
    def dropout(self) -> float:
        return self.drop.rate

    def _padded(self, layer: nn.Linear, rows: int, cols: int):
        """``layer`` as an (in, out) kernel zero-padded to ``rows x cols``, and
        its bias padded to ``cols``, in the compute dtype."""
        dt = self.compute_dtype
        W = _pad(layer.weight.t(), rows, cols).to(dt).contiguous()
        b = None if layer.bias is None else _pad(layer.bias, 0, cols).to(dt).contiguous()
        return W, b

    def forward(
        self, bmg: BatchMolGraph, is_training: bool = False, mc_dropout: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """``[N_pad, d_pad]`` node table in the compute dtype; columns past
        ``d_h`` are zero. Dropout is drawn when ``is_training`` or
        ``mc_dropout`` (Monte-Carlo dropout: the dropout layers alone), from
        ``generator``."""
        dt, dp, opts = self.compute_dtype, self.d_pad, self.kernel_options
        drop_on = (is_training or mc_dropout) and self.dropout > 0
        # with grad_w in bfloat16, [V[src] ; E] is zero-padded to a multiple of
        # 128 columns and W_i's kernel takes zero rows there, as the JAX package
        # pads them, so that dW_i = x^T g streams through the grad_weight kernel
        # (the composed path's W_h takes the same rule)
        gw_i = opts.grad_w and dt == torch.bfloat16
        d_in = self.d_v + self.d_e
        d_x = -(-d_in // 128) * 128 if gw_i else d_in
        W_i, b_i = self._padded(self.W_i, d_x, dp)
        parts = [bmg.V.to(dt)[bmg.src.long()], bmg.E.to(dt)]
        if d_x != d_in:
            parts.append(bmg.E.new_zeros((bmg.E.shape[0], d_x - d_in), dtype=dt))
        x = torch.cat(parts, dim=1)
        H0 = matmul(x, W_i, use_kernel=True) if gw_i else x @ W_i
        if b_i is not None:
            H0 = H0 + b_i

        graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
        fuse_iter = self.depth > 1 and self.activation == "relu" and not self.undirected
        if self.depth > 1:
            W_h, b_h = self._padded(self.W_h, dp, dp)
        if fuse_iter and self.depth >= 3 and not drop_on and opts.fused_readout:
            M_v = loop_readout(H0, W_h, b_h, *graph, self.depth, opts, bmg.tile_ptr)
        else:
            H = self.tau(H0)
            for it in range(1, self.depth):
                if self.undirected:
                    H = (H + H[bmg.rev.long()]) / 2
                if fuse_iter:
                    if it == 1:  # relu(H0) streams through the kernel, never written
                        H = first_iter(H0, W_h, b_h, *graph, opts, bmg.tile_ptr)
                    else:
                        H = message_iter(H, H0, W_h, b_h, *graph, opts, bmg.tile_ptr)
                else:
                    M = message(H, *graph, bmg.tile_ptr)
                    z = matmul(M, W_h, use_kernel=True) if gw_i else M @ W_h
                    if b_h is not None:
                        z = z + b_h
                    H = self.tau(H0 + z)
                H = self.drop(H, drop_on, generator)
            M_v = sorted_segment_sum(H.contiguous(), bmg.dst, bmg.edge_ptr)
        # M_v's padding columns sit at the end of [V ; M_v], so W_o's kernel
        # takes zero rows there and zero columns past d_h
        W_o, b_o = self._padded(self.W_o, self.d_v + dp, dp)
        VM = torch.cat([bmg.V.to(dt), M_v], dim=1)
        return self.drop(self.tau(VM @ W_o + b_o), drop_on, generator)
