"""Bond (D-MPNN) message passing, for training and inference (cf.
``chemprop_tpu/nn/message_passing/base.py``):

    H0_e  = W_i([V[src_e] ; E_e])
    H_e   = relu(H0_e)
    H_e   = relu(H0_e + W_h M_e),  M_e = sum_{k: dst_k = src_e} H_k - H_{rev(e)}
                                                    (depth - 1 times)
    M_v   = sum_{e: dst_e = v} H_e
    H_v   = relu(W_o([V_v ; M_v]))

The edge tables keep the JAX layout: the hidden width ``d_h`` is zero-padded
to a multiple of 128 (300 -> 384), with zero weight columns, so the kernels
see the reference's shapes and the padding columns stay exact zeros. The
dispatch mirrors the JAX package's. With ReLU and ``depth >= 2`` the whole
depth loop and the ``M_v`` readout are one differentiable op,
``ops.loop_readout``, whose backward is written by hand: in bfloat16 every
iteration is one ``fused_iter`` kernel (the first with ``relu_stream``) and
the backward runs the node-cotangent and the premultiplied kernels; in
float32 the message kernel runs and ``W_h`` is a ``torch.matmul``, as JAX
leaves that product to XLA, and the backward is the per-iteration chain
through ``bwd_message`` (so is a bias, or depth 2, in either dtype). Another
activation composes ``message``, the products and ``sorted_segment_sum``
through autograd. The parameters stay float32 masters: the padded copies in
the compute dtype are made in every forward, so gradients flow through the
pad and the cast. Dropout inside message passing is not ported yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from chemprop_tpu_torch.data.collate import BatchMolGraph
from chemprop_tpu_torch.nn.utils import get_activation_function
from chemprop_tpu_torch.ops.message import loop_readout, message
from chemprop_tpu_torch.ops.segment import sorted_segment_sum


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad a 2-d (or, with ``rows=0``, 1-d) tensor at its end."""
    if x.dim() == 1:
        return F.pad(x, (0, cols - x.shape[0]))
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


class BondMessagePassing(nn.Module):
    """Parameters in ``torch.nn.Linear`` layout under the reference's names
    (``W_i``, ``W_h``, ``W_o``), so a reference state dict loads as it is."""

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
    ):
        super().__init__()
        if dropout > 0:
            raise NotImplementedError("dropout inside message passing is not ported yet")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {compute_dtype}")
        self.d_v, self.d_e, self.d_h, self.depth = d_v, d_e, d_h, depth
        self.activation = activation.lower()
        self.tau = get_activation_function(activation)
        self.compute_dtype = compute_dtype
        self.d_pad = -(-d_h // 128) * 128
        self.W_i = nn.Linear(d_v + d_e, d_h, bias=bias)
        self.W_h = nn.Linear(d_h, d_h, bias=bias)
        self.W_o = nn.Linear(d_v + d_h, d_h, bias=True)

    @property
    def output_dim(self) -> int:
        return self.d_h

    def _padded(self, layer: nn.Linear, rows: int, cols: int):
        """``layer`` as an (in, out) kernel zero-padded to ``rows x cols``, and
        its bias padded to ``cols``, in the compute dtype."""
        dt = self.compute_dtype
        W = _pad(layer.weight.t(), rows, cols).to(dt).contiguous()
        b = None if layer.bias is None else _pad(layer.bias, 0, cols).to(dt).contiguous()
        return W, b

    def forward(self, bmg: BatchMolGraph) -> torch.Tensor:
        """``[N_pad, d_pad]`` node table in the compute dtype; columns past
        ``d_h`` are zero."""
        dt, dp = self.compute_dtype, self.d_pad
        W_i, b_i = self._padded(self.W_i, self.d_v + self.d_e, dp)
        x = torch.cat([bmg.V.to(dt)[bmg.src.long()], bmg.E.to(dt)], dim=1)
        H0 = x @ W_i
        if b_i is not None:
            H0 = H0 + b_i

        graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
        if self.depth > 1:
            W_h, b_h = self._padded(self.W_h, dp, dp)
        if self.depth > 1 and self.activation == "relu":
            M_v = loop_readout(H0, W_h, b_h, *graph, self.depth)
        else:
            H = self.tau(H0)
            for _ in range(1, self.depth):
                z = message(H, *graph) @ W_h
                if b_h is not None:
                    z = z + b_h
                H = self.tau(H0 + z)
            M_v = sorted_segment_sum(H, bmg.dst, bmg.edge_ptr)
        # M_v's padding columns sit at the end of [V ; M_v], so W_o's kernel
        # takes zero rows there and zero columns past d_h
        W_o, b_o = self._padded(self.W_o, self.d_v + dp, dp)
        VM = torch.cat([bmg.V.to(dt), M_v], dim=1)
        return self.tau(VM @ W_o + b_o)
