"""Bond (D-MPNN) message passing, for training and inference (cf.
``chemprop_tpu/nn/message_passing/base.py``):

    H0_e  = W_i([V[src_e] ; E_e])
    H_e   = tau(H0_e)
    H_e   = dropout(tau(H0_e + W_h M_e)),  M_e = sum_{k: dst_k = src_e} H_k - H_{rev(e)}
                                                    (depth - 1 times)
    M_v   = sum_{e: dst_e = v} H_e
    H_v   = dropout(tau(W_o([V_v ; M_v])))
    H_v   = dropout(W_d([H_v ; V_d_v]))                 (with atom descriptors)

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
``sorted_segment_sum``. With ``kernel_options.depth_loop`` and no dropout
drawn, the whole loop is one op that returns the last ``H``,
``ops.depth_loop``, taken before ``loop_readout`` as in the JAX package. All
four have hand-written backwards over the CUDA
kernels (``ops/message.py``); in float32 the products are ``torch.matmul``,
as JAX leaves them to XLA. Another activation, or ``undirected``, composes
``ops.message``, the products and ``sorted_segment_sum`` through autograd in
either dtype. Every message kernel takes the batch's tile table
(``bmg.tile_ptr``); where a molecule is larger than a tile, ``loop_readout``'s
backward kernels G and H take its split table (``bmg.split_ptr``,
``bmg.cross_rows``). With ``kernel_options.grad_w`` in bfloat16 W_i's weight
gradient, and W_h's where ``iter_bwd`` does not form it (the composed path's
included), are ``grad_weight`` kernel launches, as in the JAX package. The parameters stay float32 masters: the padded copies in the
compute dtype are made in every forward, so gradients flow through the pad
and the cast.

With ``kernel_options.window_gather`` in bfloat16, W_i's input gather ``V[src]``
is the ``row_gather`` kernel (``ops.gather``), whose zero rule (the last row
gives zeros) is exact only where the last node is padding: every padding edge
names it and no real edge does, as the collate guarantees. A batch without
that padding node takes the library gather and counts in
``UNSERVED["row_gather"]``. The kernel moves 16-byte chunks, so a node table
of another width (the 75 columns of a model with extra atom features) is
zero-padded to one for the gather and cut back after it.

Atom descriptors (``d_vd``) add ``W_d`` after ``W_o``, with no activation, as
in the JAX package. Its output is zero-padded to a multiple of 128 columns
(zero weight columns and a zero bias, exact), so that the node table keeps a
lane-padded width for the readout kernel; ``W_d``'s kernel takes zero rows at
the padding columns of ``W_o``'s output. ``V_d_transform`` and
``graph_transform`` scale ``V_d`` and the batch's feature tables at
evaluation (``nn.transforms``).

``taps``, a dict, collects the activations as the JAX package's
``intermediates`` collection does: ``H_0``, each iteration's ``H`` (the depth
loop's last one only) and ``M_v``, each a tuple of the padded tables; asking
for them turns ``loop_readout`` off."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from chemprop_tpu_torch.data.collate import BatchMolGraph
from chemprop_tpu_torch.nn.transforms import GraphTransform, ScaleTransform
from chemprop_tpu_torch.nn.utils import Dropout, get_activation_function
from chemprop_tpu_torch.ops.build import UNSERVED
from chemprop_tpu_torch.ops.gather import row_gather
from chemprop_tpu_torch.ops.grad_weight import matmul
from chemprop_tpu_torch.ops.message import (
    depth_loop, first_iter, loop_readout, message, message_iter,
)
from chemprop_tpu_torch.ops.options import KernelOptions
from chemprop_tpu_torch.ops.segment import sorted_segment_sum


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad a 2-d (or, with ``rows=0``, 1-d) tensor at its end."""
    if x.dim() == 1:
        return F.pad(x, (0, cols - x.shape[0]))
    return F.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


def _lane(d: int) -> int:
    return -(-d // 128) * 128


def _sow(taps: dict | None, name: str, value: torch.Tensor) -> None:
    if taps is not None:
        taps[name] = taps.get(name, ()) + (value,)


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
        d_vd: int | None = None,
        V_d_transform: ScaleTransform | None = None,
        graph_transform: GraphTransform | None = None,
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
        self.d_pad = _lane(d_h)
        self.W_i = nn.Linear(d_v + d_e, d_h, bias=bias)
        self.W_h = nn.Linear(d_h, d_h, bias=bias)
        self.W_o = nn.Linear(d_v + d_h, d_h, bias=True)
        self.d_vd = d_vd or None
        if self.d_vd:
            self.W_d = nn.Linear(d_h + d_vd, d_h + d_vd, bias=True)
        self.V_d_transform = V_d_transform
        self.graph_transform = graph_transform
        self.drop = Dropout(dropout)

    @property
    def output_dim(self) -> int:
        return self.d_h + (self.d_vd or 0)

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

    def _v_src(self, V: torch.Tensor, bmg: BatchMolGraph) -> torch.Tensor:
        """``V[src]``: with ``window_gather`` in bfloat16 the row gather kernel,
        where its zero rule is exact for the batch."""
        if self.kernel_options.window_gather and V.dtype == torch.bfloat16:
            if bmg.last_node_is_padding():
                d = V.shape[1]
                chunk = 16 // V.element_size()  # the kernel's rows are 16-byte chunks
                d_row = -(-d // chunk) * chunk
                if d_row == d:
                    return row_gather(V, bmg.src)
                return row_gather(_pad(V, V.shape[0], d_row), bmg.src)[:, :d]
            UNSERVED["row_gather"] += 1
        return V[bmg.src.long()]

    def _descriptors(self, H_v, V_d, is_training, drop_on, generator):
        """``dropout(W_d([H_v ; V_d]))`` at the lane-padded width."""
        dt, dh, dp = self.compute_dtype, self.d_h, self.d_pad
        if self.V_d_transform is not None:
            V_d = self.V_d_transform(V_d, is_training)
        out = _lane(self.output_dim)
        K = self.W_d.weight.t()
        K = torch.cat([_pad(K[:dh], dp, out), _pad(K[dh:], self.d_vd, out)]).to(dt)
        b = _pad(self.W_d.bias, 0, out).to(dt)
        x = torch.cat([H_v, V_d.to(dt)], dim=1)
        return self.drop(x @ K + b, drop_on, generator)

    def forward(
        self, bmg: BatchMolGraph, V_d: torch.Tensor | None = None, is_training: bool = False,
        mc_dropout: bool = False, generator: torch.Generator | None = None,
        taps: dict | None = None,
    ) -> torch.Tensor:
        """``[N_pad, d_out]`` node table in the compute dtype, ``d_out`` the
        output width lane-padded; columns past ``output_dim`` are zero.
        Dropout is drawn when ``is_training`` or ``mc_dropout`` (Monte-Carlo
        dropout: the dropout layers alone), from ``generator``; the transforms
        scale at evaluation (not ``is_training``). ``V_d``: the
        ``[N_pad, d_vd]`` atom descriptors, required with ``d_vd``."""
        dt, dp, opts = self.compute_dtype, self.d_pad, self.kernel_options
        drop_on = (is_training or mc_dropout) and self.dropout > 0
        if (V_d is None) != (self.d_vd is None):
            raise ValueError("V_d must be given exactly when d_vd is configured")
        if self.graph_transform is not None:
            bmg = self.graph_transform(bmg, is_training)
        # with grad_w in bfloat16, [V[src] ; E] is zero-padded to a multiple of
        # 128 columns and W_i's kernel takes zero rows there, as the JAX package
        # pads them, so that dW_i = x^T g streams through the grad_weight kernel
        # (the composed path's W_h takes the same rule)
        gw_i = opts.grad_w and dt == torch.bfloat16
        d_in = self.d_v + self.d_e
        d_x = _lane(d_in) if gw_i else d_in
        W_i, b_i = self._padded(self.W_i, d_x, dp)
        V = bmg.V.to(dt)
        parts = [self._v_src(V, bmg), bmg.E.to(dt)]
        if d_x != d_in:
            parts.append(bmg.E.new_zeros((bmg.E.shape[0], d_x - d_in), dtype=dt))
        x = torch.cat(parts, dim=1)
        H0 = matmul(x, W_i, use_kernel=True) if gw_i else x @ W_i
        if b_i is not None:
            H0 = H0 + b_i
        _sow(taps, "H_0", H0)

        graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
        fuse_iter = self.depth > 1 and self.activation == "relu" and not self.undirected
        if self.depth > 1:
            W_h, b_h = self._padded(self.W_h, dp, dp)
        if fuse_iter and opts.depth_loop and not drop_on:
            H = depth_loop(H0, W_h, b_h, *graph, self.depth, opts, bmg.tile_ptr)
            _sow(taps, "H", H)
            M_v = sorted_segment_sum(H, bmg.dst, bmg.edge_ptr)
        elif (fuse_iter and self.depth >= 3 and not drop_on and opts.fused_readout
              and taps is None):
            split = None if bmg.split_ptr is None else (bmg.split_ptr, bmg.cross_rows)
            M_v = loop_readout(H0, W_h, b_h, *graph, self.depth, opts, bmg.tile_ptr, split)
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
                _sow(taps, "H", H)
            M_v = sorted_segment_sum(H.contiguous(), bmg.dst, bmg.edge_ptr)
        _sow(taps, "M_v", M_v)
        # M_v's padding columns sit at the end of [V ; M_v], so W_o's kernel
        # takes zero rows there and zero columns past d_h
        W_o, b_o = self._padded(self.W_o, self.d_v + dp, dp)
        VM = torch.cat([V, M_v], dim=1)
        H_v = self.drop(self.tau(VM @ W_o + b_o), drop_on, generator)
        if V_d is not None:
            H_v = self._descriptors(H_v, V_d, is_training, drop_on, generator)
        return H_v
