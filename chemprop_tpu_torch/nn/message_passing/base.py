"""Bond (D-MPNN) and atom message passing, for training and inference (cf.
``chemprop_tpu/nn/message_passing/base.py``); ``AtomMessagePassing`` at the
end of the file says what it does otherwise. Bond message passing:

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
(``bmg.tile_ptr``); where a molecule is larger than a tile, every route hands
every tile kernel its split table and row lists instead (``bmg.split_ptr``
with ``bmg.cross_rows`` for A, F, G, H and E, with ``bmg.y1_rows`` and
``bmg.y2_rows`` for D).
With ``kernel_options.grad_w`` in bfloat16 W_i's weight gradient, and W_h's
where ``iter_bwd`` does not form it (the composed path's included), are
``grad_weight`` kernel launches, as in the JAX package. The parameters stay
float32 masters: the padded copies in the compute dtype are made in every
forward, so gradients flow through the pad and the cast.

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
from chemprop_tpu_torch.ops.gather import gather_rev, gather_src, row_gather
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


class _MessagePassingBase(nn.Module):
    """Parameters in ``torch.nn.Linear`` layout under the reference's names
    (``W_i``, ``W_h``, ``W_o``), so a reference state dict loads as it is.
    ``kernel_options`` selects the opt-in kernels; None reads the JAX
    package's environment variables once, here. A subclass sets the input
    widths of ``W_i`` and ``W_h`` (``_input_widths``) and the forward."""

    @staticmethod
    def _input_widths(d_v: int, d_e: int, d_h: int) -> tuple[int, int]:
        raise NotImplementedError

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
        d_i, d_hin = self._input_widths(d_v, d_e, d_h)
        self.W_i = nn.Linear(d_i, d_h, bias=bias)
        self.W_h = nn.Linear(d_hin, d_h, bias=bias)
        self.d_vd = d_vd or None
        self._output_layers()
        self.V_d_transform = V_d_transform
        self.graph_transform = graph_transform
        self.drop = Dropout(dropout)

    def _output_layers(self) -> None:
        """The node output's layers: ``W_o`` on ``[V ; M_v]`` and, with atom
        descriptors, ``W_d``."""
        self.W_o = nn.Linear(self.d_v + self.d_h, self.d_h, bias=True)
        if self.d_vd:
            self.W_d = nn.Linear(self.d_h + self.d_vd, self.d_h + self.d_vd, bias=True)

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

    def _descriptors(self, H, X, layer, transform, is_training, drop_on, generator):
        """``dropout(layer([H ; X]))`` at the lane-padded width: ``H`` is a
        lane-padded table of ``d_h`` real columns, ``X`` its descriptors
        (scaled by ``transform`` at evaluation)."""
        dt, dh, dp = self.compute_dtype, self.d_h, self.d_pad
        if transform is not None:
            X = transform(X, is_training)
        out = _lane(layer.out_features)
        K = layer.weight.t()
        K = torch.cat([_pad(K[:dh], dp, out), _pad(K[dh:], X.shape[1], out)]).to(dt)
        b = _pad(layer.bias, 0, out).to(dt)
        x = torch.cat([H, X.to(dt)], dim=1)
        return self.drop(x @ K + b, drop_on, generator)

    def _prologue(self, bmg, V_d, is_training, mc_dropout):
        """The forward's checks, the graph transform and whether dropout is
        drawn."""
        if (V_d is None) != (self.d_vd is None):
            raise ValueError("V_d must be given exactly when d_vd is configured")
        if self.graph_transform is not None:
            bmg = self.graph_transform(bmg, is_training)
        return bmg, (is_training or mc_dropout) and self.dropout > 0

    def _node_output(self, V, M_v, V_d, is_training, drop_on, generator, W_o=None, W_d=None):
        """``H_v = dropout(tau(W_o([V ; M_v])))`` at the lane-padded width,
        then the atom descriptors' layer ``W_d`` (the module's own two by
        default)."""
        # M_v's padding columns sit at the end of [V ; M_v], so W_o's kernel
        # takes zero rows there and zero columns past d_h
        W_o, b_o = self._padded(W_o or self.W_o, self.d_v + self.d_pad, self.d_pad)
        VM = torch.cat([V, M_v], dim=1)
        H_v = self.drop(self.tau(VM @ W_o + b_o), drop_on, generator)
        if V_d is not None:
            H_v = self._descriptors(H_v, V_d, W_d or self.W_d, self.V_d_transform, is_training,
                                    drop_on, generator)
        return H_v


class BondMessagePassing(_MessagePassingBase):
    @staticmethod
    def _input_widths(d_v: int, d_e: int, d_h: int) -> tuple[int, int]:
        return d_v + d_e, d_h

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
        bmg, drop_on = self._prologue(bmg, V_d, is_training, mc_dropout)
        H, M_v = self._edge_states(bmg, drop_on, generator, taps, readout=True)
        if M_v is None:
            M_v = sorted_segment_sum(H.contiguous(), bmg.dst, bmg.edge_ptr)
        _sow(taps, "M_v", M_v)
        return self._node_output(bmg.V.to(self.compute_dtype), M_v, V_d, is_training, drop_on,
                                 generator)

    def _edge_states(self, bmg, drop_on, generator, taps, readout: bool):
        """``(H, None)``, the last iteration's lane-padded edge states, or
        ``(None, M_v)`` where ``readout`` lets the depth loop and the ``M_v``
        readout be one op (``ops.loop_readout``), whose backward takes the
        cotangent of ``M_v`` alone."""
        dt, dp, opts = self.compute_dtype, self.d_pad, self.kernel_options
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
        # the tile table, or where the batch has none its split table and row lists
        tiles, split = bmg.tile_ptr, None
        if tiles is None and bmg.split_ptr is not None:
            split = (bmg.split_ptr, bmg.cross_rows, bmg.y1_rows, bmg.y2_rows)
        fuse_iter = self.depth > 1 and self.activation == "relu" and not self.undirected
        if self.depth > 1:
            W_h, b_h = self._padded(self.W_h, dp, dp)
        if fuse_iter and opts.depth_loop and not drop_on:
            H = depth_loop(H0, W_h, b_h, *graph, self.depth, opts, tiles, split)
            _sow(taps, "H", H)
            return H, None
        if (readout and fuse_iter and self.depth >= 3 and not drop_on and opts.fused_readout
                and taps is None):
            return None, loop_readout(H0, W_h, b_h, *graph, self.depth, opts, tiles, split)
        H = self.tau(H0)
        for it in range(1, self.depth):
            if self.undirected:
                H = (H + H[bmg.rev.long()]) / 2
            if fuse_iter:
                if it == 1:  # relu(H0) streams through the kernel, never written
                    H = first_iter(H0, W_h, b_h, *graph, opts, tiles, split)
                else:
                    H = message_iter(H, H0, W_h, b_h, *graph, opts, tiles, split)
            else:
                M = message(H, *graph, *(split[:2] if split else (tiles, None)))
                z = matmul(M, W_h, use_kernel=True) if gw_i else M @ W_h
                if b_h is not None:
                    z = z + b_h
                H = self.tau(H0 + z)
            H = self.drop(H, drop_on, generator)
            _sow(taps, "H", H)
        return H, None


class AtomMessagePassing(_MessagePassingBase):
    """Atom-centred message passing (cf. ``AtomMessagePassing`` of
    ``chemprop_tpu/nn/message_passing/base.py``): the hidden states live on
    the edges, each initialised from its source atom alone, and an edge's
    message sums the states and bond features of every edge into its source,
    its own reverse included::

        H0_e = W_i(V)[src_e]
        H_e  = dropout(tau(H0_e + W_h M_e)),  M_e = sum_{k: dst_k = src_e} [H_k ; E_k]
                                                        (depth - 1 times)

    then the ``M_v`` readout and ``W_o`` (and ``W_d``) as in bond message
    passing. ``W_i`` takes the atom features, ``W_h`` the hidden width and
    the bond features. The JAX package keeps these tables at the unpadded
    ``d_h``; here the hidden width is lane-padded as in
    ``BondMessagePassing`` (zero weight columns, so the real columns are
    JAX's), and the message table ``[H ; E]`` is laid out as ``[H ; E ; 0]``
    to a multiple of 8 columns, 16-byte rows for kernel C, with ``W_h``'s
    kernel taking zero rows at both pads. Each message is kernel C over the
    edges' CSR pointers followed by ``ops.gather_src``, whose backward is C
    again; the ``M_v`` readout is C; with ``undirected`` the average with the
    reverse goes through ``ops.gather_rev`` (its bf16 backward is kernel I).
    ``kernel_options`` is kept for the loaders' sake: none of the opt-in
    kernels serves this layout, as none of the JAX package's does."""

    @staticmethod
    def _input_widths(d_v: int, d_e: int, d_h: int) -> tuple[int, int]:
        return d_v, d_h + d_e

    @property
    def d_message(self) -> int:
        """The width of the message table ``[H ; E ; 0]``."""
        return -(-(self.d_pad + self.d_e) // 8) * 8

    def forward(
        self, bmg: BatchMolGraph, V_d: torch.Tensor | None = None, is_training: bool = False,
        mc_dropout: bool = False, generator: torch.Generator | None = None,
        taps: dict | None = None,
    ) -> torch.Tensor:
        """As ``BondMessagePassing.forward``; ``taps`` collects ``H_0``, each
        iteration's ``H`` and ``M_v``."""
        bmg, drop_on = self._prologue(bmg, V_d, is_training, mc_dropout)
        H, _ = self._edge_states(bmg, drop_on, generator, taps)
        M_v = sorted_segment_sum(H.contiguous(), bmg.dst, bmg.edge_ptr)
        _sow(taps, "M_v", M_v)
        return self._node_output(bmg.V.to(self.compute_dtype), M_v, V_d, is_training, drop_on,
                                 generator)

    def _edge_states(self, bmg, drop_on, generator, taps, readout: bool = False):
        """``(H, None)``: the last iteration's lane-padded edge states."""
        dt, dp, dh = self.compute_dtype, self.d_pad, self.d_h
        graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
        W_i, b_i = self._padded(self.W_i, self.d_v, dp)
        H_nodes = bmg.V.to(dt) @ W_i
        if b_i is not None:
            H_nodes = H_nodes + b_i
        H0 = gather_src(H_nodes, *graph)
        _sow(taps, "H_0", H0)
        H = self.tau(H0)
        if self.depth > 1:
            # W_h's kernel rows: the hidden width, zero at its pad, then the
            # bond features, then zero to the message table's width
            K = self.W_h.weight.t()
            K = torch.cat([_pad(K[:dh], dp, dp), _pad(K[dh:], self.d_message - dp, dp)])
            W_h = K.to(dt).contiguous()
            b_h = None if self.W_h.bias is None else _pad(self.W_h.bias, 0, dp).to(dt)
            E = _pad(bmg.E.to(dt), bmg.E.shape[0], self.d_message - dp)
        for _ in range(1, self.depth):
            if self.undirected:
                H = (H + gather_rev(H, bmg.rev, bmg.last_edge_is_padding())) / 2
            M = gather_src(sorted_segment_sum(torch.cat([H, E], dim=1), bmg.dst, bmg.edge_ptr),
                           *graph)
            z = M @ W_h
            if b_h is not None:
                z = z + b_h
            H = self.drop(self.tau(H0 + z), drop_on, generator)
            _sow(taps, "H", H)
        return H, None
