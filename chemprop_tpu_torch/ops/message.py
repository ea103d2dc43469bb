"""The D-MPNN message, the fused depth iteration, their backward kernels and
the depth loop with the M_v readout as one differentiable op (cf.
``chemprop_tpu/ops/fused_message.py``):

    message:     M[e] = sum_{k : dst[k] == src[e]} H[k] - H[rev[e]]
    fused_iter:  y[e] = relu(H0[e] + bf16(M[e]) @ W [+ b])
    bwd_message:         gz = g * [y > 0] (+ gz_acc),  G = (S - R)^T (g * [y > 0])
    bwd_message_nodes:   the same with g = g_nodes[dst] never formed
    bwd_message_premul:  the same with g = G_in @ W^T formed inside the kernel
    loop_readout:        M_v of the whole depth loop, backward by hand

where ``((S - R)^T gz)[e] = sum_{k : src[k] == dst[e]} gz[k] - gz[rev[e]]``.

Edges are sorted by ``dst`` and ``ptr`` is the CSR of ``dst`` (the in-edges
of node ``v`` are rows ``[ptr[v], ptr[v+1])``). Padding edges (``src`` is the
padding node, the last one) get a zero message, so their rows differ from
the JAX kernels', which leave garbage there; no real row depends on them.
The backward kernels zero the padding rows of ``G``, ``gz`` and ``z`` too: the
weight gradients sum over every row. On a CUDA tensor the kernels in
``csrc/message.cu`` and ``csrc/message_bwd.cu`` run; on a CPU tensor the plain
versions below."""

from __future__ import annotations

import torch

from chemprop_tpu_torch.ops.build import LAUNCHES, call, library
from chemprop_tpu_torch.ops.segment import DTYPES, _segment_sum


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


def _transposed_plain(gz: torch.Tensor, dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor):
    """``(S - R)^T gz`` in f32 for an f32 ``gz``, zero on the padding rows."""
    n_nodes = ptr.numel() - 1
    g_rev = gz[rev.long()]
    T = torch.zeros((n_nodes, gz.shape[1]), dtype=torch.float32, device=gz.device)
    T.index_add_(0, dst.long(), g_rev)
    G = T[dst.long()] - g_rev
    return G.masked_fill_((dst == n_nodes - 1)[:, None], 0.0)


def bwd_message_plain(
    g: torch.Tensor, y: torch.Tensor | None, src: torch.Tensor, dst: torch.Tensor,
    rev: torch.Tensor, ptr: torch.Tensor, gz_acc: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the masked transposed message: f32 sums,
    one cast; ``G`` comes from the unaccumulated ``gz``. ``y=None``: no mask."""
    pad = (dst == ptr.numel() - 2)[:, None]
    gz = g.float() if y is None else g.float() * (y > 0)
    G = _transposed_plain(gz, dst, rev, ptr).to(g.dtype)
    if gz_acc is not None:
        gz = gz + gz_acc.float()
    return G, gz.masked_fill(pad, 0.0).to(g.dtype)


def bwd_message_nodes_plain(
    g_nodes: torch.Tensor, y: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
    rev: torch.Tensor, ptr: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the node-cotangent form."""
    return bwd_message_plain(g_nodes[dst.long()], y, src, dst, rev, ptr)


def bwd_message_premul_plain(
    G_in: torch.Tensor, y: torch.Tensor, H0: torch.Tensor | None, W: torch.Tensor,
    src: torch.Tensor, dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor,
    fold_h0: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the premultiplied form, with the kernel's
    roundings: ``dh`` stays f32, ``gz`` is rounded before it is summed into
    ``G``, ``z`` is formed from the f32 ``gz`` and ``dh`` and rounded once."""
    pad = (dst == ptr.numel() - 2)[:, None]
    dh = G_in.float() @ W.float().t()
    gz = dh * (y > 0)
    gz_r = gz.to(y.dtype)
    G = _transposed_plain(gz_r.float(), dst, rev, ptr).to(y.dtype)
    z = (gz + dh * (H0 > 0)).to(y.dtype) if fold_h0 else gz_r
    return G, z.masked_fill(pad, 0.0)


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
    """``M = message(H)`` for a float32 or bfloat16 edge table, differentiable
    in ``H``: the backward is the transposed message without a mask. The
    forward kernel is float32 only (the bfloat16 forward forms its messages
    in :func:`fused_iter`), so a bfloat16 table on the card raises."""
    return _Message.apply(H, src, dst, rev, ptr)


def _message_fwd(H, src, dst, rev, ptr):
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


def _check_tables(first: torch.Tensor, others: dict[str, torch.Tensor | None]) -> None:
    for name, t in others.items():
        if t is None:
            continue
        if t.shape != first.shape or t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f"{name} must match the first table's shape, dtype and device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_bwd(g, y, acc, dst, rev, ptr, nodes: bool, with_gz: bool):
    """The node-wise kernel of ``csrc/message_bwd.cu`` on CUDA tensors."""
    n, d = (y if y is not None else g).shape
    tables = [t for t in (g, y, acc) if t is not None]
    if d % 4 != 0 or any(t.data_ptr() % 16 != 0 for t in tables):
        raise ValueError(f"width {d} must be a multiple of 4, rows 16-byte aligned")
    G = torch.empty((n, d), dtype=g.dtype, device=g.device)
    gz = torch.empty_like(G) if with_gz else None
    call(
        library("message_bwd"), "bwd_message", g, y, acc, dst.contiguous(), rev.contiguous(),
        ptr.contiguous(), G, gz, n, d, ptr.numel() - 2, int(nodes), DTYPES[g.dtype],
    )
    return G, gz


def bwd_message(
    g: torch.Tensor, y: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, rev: torch.Tensor,
    ptr: torch.Tensor, gz_acc: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(G, gz)`` of one depth iteration's backward from the edge cotangent
    ``g`` and the saved output ``y``: ``gz = g * [y > 0] (+ gz_acc)`` and
    ``G = (S - R)^T (g * [y > 0])``, float32 or bfloat16."""
    _check_graph(g, src, dst, rev, ptr)
    if g.dtype not in DTYPES:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    _check_tables(g, {"y": y, "gz_acc": gz_acc})
    if g.device.type == "cpu":
        return bwd_message_plain(g, y, src, dst, rev, ptr, gz_acc)
    out = _launch_bwd(g, y, gz_acc, dst, rev, ptr, nodes=False, with_gz=True)
    LAUNCHES["bwd_message"] += 1
    return out


def bwd_message_nodes(
    g_nodes: torch.Tensor, y: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
    rev: torch.Tensor, ptr: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`bwd_message` for the last iteration, whose cotangent arrives as
    the ``[N, d]`` node table of the M_v readout: ``g = g_nodes[dst]`` is
    formed inside the kernel and never written. bfloat16 only, as the JAX
    kernel."""
    _check_graph(y, src, dst, rev, ptr)
    if y.dtype != torch.bfloat16 or g_nodes.dtype != torch.bfloat16:
        raise TypeError("bwd_message_nodes takes bfloat16 g_nodes and y")
    if g_nodes.shape != (ptr.numel() - 1, y.shape[1]) or g_nodes.device != y.device:
        raise ValueError(f"g_nodes {tuple(g_nodes.shape)} does not fit y and ptr")
    if not g_nodes.is_contiguous():
        raise ValueError("g_nodes must be contiguous")
    if y.device.type == "cpu":
        return bwd_message_nodes_plain(g_nodes, y, src, dst, rev, ptr)
    out = _launch_bwd(g_nodes, y, None, dst, rev, ptr, nodes=True, with_gz=True)
    LAUNCHES["bwd_message_nodes"] += 1
    return out


def bwd_message_premul(
    G_in: torch.Tensor, y: torch.Tensor, H0: torch.Tensor | None, W: torch.Tensor,
    src: torch.Tensor, dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor,
    fold_h0: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(G, z)`` of an earlier iteration's backward from the next stage's
    ``G_in``: ``dh = G_in @ W^T`` is formed inside the kernel,
    ``gz = dh * [y > 0]``, ``G = (S - R)^T gz``, and ``z = gz`` or, with
    ``fold_h0`` (the first iteration), ``gz + dh * [H0 > 0]``. bfloat16 only;
    ``W`` is ``[d, d]`` in (in, out) layout, ``d`` a multiple of 128."""
    _check_graph(y, src, dst, rev, ptr)
    n, d = y.shape
    if y.dtype != torch.bfloat16 or W.dtype != torch.bfloat16:
        raise TypeError("bwd_message_premul takes bfloat16 tables and W")
    if fold_h0 and H0 is None:
        raise ValueError("fold_h0 needs H0")
    H0 = H0 if fold_h0 else None
    _check_tables(y, {"G_in": G_in, "H0": H0})
    if W.shape != (d, d) or d % 128 != 0 or W.device != y.device or not W.is_contiguous():
        raise ValueError(f"W {tuple(W.shape)} must be a contiguous [d, d] with d % 128 == 0")
    if y.device.type == "cpu":
        return bwd_message_premul_plain(G_in, y, H0, W, src, dst, rev, ptr, fold_h0)
    if any(t.data_ptr() % 16 != 0 for t in (G_in, y, W) + ((H0,) if fold_h0 else ())):
        raise ValueError("bwd_message_premul needs 16-byte aligned tables")
    G, z = torch.empty_like(y), torch.empty_like(y)
    scratch = torch.empty_like(y) if fold_h0 else None
    call(
        library("message_bwd"), "bwd_message_premul", G_in, y, H0, W, dst.contiguous(),
        rev.contiguous(), ptr.contiguous(), G, z, scratch, n, d, ptr.numel() - 2,
    )
    LAUNCHES["bwd_message_premul"] += 1
    return G, z


class _Message(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H, src, dst, rev, ptr):
        ctx.save_for_backward(src, dst, rev, ptr)
        return _message_fwd(H, src, dst, rev, ptr)

    @staticmethod
    def backward(ctx, g):
        src, dst, rev, ptr = ctx.saved_tensors
        g = g.contiguous()
        if g.device.type == "cpu":
            return bwd_message_plain(g, None, src, dst, rev, ptr)[0], None, None, None, None
        # the message kernel with the roles of src and dst swapped: the
        # node-wise backward kernel without its mask
        G, _ = _launch_bwd(g, None, None, dst, rev, ptr, nodes=False, with_gz=False)
        LAUNCHES["bwd_message"] += 1
        return G, None, None, None, None


def _xt_g(x: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """``x^T G`` as float32 with f32 accumulation (a library product: the JAX
    package leaves this one to XLA too)."""
    if x.dtype == torch.bfloat16 and x.device.type == "cuda":
        return torch.mm(x.t(), G, out_dtype=torch.float32)
    return x.float().t() @ G.float()


def loop_readout(
    H0: torch.Tensor, W: torch.Tensor, b: torch.Tensor | None, src: torch.Tensor,
    dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor, depth: int,
) -> torch.Tensor:
    """The whole ReLU depth loop and the M_v readout as one differentiable op
    (cf. ``fused_loop_readout``), for ``depth >= 2``:

        H = relu(H0); repeat depth - 1 times: H = relu(H0 + message(H) @ W [+ b])
        M_v = segment_sum(H, dst)                               [N, d], H0's dtype

    In bfloat16 every iteration is one :func:`fused_iter` kernel; in float32
    the message kernel and a ``torch.matmul``. The backward is written by
    hand. In bfloat16 with no bias and ``depth >= 3`` no cotangent edge table
    is formed outside a kernel: :func:`bwd_message_nodes` for the last
    iteration, :func:`bwd_message_premul` for the earlier ones, the first
    with ``fold_h0``. Otherwise (float32, a bias, depth 2) it is the
    per-iteration chain through :func:`bwd_message` with the running ``dH0``
    accumulated in the kernel, and ``G @ W^T`` a ``torch.matmul``. The weight
    gradient ``x_t^T G`` is a library product in both."""
    if depth < 2:
        raise ValueError("loop_readout needs depth >= 2")
    return _LoopReadout.apply(H0, W, b, src, dst, rev, ptr, depth)


class _LoopReadout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H0, W, b, src, dst, rev, ptr, depth):
        graph = (src, dst, rev, ptr)
        H0 = H0.contiguous()
        ys = []
        if H0.dtype == torch.bfloat16:
            y = fused_iter(H0, H0, W, b, *graph, relu_stream=True)
            ys.append(y)
            for _ in range(2, depth):
                y = fused_iter(y, H0, W, b, *graph)
                ys.append(y)
        else:
            y = torch.relu(H0)
            for _ in range(1, depth):
                z = _message_fwd(y, *graph) @ W
                if b is not None:
                    z = z + b
                y = torch.relu(H0 + z)
                ys.append(y)
        ctx.save_for_backward(H0, W, b, *graph, *ys)
        ctx.depth = depth
        return _segment_sum(y, dst, ptr, y.dtype, False)[0]

    @staticmethod
    def backward(ctx, g_Mv):
        H0, W, b, src, dst, rev, ptr, *ys = ctx.saved_tensors
        graph = (src, dst, rev, ptr)
        depth, dt = ctx.depth, H0.dtype
        g_Mv = g_Mv.to(dt).contiguous()
        relu_H0 = torch.relu(H0)

        def x_of(t):  # the input of iteration t
            return ys[t - 2] if t >= 2 else relu_H0

        if dt == torch.bfloat16 and b is None and depth >= 3:
            G, dH0 = bwd_message_nodes(g_Mv, ys[-1], *graph)
            dW = _xt_g(x_of(depth - 1), G)
            for t in range(depth - 2, 0, -1):
                G, z = bwd_message_premul(G, ys[t - 1], H0, W, *graph, fold_h0=t == 1)
                dW = dW + _xt_g(x_of(t), G)
                dH0 = dH0 + z
            return dH0, dW.to(W.dtype), None, None, None, None, None, None
        # the per-iteration chain
        g = g_Mv[dst.long()]
        dW, acc = None, None
        for t in range(depth - 1, 0, -1):
            G, acc = bwd_message(g, ys[t - 1], *graph, gz_acc=acc)
            dWt = _xt_g(x_of(t), G)
            dW = dWt if dW is None else dW + dWt
            g = (G @ W.t()).to(dt)
        db = None if b is None else acc.float().sum(0).to(b.dtype)
        dH0 = acc + g * (H0 > 0)
        return dH0, dW.to(W.dtype), db, None, None, None, None, None
