"""The D-MPNN message, the fused depth iteration, their backward kernels, one
iteration and the whole depth loop with the M_v readout as differentiable ops
(cf. ``chemprop_tpu/ops/fused_message.py``):

    message:     M[e] = sum_{k : dst[k] == src[e]} H[k] - H[rev[e]]
    fused_iter:  y[e] = relu(H0[e] + bf16(M[e]) @ W [+ b])
    fused_iter2: y1 = fused_iter(relu(H0)), y2 = fused_iter(y1), one launch
    bwd_message:         gz = g * [y > 0] (+ gz_acc),  G = (S - R)^T (g * [y > 0]),
                         one launch over the batch's molecule tiles
    bwd_message_nodes:   the same with g = g_nodes[dst] never formed, one
                         launch over the batch's molecule tiles
    bwd_message_premul:  the same with g = G_in @ W^T formed inside the kernel,
                         one launch over the batch's molecule tiles
    iter_bwd:            dH = bf16(G) W^T, gz and dW = H^T bf16(G), G never written,
                         one launch over the batch's molecule tiles
    first_iter, message_iter:  one iteration each, backward by hand
    depth_loop:          the last H of the whole depth loop, backward by hand
    loop_readout:        M_v of the whole depth loop, backward by hand

where ``((S - R)^T gz)[e] = sum_{k : src[k] == dst[e]} gz[k] - gz[rev[e]]``.

Edges are sorted by ``dst`` and ``ptr`` is the CSR of ``dst`` (the in-edges
of node ``v`` are rows ``[ptr[v], ptr[v+1])``). Padding edges (``src`` is the
padding node, the last one) get a zero message, so their rows differ from
the JAX kernels', which leave garbage there; no real row depends on them.
The backward kernels zero the padding rows of ``G``, ``gz`` and ``z`` too: the
weight gradients sum over every row. On a CUDA tensor the kernels in
``csrc/message_tiles.cu`` (or ``csrc/message.cu``), ``csrc/fused_iter.cu``,
``csrc/iter2.cu``, ``csrc/message_bwd_tiles.cu`` (or ``csrc/message_bwd.cu``),
``csrc/bwd_nodes.cu``, ``csrc/bwd_premul.cu`` and ``csrc/iter_bwd.cu`` run; on
a CPU tensor the plain versions below.

The tile kernels (``message``, ``fused_iter2``, ``bwd_message``,
``bwd_message_nodes``, ``bwd_message_premul``, ``iter_bwd``) take the batch's tile table
(``BatchMolGraph.tile_ptr``): ascending row offsets from 0 to ``E`` that cut
the edge rows into runs of at most ``ITER2_TILE_ROWS``, no real molecule's
rows in two runs, so that every row a tile's row gathers lies in the tile.
A batch with a molecule of more rows than that has none; G and H
(``bwd_message_nodes``, ``bwd_message_premul``) then take its split table
(``BatchMolGraph.split_ptr``, the molecule cut at its nodes' boundaries)
with its ``cross_rows``: the tile kernel forms every other row of ``G``, and
:func:`_cross_rows` forms those from the ``gz`` table it wrote."""

from __future__ import annotations

import torch

from chemprop_tpu_torch.ops.build import LAUNCHES, UNSERVED, call, library
from chemprop_tpu_torch.ops.grad_weight import grad_weight
from chemprop_tpu_torch.ops.options import KernelOptions
from chemprop_tpu_torch.ops.segment import DTYPES, _segment_sum

# the most edge rows a tile of ``fused_iter2``'s tile table may hold
ITER2_TILE_ROWS = 128
# the widths ``fused_iter2`` takes: a cluster of d / 128 CTAs, each with a
# 128-column slice of W resident beside its buffers (``csrc/iter2.cu``); at a
# wider width ``loop_readout`` takes two ``fused_iter`` launches, by this rule
# and never after a failed launch
ITER2_WIDTHS = (128, 256, 384, 512)
# the widths the tiled ``iter_bwd`` takes: a cluster of d / 64 blocks shares a
# tile, and the buffers of d = 512 would not fit a block's shared memory
ITER_BWD_TILE_WIDTHS = (128, 256, 384)
# the tiled message kernel (``csrc/message_tiles.cu``) and the tiled masked
# transposed message (``csrc/message_bwd_tiles.cu``) take the lane-padded
# widths, multiples of 128 up to this, in both dtypes
MESSAGE_TILE_MAX_WIDTH = 1024


def message_tile_width(d: int) -> bool:
    """Whether the tiled message kernel, and the tiled :func:`bwd_message`,
    take width ``d``."""
    return d % 128 == 0 and 0 < d <= MESSAGE_TILE_MAX_WIDTH


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


def fused_iter2_plain(
    H0: torch.Tensor, W: torch.Tensor, b: torch.Tensor | None, src: torch.Tensor,
    dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the chained first two iterations: ``y1``
    is rounded to bfloat16 before it is gathered, as two launches would."""
    y1 = fused_iter_plain(H0, H0, W, b, src, dst, rev, ptr, relu_stream=True)
    return y1, fused_iter_plain(y1, H0, W, b, src, dst, rev, ptr)


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
    fold_h0: bool = False, tiles: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the premultiplied form, with the kernel's
    roundings: ``dh`` stays f32, ``gz`` is rounded before it is summed into
    ``G``, ``z`` is formed from the f32 ``gz`` and ``dh`` and rounded once.
    The function does not depend on the tile table, so ``tiles`` is unused."""
    pad = (dst == ptr.numel() - 2)[:, None]
    dh = G_in.float() @ W.float().t()
    gz = dh * (y > 0)
    gz_r = gz.to(y.dtype)
    G = _transposed_plain(gz_r.float(), dst, rev, ptr).to(y.dtype)
    z = (gz + dh * (H0 > 0)).to(y.dtype) if fold_h0 else gz_r
    return G, z.masked_fill(pad, 0.0)


def iter_bwd_plain(
    g: torch.Tensor, y: torch.Tensor, H: torch.Tensor, W: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the whole-iteration backward, with the
    kernel's roundings: ``G`` is summed in f32 and rounded once, both products
    take the rounded ``G`` and accumulate in f32, ``dW`` stays f32."""
    pad = (dst == ptr.numel() - 2)[:, None]
    G, gz = bwd_message_plain(g, y, src, dst, rev, ptr)
    dH = (G.float() @ W.float().t()).to(g.dtype)
    dW = H.float().masked_fill(pad, 0.0).t() @ G.float()
    return dH, gz, dW


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
    H: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor,
    tiles: torch.Tensor | None = None,
) -> torch.Tensor:
    """``M = message(H)`` for a float32 or bfloat16 edge table, differentiable
    in ``H``: the backward is the transposed message without a mask. Sums
    are taken in f32 and rounded once to ``H``'s dtype.

    With the batch's tile table ``tiles`` (:func:`check_tiles`) at a width
    :func:`message_tile_width` takes, it is one launch of
    ``csrc/message_tiles.cu`` over the molecule tiles; without one (a
    molecule of more than ``ITER2_TILE_ROWS`` rows), or at another width, the
    warp-per-edge kernel of ``csrc/message.cu``, and ``UNSERVED["message"]``
    counts the call. Both give the same bits."""
    return _Message.apply(H, src, dst, rev, ptr, tiles)


def _message_fwd(H, src, dst, rev, ptr, tiles=None):
    _check_graph(H, src, dst, rev, ptr)
    if H.dtype not in DTYPES:
        raise TypeError(f"H must be float32 or bfloat16, got {H.dtype}")
    n, d = H.shape
    if tiles is not None:
        check_tiles(tiles, n, H.device)
    tiled = tiles is not None and message_tile_width(d)
    if not tiled:
        UNSERVED["message"] += 1
    if H.device.type == "cpu":
        return message_plain(H, src, dst, rev, ptr)
    if d % 4 != 0 or H.data_ptr() % 16 != 0:
        raise ValueError(f"width {d} must be a multiple of 4, rows 16-byte aligned")
    out = torch.empty_like(H)
    graph = (src.contiguous(), rev.contiguous(), ptr.contiguous())
    if tiled:
        call(library("message_tiles"), "message_tiles", H, *graph, tiles.contiguous(), out, n,
             d, ptr.numel() - 2, tiles.numel() - 1, DTYPES[H.dtype])
    else:
        call(library("message"), "plain_message", H, *graph, out, n, d, ptr.numel() - 2,
             DTYPES[H.dtype])
    LAUNCHES["message"] += 1
    return out


def message_info(d: int, dtype: torch.dtype, n_tiles: int) -> dict[str, int]:
    """The shape of the tiled :func:`message` launch on the current card at
    width ``d`` in ``dtype`` over ``n_tiles`` tiles: the column slice of an
    item, the slices, the stages, the shared memory per block, the grid, and
    the blocks of the kernel that one SM runs at once."""
    import ctypes

    info = (ctypes.c_int * 6)()
    err = library("message_tiles").message_tiles_info(d, DTYPES[dtype], n_tiles, info)
    if err != 0:
        raise RuntimeError(f"message_tiles_info: CUDA error {err}")
    keys = ("slice_width", "slices", "stages", "smem_bytes", "grid", "blocks_per_sm")
    return dict(zip(keys, info))


def _check_iter(H, H0, W, b, src, dst, rev, ptr):
    """The checks the bfloat16 iteration kernels share."""
    _check_graph(H, src, dst, rev, ptr)
    n, d = H.shape
    if H.dtype != torch.bfloat16 or H0.dtype != torch.bfloat16 or W.dtype != torch.bfloat16:
        raise TypeError("the fused iteration takes bfloat16 H, H0 and W")
    if H0.shape != H.shape or W.shape != (d, d) or d % 128 != 0:
        raise ValueError(f"H0 {tuple(H0.shape)} / W {tuple(W.shape)} do not fit H {(n, d)}")
    if b is not None and (b.dtype != torch.bfloat16 or b.shape != (d,)):
        raise ValueError("b must be a bfloat16 [d] vector")
    tensors = [H0, W] + ([b] if b is not None else [])
    if any(t.device != H.device or not t.is_contiguous() for t in tensors):
        raise ValueError("H0, W and b must be contiguous and on H's device")
    if H.device.type == "cuda" and any(t.data_ptr() % 16 != 0 for t in [H] + tensors):
        raise ValueError("the fused iteration needs 16-byte aligned tables")


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
    _check_iter(H, H0, W, b, src, dst, rev, ptr)
    n, d = H.shape
    if H.device.type == "cpu":
        return fused_iter_plain(H, H0, W, b, src, dst, rev, ptr, relu_stream)
    y = torch.empty_like(H)
    if n == 0:
        return y
    call(
        library("fused_iter"), "fused_iter", H, H0, W, b, src.contiguous(), rev.contiguous(),
        ptr.contiguous(), y, n, d, ptr.numel() - 2, int(relu_stream),
    )
    LAUNCHES["fused_iter"] += 1
    return y


def fused_iter_info(d: int, n_edges: int) -> dict[str, int]:
    """The shape of :func:`fused_iter`'s launch on the current card at width
    ``d`` and ``n_edges`` rows: the width of a block's W slice, the slices,
    the blocks per cluster, the message stages, the shared memory per block,
    the grid, and the clusters of the kernel that the card runs at once."""
    import ctypes

    info = (ctypes.c_int * 6)()
    err = library("fused_iter").fused_iter_info(d, n_edges, info)
    if err != 0:
        raise RuntimeError(f"fused_iter_info: CUDA error {err}")
    keys = ("slice_width", "slices", "stages", "smem_bytes", "grid", "blocks_per_sm")
    return dict(zip(keys, info))


def check_tiles(tiles: torch.Tensor, n_edges: int, device: torch.device) -> None:
    """Raise unless ``tiles`` is a tile table the tile kernels take: a 1-d
    int32 tensor on ``device`` of row offsets ascending from 0 to ``n_edges``,
    no tile of more than ``ITER2_TILE_ROWS`` rows. A table on the card is read
    back for this (a wait for the device), unless :func:`tiles_to` checked it
    on the host before it moved it there. That molecules are whole is the
    collate's to keep (:func:`chemprop_tpu_torch.data.collate.iter2_tiles`)."""
    if tiles.dtype != torch.int32 or tiles.dim() != 1 or tiles.numel() < 2:
        raise ValueError("tiles must be a 1-d int32 tensor of at least two offsets")
    if tiles.device != device:
        raise ValueError(f"tiles must be on {device}")
    if getattr(tiles, "checked_for_rows", None) == n_edges:
        return
    t = tiles.cpu()
    rows = t[1:] - t[:-1]
    if int(t[0]) != 0 or int(t[-1]) != n_edges:
        raise ValueError(f"tiles must run from 0 to the {n_edges} edge rows")
    if bool((rows < 0).any()) or int(rows.max()) > ITER2_TILE_ROWS:
        raise ValueError(f"tiles must ascend in runs of at most {ITER2_TILE_ROWS} rows")


def tiles_to(tiles: torch.Tensor, n_edges: int, device: str | torch.device) -> torch.Tensor:
    """``tiles`` checked (:func:`check_tiles`, on its own device) and moved to
    ``device``, marked so that the tile kernels do not read it back."""
    check_tiles(tiles, n_edges, tiles.device)
    moved = tiles.to(device, non_blocking=True)
    moved.checked_for_rows = n_edges
    return moved


def fused_iter2(
    H0: torch.Tensor, W: torch.Tensor, b: torch.Tensor | None, src: torch.Tensor,
    dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor, tiles: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The first two bfloat16 depth iterations in one launch:
    ``y1 = fused_iter(H0, H0, relu_stream=True)`` and ``y2 = fused_iter(y1, H0)``,
    both equal to those two launches bit for bit. ``tiles`` is the batch's tile
    table (:func:`check_tiles`); ``d`` one of ``ITER2_WIDTHS``."""
    _check_iter(H0, H0, W, b, src, dst, rev, ptr)
    n, d = H0.shape
    if d not in ITER2_WIDTHS:
        raise ValueError(f"fused_iter2 takes d in {ITER2_WIDTHS}, not {d}")
    check_tiles(tiles, n, H0.device)
    if H0.device.type == "cpu":
        return fused_iter2_plain(H0, W, b, src, dst, rev, ptr)
    y1, y2 = torch.empty_like(H0), torch.empty_like(H0)
    if n == 0:
        return y1, y2
    call(library("iter2"), "iter2", H0, W, b, src.contiguous(), rev.contiguous(),
         ptr.contiguous(), tiles.contiguous(), y1, y2, n, tiles.numel() - 1, d, ptr.numel() - 2)
    LAUNCHES["fused_iter2"] += 1
    return y1, y2


def fused_iter2_info(d: int, n_tiles: int) -> dict[str, int]:
    """The shape of :func:`fused_iter2`'s launch on the current card at width
    ``d`` over ``n_tiles`` tiles: the width of a CTA's W slice, the CTAs of a
    cluster (the slices), the message stages, the shared memory per CTA, the
    clusters of the grid and the clusters the card runs at once."""
    import ctypes

    info = (ctypes.c_int * 6)()
    err = library("iter2").iter2_info(d, n_tiles, info)
    if err != 0:
        raise RuntimeError(f"iter2_info: CUDA error {err}")
    keys = ("slice_width", "cluster_ctas", "stages", "smem_bytes", "clusters",
            "max_active_clusters")
    return dict(zip(keys, info))


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


def _check_cross(cross: torch.Tensor | None, tiles: torch.Tensor | None, y: torch.Tensor) -> None:
    if cross is None:
        return
    if tiles is None:
        raise ValueError("cross rows come with the split tile table")
    if cross.dtype != torch.int32 or cross.dim() != 1 or cross.device != y.device:
        raise ValueError(f"cross must be a 1-d int32 tensor on {y.device}")


def _cross_rows(gz, dst, rev, ptr, cross, G) -> None:
    """``G`` at the rows ``cross`` formed again from the bfloat16 ``gz`` table
    in device memory (``csrc/message_bwd.cu``, one warp a row, the node
    pass's sums in its order: the bits the tile kernels give their other
    rows)."""
    if cross.numel():
        call(library("message_bwd"), "cross_rows", gz, dst, rev, ptr, cross.contiguous(), G,
             cross.numel(), gz.shape[1])


def bwd_message(
    g: torch.Tensor, y: torch.Tensor | None, src: torch.Tensor, dst: torch.Tensor,
    rev: torch.Tensor, ptr: torch.Tensor, gz_acc: torch.Tensor | None = None,
    tiles: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(G, gz)`` of one depth iteration's backward from the edge cotangent
    ``g`` and the saved output ``y``: ``gz = g * [y > 0] (+ gz_acc)`` and
    ``G = (S - R)^T (g * [y > 0])``, float32 or bfloat16; ``y=None``: no mask.

    With the batch's tile table ``tiles`` (:func:`check_tiles`) at a width
    :func:`message_tile_width` takes, it is one launch of
    ``csrc/message_bwd_tiles.cu`` over the molecule tiles; without one (a
    molecule of more than ``ITER2_TILE_ROWS`` rows), or at another width, the
    node-warp kernel of ``csrc/message_bwd.cu``, and ``UNSERVED["bwd_message"]``
    counts the call. Both give the same bits."""
    _check_graph(g, src, dst, rev, ptr)
    if g.dtype not in DTYPES:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    _check_tables(g, {"y": y, "gz_acc": gz_acc})
    return _transposed(g, y, gz_acc, (src, dst, rev, ptr), tiles, with_gz=True)


def _transposed(g, y, acc, graph, tiles, with_gz: bool):
    """F on checked tables: over the tile table where it serves, else the
    node-warp form; ``gz`` is None unless ``with_gz``."""
    src, dst, rev, ptr = graph
    n, d = g.shape
    if tiles is not None:
        check_tiles(tiles, n, g.device)
    tiled = tiles is not None and message_tile_width(d)
    if not tiled:
        UNSERVED["bwd_message"] += 1
    if g.device.type == "cpu":
        G, gz = bwd_message_plain(g, y, *graph, gz_acc=acc)
        return G, gz if with_gz else None
    if not tiled:
        out = _launch_bwd(g, y, acc, dst, rev, ptr, nodes=False, with_gz=with_gz)
    else:
        if any(t.data_ptr() % 16 != 0 for t in (g, y, acc) if t is not None):
            raise ValueError("bwd_message needs 16-byte aligned tables")
        out = torch.empty_like(g), torch.empty_like(g) if with_gz else None
        if n == 0:
            return out
        call(library("message_bwd_tiles"), "bwd_message_tiles", g, y, acc, dst.contiguous(),
             rev.contiguous(), ptr.contiguous(), tiles.contiguous(), *out, n, d,
             ptr.numel() - 2, tiles.numel() - 1, DTYPES[g.dtype])
    LAUNCHES["bwd_message"] += 1
    return out


def bwd_message_info(d: int, dtype: torch.dtype, n_tiles: int, tables: int = 2) -> dict[str, int]:
    """The shape of the tiled :func:`bwd_message` launch on the current card
    at width ``d`` in ``dtype`` over ``n_tiles`` tiles with ``tables`` tables
    staged (1: the message's own backward, ``g`` alone; 2: ``g`` and ``y``; 3:
    with ``gz_acc`` too): the column slice of an item, the slices, the stages,
    the shared memory per block, the grid, the blocks of the kernel that one
    SM runs at once, and the rows of a TMA box of a slice (0: one bulk copy of
    each whole tile and table, or one a row)."""
    import ctypes

    info = (ctypes.c_int * 7)()
    err = library("message_bwd_tiles").bwd_message_tiles_info(d, DTYPES[dtype], tables, n_tiles,
                                                                info)
    if err != 0:
        raise RuntimeError(f"bwd_message_tiles_info: CUDA error {err}")
    keys = ("slice_width", "slices", "stages", "smem_bytes", "grid", "blocks_per_sm", "box_rows")
    return dict(zip(keys, info))


def bwd_message_nodes(
    g_nodes: torch.Tensor, y: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
    rev: torch.Tensor, ptr: torch.Tensor, tiles: torch.Tensor | None = None,
    cross: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`bwd_message` for the last iteration, whose cotangent arrives as
    the ``[N, d]`` node table of the M_v readout: ``g = g_nodes[dst]`` is
    formed inside the kernel and never written. bfloat16 only, as the JAX
    kernel.

    With the batch's tile table ``tiles`` (:func:`check_tiles`; ``d`` a
    multiple of 128) it is one launch of ``csrc/bwd_nodes.cu`` over the
    molecule tiles; without one (a molecule of more than ``ITER2_TILE_ROWS``
    rows) the node-warp kernel of ``csrc/message_bwd.cu``. With a split table
    (``BatchMolGraph.split_ptr``) and its ``cross`` rows it is the tile
    launch, then :func:`_cross_rows` over those rows. All give the same
    bits."""
    _check_graph(y, src, dst, rev, ptr)
    n, d = y.shape
    _check_cross(cross, tiles, y)
    if y.dtype != torch.bfloat16 or g_nodes.dtype != torch.bfloat16:
        raise TypeError("bwd_message_nodes takes bfloat16 g_nodes and y")
    if g_nodes.shape != (ptr.numel() - 1, d) or g_nodes.device != y.device:
        raise ValueError(f"g_nodes {tuple(g_nodes.shape)} does not fit y and ptr")
    if not g_nodes.is_contiguous():
        raise ValueError("g_nodes must be contiguous")
    if tiles is not None:
        if d % 128 != 0:
            raise ValueError(f"the tiled bwd_message_nodes takes d % 128 == 0, not {d}")
        check_tiles(tiles, n, y.device)
    if y.device.type == "cpu":
        return bwd_message_nodes_plain(g_nodes, y, src, dst, rev, ptr)
    if tiles is None:
        out = _launch_bwd(g_nodes, y, None, dst, rev, ptr, nodes=True, with_gz=True)
    else:
        if g_nodes.data_ptr() % 16 != 0 or y.data_ptr() % 16 != 0:
            raise ValueError("bwd_message_nodes needs 16-byte aligned tables")
        out = torch.empty_like(y), torch.empty_like(y)
        if n == 0:
            return out
        call(library("bwd_nodes"), "bwd_nodes", g_nodes, y, dst.contiguous(), rev.contiguous(),
             ptr.contiguous(), tiles.contiguous(), *out, n, d, ptr.numel() - 2,
             tiles.numel() - 1)
        if cross is not None:
            _cross_rows(out[1], dst.contiguous(), rev.contiguous(), ptr.contiguous(), cross,
                        out[0])
    LAUNCHES["bwd_message_nodes"] += 1
    return out


def bwd_message_nodes_info(d: int, n_tiles: int) -> dict[str, int]:
    """The shape of the tiled :func:`bwd_message_nodes` launch on the current
    card at width ``d`` over ``n_tiles`` tiles: the column slice of an item,
    the slices, the stages, the shared memory per block, the grid, and the
    blocks of the kernel that one SM runs at once."""
    import ctypes

    info = (ctypes.c_int * 6)()
    err = library("bwd_nodes").bwd_nodes_info(d, n_tiles, info)
    if err != 0:
        raise RuntimeError(f"bwd_nodes_info: CUDA error {err}")
    keys = ("slice_width", "slices", "stages", "smem_bytes", "grid", "blocks_per_sm")
    return dict(zip(keys, info))


def bwd_message_premul(
    G_in: torch.Tensor, y: torch.Tensor, H0: torch.Tensor | None, W: torch.Tensor,
    src: torch.Tensor, dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor,
    fold_h0: bool = False, tiles: torch.Tensor | None = None,
    cross: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(G, z)`` of an earlier iteration's backward from the next stage's
    ``G_in``: ``dh = G_in @ W^T`` is formed inside the kernel,
    ``gz = dh * [y > 0]``, ``G = (S - R)^T gz``, and ``z = gz`` or, with
    ``fold_h0`` (the first iteration), ``gz + dh * [H0 > 0]``. bfloat16 only;
    ``W`` is ``[d, d]`` in (in, out) layout, ``d`` a multiple of 128.

    With the batch's tile table ``tiles`` (:func:`check_tiles`) it is one
    launch, and ``gz`` stays on chip; without one (a molecule of more than
    ``ITER2_TILE_ROWS`` rows) the same product over fixed tiles writes ``gz``,
    then the node pass of :func:`bwd_message` forms ``G``: two launches, equal
    to the one bit for bit. With a split table (``BatchMolGraph.split_ptr``)
    and its ``cross`` rows the tile launch also writes ``gz`` (``z`` itself
    without ``fold_h0``), and :func:`_cross_rows` forms ``G`` at those rows
    from it: the same bits again."""
    _check_graph(y, src, dst, rev, ptr)
    n, d = y.shape
    _check_cross(cross, tiles, y)
    if y.dtype != torch.bfloat16 or W.dtype != torch.bfloat16:
        raise TypeError("bwd_message_premul takes bfloat16 tables and W")
    if fold_h0 and H0 is None:
        raise ValueError("fold_h0 needs H0")
    H0 = H0 if fold_h0 else None
    _check_tables(y, {"G_in": G_in, "H0": H0})
    if W.shape != (d, d) or d % 128 != 0 or W.device != y.device or not W.is_contiguous():
        raise ValueError(f"W {tuple(W.shape)} must be a contiguous [d, d] with d % 128 == 0")
    if tiles is not None:
        check_tiles(tiles, n, y.device)
    if y.device.type == "cpu":
        return bwd_message_premul_plain(G_in, y, H0, W, src, dst, rev, ptr, fold_h0)
    if any(t.data_ptr() % 16 != 0 for t in (G_in, y, W) + ((H0,) if fold_h0 else ())):
        raise ValueError("bwd_message_premul needs 16-byte aligned tables")
    G, z = torch.empty_like(y), torch.empty_like(y)
    if n == 0:
        return G, z
    graph = (dst.contiguous(), rev.contiguous(), ptr.contiguous())
    pad_node = ptr.numel() - 2
    lib = library("bwd_premul")
    if tiles is not None:
        gz = (torch.empty_like(y) if fold_h0 else z) if cross is not None else None
        call(lib, "bwd_premul", G_in, y, H0, W, *graph, tiles.contiguous(), G, z,
             gz if fold_h0 else None, n, d, pad_node, tiles.numel() - 1)
        if cross is not None:
            _cross_rows(gz, *graph, cross, G)
    else:  # gz written out (into z itself without fold_h0), then F's node pass
        gz = torch.empty_like(y) if fold_h0 else z
        call(lib, "bwd_premul", G_in, y, H0, W, *graph, None, None, z,
             gz if fold_h0 else None, n, d, pad_node, 0)
        call(library("message_bwd"), "bwd_message", gz, None, None, *graph, G, None, n, d,
             pad_node, 0, DTYPES[gz.dtype])
    LAUNCHES["bwd_message_premul"] += 1
    return G, z


def bwd_message_premul_info(d: int, n_tiles: int) -> dict[str, int]:
    """The shape of :func:`bwd_message_premul`'s launch on the current card
    at width ``d`` over ``n_tiles`` tiles: the width of a block's W^T slice,
    the slices, the G_in stages, the shared memory per block, the grid, and
    the blocks of the kernel that one SM runs at once."""
    import ctypes

    info = (ctypes.c_int * 6)()
    err = library("bwd_premul").bwd_premul_info(d, n_tiles, info)
    if err != 0:
        raise RuntimeError(f"bwd_premul_info: CUDA error {err}")
    keys = ("slice_width", "slices", "stages", "smem_bytes", "grid", "blocks_per_sm")
    return dict(zip(keys, info))


def iter_bwd(
    g: torch.Tensor, y: torch.Tensor, H: torch.Tensor, W: torch.Tensor, src: torch.Tensor,
    dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor, tiles: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dH, gz, dW)``, the whole backward of one bfloat16 iteration
    ``y = relu(H0 + message(H) @ W)`` from the cotangent ``g``: with
    ``gz = g * [y > 0]`` (also ``dH0``) and ``G = (S - R)^T gz`` rounded to
    bfloat16 but never written, ``dH = G @ W^T`` and ``dW = H^T G`` in float32.
    The same bits in every run. ``W`` is ``[d, d]`` in (in, out) layout, ``d``
    a multiple of 128.

    With the batch's tile table ``tiles`` (:func:`check_tiles`; ``d`` one of
    ``ITER_BWD_TILE_WIDTHS``) it is one launch of ``csrc/iter_bwd.cu`` over the
    molecule tiles, and one ordered reduction of its clusters' partial ``dW``;
    without one (a molecule of more than ``ITER2_TILE_ROWS`` rows) the three
    launches of ``csrc/message_bwd.cu``. Both give the same ``gz`` and the
    same ``G``; ``dH`` and ``dW`` sum the same products in another order."""
    _check_graph(g, src, dst, rev, ptr)
    n, d = g.shape
    if g.dtype != torch.bfloat16 or W.dtype != torch.bfloat16:
        raise TypeError("iter_bwd takes bfloat16 tables and W")
    _check_tables(g, {"y": y, "H": H})
    if W.shape != (d, d) or d % 128 != 0 or W.device != g.device or not W.is_contiguous():
        raise ValueError(f"W {tuple(W.shape)} must be a contiguous [d, d] with d % 128 == 0")
    if tiles is not None:
        if d not in ITER_BWD_TILE_WIDTHS:
            raise ValueError(f"the tiled iter_bwd takes d in {ITER_BWD_TILE_WIDTHS}, not {d}")
        check_tiles(tiles, n, g.device)
    if g.device.type == "cpu":
        return iter_bwd_plain(g, y, H, W, src, dst, rev, ptr)
    if any(t.data_ptr() % 16 != 0 for t in (g, y, H, W)):
        raise ValueError("iter_bwd needs 16-byte aligned tables")
    dH, gz = torch.empty_like(g), torch.empty_like(g)
    dW = torch.empty((d, d), dtype=torch.float32, device=g.device)
    graph = (dst.contiguous(), rev.contiguous(), ptr.contiguous())
    if tiles is None:
        lib = library("message_bwd")
        partial = torch.empty((lib.iter_bwd_splits(n), d, d), dtype=torch.float32,
                              device=g.device)
        call(lib, "iter_bwd", g, y, H, W, *graph, dH, gz, partial, dW, n, d, ptr.numel() - 2)
    else:
        lib = library("iter_bwd")
        n_tiles = tiles.numel() - 1
        clusters = lib.iter_bwd_clusters(d, n_tiles)
        if clusters < 1:
            raise RuntimeError(f"iter_bwd: no cluster of {d // 64} blocks fits this card")
        partial = torch.empty((clusters, d, d), dtype=torch.float32, device=g.device)
        call(lib, "iter_bwd_tiles", g, y, H, W, *graph, tiles.contiguous(), dH, gz, partial, dW,
             n, d, ptr.numel() - 2, n_tiles, clusters)
    LAUNCHES["iter_bwd"] += 1
    return dH, gz, dW


def iter_bwd_info(d: int, n_tiles: int) -> dict[str, int]:
    """The shape of the tiled :func:`iter_bwd` launch on the current card at
    width ``d`` over ``n_tiles`` tiles: the blocks of a cluster (``d / 64``
    column boxes), the shared memory per block, the clusters of the grid, and
    the clusters of the kernel that the card runs at once."""
    import ctypes

    info = (ctypes.c_int * 4)()
    err = library("iter_bwd").iter_bwd_info(d, n_tiles, info)
    if err != 0:
        raise RuntimeError(f"iter_bwd_info: CUDA error {err}")
    keys = ("cluster_blocks", "smem_bytes", "clusters", "max_active_clusters")
    return dict(zip(keys, info))


class _Message(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H, src, dst, rev, ptr, tiles):
        ctx.save_for_backward(src, dst, rev, ptr)
        ctx.tiles = tiles
        return _message_fwd(H, src, dst, rev, ptr, tiles)

    @staticmethod
    def backward(ctx, g):
        # the message with the roles of src and dst swapped: F without its
        # mask and without gz, over the same tile table
        G, _ = _transposed(g.contiguous(), None, None, ctx.saved_tensors, ctx.tiles,
                           with_gz=False)
        return G, *(None,) * 5


def _iteration(H, H0, W, b, graph, relu_stream=False, tiles=None):
    """One iteration's forward in either dtype: the fused kernel in bfloat16,
    the message kernel (over the tile table ``tiles``) and a ``torch.matmul``
    in float32."""
    if H0.dtype == torch.bfloat16:
        return fused_iter(H, H0, W, b, *graph, relu_stream=relu_stream)
    z = _message_fwd(torch.relu(H) if relu_stream else H, *graph, tiles) @ W
    if b is not None:
        z = z + b
    return torch.relu(H0 + z)


def _iteration_bwd(g, y, x, W, graph, grad_w: bool, gz_acc=None, tiles=None):
    """``(dH, gz, dW)`` of one iteration with input ``x`` and output ``y``:
    the masked transposed message over the tile table ``tiles``, then
    ``G @ W^T`` (a library product) and ``x^T G`` through :func:`grad_weight`."""
    G, gz = bwd_message(g, y, *graph, gz_acc=gz_acc, tiles=tiles)
    dW = grad_weight(x, G, grad_w and x.dtype == torch.bfloat16)
    return (G @ W.t()).to(g.dtype), gz, dW


def _bias_grad(gz, b):
    return None if b is None else gz.float().sum(0).to(b.dtype)


def first_iter(
    H0: torch.Tensor, W: torch.Tensor, b: torch.Tensor | None, src: torch.Tensor,
    dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor,
    options: KernelOptions | None = None, tiles: torch.Tensor | None = None,
) -> torch.Tensor:
    """The first depth iteration ``relu(H0 + message(relu(H0)) @ W [+ b])`` as a
    differentiable op (cf. ``fused_first_iter``), float32 or bfloat16; in
    bfloat16 ``relu(H0)`` is never written (``relu_stream``), in float32 the
    message goes over the batch's tile table ``tiles``. The backward is
    written by hand: :func:`bwd_message`, then the two products, and the chain
    through the streamed ReLU, ``dH0 = gz + dH * [H0 > 0]``."""
    return _FirstIter.apply(H0, W, b, src, dst, rev, ptr, options or KernelOptions(), tiles)


def message_iter(
    H: torch.Tensor, H0: torch.Tensor, W: torch.Tensor, b: torch.Tensor | None,
    src: torch.Tensor, dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor,
    options: KernelOptions | None = None, tiles: torch.Tensor | None = None,
) -> torch.Tensor:
    """One depth iteration ``relu(H0 + message(H) @ W [+ b])`` as a
    differentiable op (cf. ``fused_message_iter``), float32 or bfloat16; in
    float32 the message goes over the batch's tile table ``tiles``. The
    backward is written by hand: :func:`bwd_message`, then ``G @ W^T`` and
    ``H^T G``; in bfloat16 with ``options.fused_bwd`` one :func:`iter_bwd` over
    the batch's tile table ``tiles``. A batch without one (a molecule larger
    than a tile), or a width the tiled kernel does not take, takes
    :func:`iter_bwd`'s form without a table, and ``UNSERVED["iter_bwd"]``
    counts each such backward."""
    return _MessageIter.apply(H, H0, W, b, src, dst, rev, ptr, options or KernelOptions(), tiles)


class _FirstIter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H0, W, b, src, dst, rev, ptr, options, tiles):
        H0 = H0.contiguous()
        y = _iteration(H0, H0, W, b, (src, dst, rev, ptr), relu_stream=True, tiles=tiles)
        ctx.save_for_backward(y, H0, W, b, src, dst, rev, ptr)
        ctx.options, ctx.tiles = options, tiles
        return y

    @staticmethod
    def backward(ctx, g):
        y, H0, W, b, *graph = ctx.saved_tensors
        g = g.to(y.dtype).contiguous()
        dH, gz, dW = _iteration_bwd(g, y, torch.relu(H0), W, graph, ctx.options.grad_w,
                                    tiles=ctx.tiles)
        dH0 = gz + dH * (H0 > 0)
        return dH0, dW.to(W.dtype), _bias_grad(gz, b), *(None,) * 6


class _MessageIter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H, H0, W, b, src, dst, rev, ptr, options, tiles):
        H, H0 = H.contiguous(), H0.contiguous()
        y = _iteration(H, H0, W, b, (src, dst, rev, ptr), tiles=tiles)
        ctx.save_for_backward(y, H, W, b, src, dst, rev, ptr)
        ctx.options, ctx.tiles = options, tiles
        return y

    @staticmethod
    def backward(ctx, g):
        y, H, W, b, *graph = ctx.saved_tensors
        g = g.to(y.dtype).contiguous()
        if ctx.options.fused_bwd and y.dtype == torch.bfloat16:
            tiles = ctx.tiles if y.shape[1] in ITER_BWD_TILE_WIDTHS else None
            if tiles is None:
                UNSERVED["iter_bwd"] += 1
            dH, gz, dW = iter_bwd(g, y, H, W, *graph, tiles=tiles)
        else:
            dH, gz, dW = _iteration_bwd(g, y, H, W, graph, ctx.options.grad_w,
                                        tiles=ctx.tiles)
        return dH, gz, dW.to(W.dtype), _bias_grad(gz, b), *(None,) * 6


def loop_readout(
    H0: torch.Tensor, W: torch.Tensor, b: torch.Tensor | None, src: torch.Tensor,
    dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor, depth: int,
    options: KernelOptions | None = None, tiles: torch.Tensor | None = None,
    split: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """The whole ReLU depth loop and the M_v readout as one differentiable op
    (cf. ``fused_loop_readout``), for ``depth >= 2``:

        H = relu(H0); repeat depth - 1 times: H = relu(H0 + message(H) @ W [+ b])
        M_v = segment_sum(H, dst)                               [N, d], H0's dtype

    In bfloat16 every iteration is one :func:`fused_iter` kernel; in float32
    the message kernel over the tile table and a ``torch.matmul``. With ``options.iter2``, in
    bfloat16 at ``depth >= 3``, the first two iterations are one
    :func:`fused_iter2` launch over the batch's tile table ``tiles``; a batch
    without one (a molecule larger than a tile), or a width outside
    ``ITER2_WIDTHS``, takes the two launches, and ``UNSERVED["fused_iter2"]``
    counts it. The backward is written by hand. In
    bfloat16 with no bias and ``depth >= 3`` no cotangent edge table is formed
    outside a kernel: :func:`bwd_message_nodes` for the last iteration and
    :func:`bwd_message_premul` for the earlier ones, the first with
    ``fold_h0``, both over the tile table; a batch without one takes its
    split table and cross rows ``split`` (``BatchMolGraph.split_ptr``,
    ``cross_rows``) where it is given; without either they take their forms
    without a table, and ``UNSERVED["bwd_message_nodes"]`` and
    ``UNSERVED["bwd_message_premul"]`` count each such call. Otherwise
    (float32, a bias, depth 2) it is the per-iteration
    chain through :func:`bwd_message` with the running ``dH0`` accumulated in
    the kernel, and ``G @ W^T`` a ``torch.matmul``. The weight gradient
    ``x_t^T G`` goes through :func:`grad_weight` in both: a library product,
    or with ``options.grad_w`` in bfloat16 its kernel."""
    if depth < 2:
        raise ValueError("loop_readout needs depth >= 2")
    return _LoopReadout.apply(H0, W, b, src, dst, rev, ptr, depth, options or KernelOptions(),
                              tiles, split)


def _loop_forward(H0, W, b, graph, depth: int, tiles, iter2: bool = False) -> list:
    """The outputs of iterations 1 .. depth - 1 of the ReLU depth loop: the
    first with ``relu(H0)`` streamed (bfloat16) or formed (float32), each
    later one from the one before; with ``iter2`` (bfloat16, depth >= 3) the
    first two as one :func:`fused_iter2` launch over the tile table."""
    ys = []
    if H0.dtype == torch.bfloat16 and iter2 and depth >= 3:
        if tiles is not None and H0.shape[1] in ITER2_WIDTHS:
            ys = list(fused_iter2(H0, W, b, *graph, tiles))
        else:
            UNSERVED["fused_iter2"] += 1
    if not ys:
        first = H0.dtype == torch.bfloat16  # float32 has no streamed ReLU to save
        ys = [_iteration(H0 if first else torch.relu(H0), H0, W, b, graph, relu_stream=first,
                         tiles=tiles)]
    for _ in range(len(ys) + 1, depth):
        ys.append(_iteration(ys[-1], H0, W, b, graph, tiles=tiles))
    return ys


def _loop_chain_bwd(g, ys, H0, W, b, graph, grad_w: bool, tiles):
    """``(dH0, dW, db)`` of the depth loop whose iterations gave ``ys``, from
    the cotangent ``g`` of the last one's output: the per-iteration chain, each
    step one :func:`bwd_message` over the tile table ``tiles`` with the
    running ``dH0`` accumulated in the kernel (``gz_acc``), ``G @ W^T`` a
    ``torch.matmul`` and ``x_t^T G`` through :func:`grad_weight`; ``db`` is the
    accumulator's column sum."""
    relu_H0 = torch.relu(H0)
    dW, acc = None, None
    for t in range(len(ys), 0, -1):
        x = ys[t - 2] if t >= 2 else relu_H0  # the input of iteration t
        g, acc, dWt = _iteration_bwd(g, ys[t - 1], x, W, graph, grad_w, gz_acc=acc,
                                     tiles=tiles)
        dW = dWt if dW is None else dW + dWt
    # the first iteration's input was relu(H0): chain through the activation
    return acc + g * (H0 > 0), dW.to(W.dtype), _bias_grad(acc, b)


def depth_loop(
    H0: torch.Tensor, W: torch.Tensor, b: torch.Tensor | None, src: torch.Tensor,
    dst: torch.Tensor, rev: torch.Tensor, ptr: torch.Tensor, depth: int,
    options: KernelOptions | None = None, tiles: torch.Tensor | None = None,
) -> torch.Tensor:
    """The whole ReLU depth loop as one differentiable op (cf.
    ``fused_depth_loop``), for ``depth >= 2``; it returns the last ``H``:

        H = relu(H0); repeat depth - 1 times: H = relu(H0 + message(H) @ W [+ b])

    In bfloat16 every iteration is one :func:`fused_iter` kernel (the first
    with ``relu_stream``); in float32 the message kernel over the tile table
    ``tiles`` and a ``torch.matmul``. The backward is written by hand: the
    per-iteration chain from the cotangent of ``H``, each iteration one
    :func:`bwd_message` that adds the running ``dH0`` in the kernel, the
    weight gradients through :func:`grad_weight` (its kernel with
    ``options.grad_w`` in bfloat16), ``db`` the sum of the accumulator."""
    if depth < 2:
        raise ValueError("depth_loop needs depth >= 2")
    return _DepthLoop.apply(H0, W, b, src, dst, rev, ptr, depth, options or KernelOptions(), tiles)


class _DepthLoop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H0, W, b, src, dst, rev, ptr, depth, options, tiles):
        H0 = H0.contiguous()
        ys = _loop_forward(H0, W, b, (src, dst, rev, ptr), depth, tiles)
        ctx.save_for_backward(H0, W, b, src, dst, rev, ptr, *ys)
        ctx.grad_w = options.grad_w and H0.dtype == torch.bfloat16
        ctx.tiles = tiles
        return ys[-1]

    @staticmethod
    def backward(ctx, g):
        H0, W, b, src, dst, rev, ptr, *ys = ctx.saved_tensors
        g = g.to(H0.dtype).contiguous()
        grads = _loop_chain_bwd(g, ys, H0, W, b, (src, dst, rev, ptr), ctx.grad_w, ctx.tiles)
        return *grads, *(None,) * 7


class _LoopReadout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H0, W, b, src, dst, rev, ptr, depth, options, tiles, split):
        graph = (src, dst, rev, ptr)
        H0 = H0.contiguous()
        ys = _loop_forward(H0, W, b, graph, depth, tiles, options.iter2)
        ctx.save_for_backward(H0, W, b, *graph, *ys)
        ctx.depth, ctx.grad_w = depth, options.grad_w and H0.dtype == torch.bfloat16
        ctx.tiles, ctx.split = tiles, split
        return _segment_sum(ys[-1], dst, ptr, H0.dtype, False)[0]

    @staticmethod
    def backward(ctx, g_Mv):
        H0, W, b, src, dst, rev, ptr, *ys = ctx.saved_tensors
        graph = (src, dst, rev, ptr)
        depth, dt, grad_w = ctx.depth, H0.dtype, ctx.grad_w
        g_Mv = g_Mv.to(dt).contiguous()
        none = (None,) * 8
        if dt == torch.bfloat16 and b is None and depth >= 3:
            relu_H0 = torch.relu(H0)

            def x_of(t):  # the input of iteration t
                return ys[t - 2] if t >= 2 else relu_H0

            tiles, cross = ctx.tiles, None
            if tiles is None and ctx.split is not None:
                tiles, cross = ctx.split
            if tiles is None:
                UNSERVED["bwd_message_nodes"] += 1
            G, dH0 = bwd_message_nodes(g_Mv, ys[-1], *graph, tiles=tiles, cross=cross)
            dW = grad_weight(x_of(depth - 1), G, grad_w)
            for t in range(depth - 2, 0, -1):
                if tiles is None:
                    UNSERVED["bwd_message_premul"] += 1
                G, z = bwd_message_premul(G, ys[t - 1], H0, W, *graph, fold_h0=t == 1,
                                          tiles=tiles, cross=cross)
                dW = dW + grad_weight(x_of(t), G, grad_w)
                dH0 = dH0 + z
            return dH0, dW.to(W.dtype), None, *none
        # the per-iteration chain, from the cotangent of the last H
        return *_loop_chain_bwd(g_Mv[dst.long()], ys, H0, W, b, graph, grad_w, ctx.tiles), *none
