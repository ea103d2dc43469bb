"""Padded batches of molecular graphs as tensors (cf.
``chemprop_tpu/data/collate.py``).

The padding conventions are the JAX package's, so that both packages see the
same tables:

* nodes and edges of all graphs are concatenated and padded to bucketed
  sizes (``N_pad``/``E_pad``); padding edges have ``src = dst = pad node``,
  the last node row;
* padding nodes belong to the sacrificial graph ``n_graphs``;
* ``rev`` is the reverse-edge permutation, the identity on padding;
* edges are stable-sorted by ``dst``.

In place of the TPU kernels' window stamps, a batch carries the CSR row
pointers the CUDA kernels read: ``edge_ptr`` over the sorted ``dst``
(the in-edges of node ``v`` are rows ``[edge_ptr[v], edge_ptr[v+1])``) and
``node_ptr`` over ``batch`` (the nodes of graph ``g``). A molecule's edge rows
are contiguous (``edge_ptr[node_ptr[g]] .. edge_ptr[node_ptr[g+1]]``), and
``tile_ptr`` packs whole molecules into runs of at most ``ITER2_TILE_ROWS``
rows for the chained two-iteration kernel (:func:`iter2_tiles`). A batch
holding a molecule of more rows than that has no ``tile_ptr``; it carries
``split_ptr`` instead, where such a molecule spans several tiles cut at its
nodes' boundaries (:func:`split_tiles`), and ``cross_rows``, the rows whose
transposed message reads a row of another tile (:func:`cross_rows`): the
last iterations' backward kernels G and H take that table and form those
rows in a second pass."""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Iterable, NamedTuple, Sequence

import numpy as np
import torch

from chemprop_tpu_torch.ops.message import ITER2_TILE_ROWS, tiles_to
from chemprop_tpu_torch.types import MolGraph


@dataclass(frozen=True)
class BatchMolGraph:
    V: torch.Tensor  # [N_pad, d_v] float32
    E: torch.Tensor  # [E_pad, d_e] float32
    src: torch.Tensor  # [E_pad] int32: source node of each directed edge
    dst: torch.Tensor  # [E_pad] int32: destination node, ascending
    rev: torch.Tensor  # [E_pad] int32: index of the reverse directed edge
    batch: torch.Tensor  # [N_pad] int32: owning graph id (padding -> n_graphs)
    edge_ptr: torch.Tensor  # [N_pad + 1] int32: CSR of dst
    node_ptr: torch.Tensor  # [n_graphs + 2] int32: CSR of batch
    node_mask: torch.Tensor  # [N_pad] bool
    edge_mask: torch.Tensor  # [E_pad] bool
    n_graphs: int
    # [n_tiles + 1] int32 row offsets of the edge tiles, or None where a
    # molecule has more edge rows than a tile holds
    tile_ptr: torch.Tensor | None = None
    # whether the last node row is padding, so that only padding edges name it
    # (the row gather's zero rule); the collate always reserves it. None: not
    # known on the host, read from node_mask
    last_node_padding: bool | None = None
    # where tile_ptr is None: [n_tiles + 1] int32 row offsets of tiles that
    # cut the larger molecules at their nodes' boundaries, and the ascending
    # int32 rows whose transposed message reads a row of another tile
    split_ptr: torch.Tensor | None = None
    cross_rows: torch.Tensor | None = None

    def __len__(self) -> int:
        return self.n_graphs

    def last_node_is_padding(self) -> bool:
        if self.last_node_padding is None:
            return not bool(self.node_mask[-1])
        return self.last_node_padding

    def to(self, device: str | torch.device) -> "BatchMolGraph":
        """The batch on ``device``; the tile tables are checked before they
        move, so that the tile kernels need not read them back
        (``ops.message.tiles_to``)."""
        tables = ("tile_ptr", "split_ptr")
        moved = {
            f.name: getattr(self, f.name).to(device, non_blocking=True)
            for f in fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor) and f.name not in tables
        }
        for name in tables:
            if getattr(self, name) is not None:
                moved[name] = tiles_to(getattr(self, name), self.E.shape[0], device)
        return replace(self, **moved)


def pad_to_bucket(n: int, multiple: int = 128, ratio: float = 1.1) -> int:
    """Smallest bucket >= n from a geometric-ish ladder: multiples of
    ``multiple`` up to 4x, then geometric with ``ratio`` rounded to
    ``multiple``."""
    if n <= multiple:
        return multiple
    if n <= 4 * multiple:
        return -(-n // multiple) * multiple
    b = 4 * multiple
    while b < n:
        b = -(-int(b * ratio) // multiple) * multiple
    return b


def iter2_tiles(graph_ptr: np.ndarray, n_edges: int) -> np.ndarray | None:
    """Row offsets that cut ``n_edges`` sorted edge rows into tiles of at most
    ``ITER2_TILE_ROWS`` rows with no molecule in two tiles: each tile takes as
    many whole molecules as fit (``graph_ptr[g] .. graph_ptr[g+1]`` are the
    rows of molecule ``g``); the rows past ``graph_ptr[-1]``, the padding
    edges, are cut every ``ITER2_TILE_ROWS`` rows. None if a molecule has more
    rows than a tile."""
    bounds = np.unique(np.asarray(graph_ptr, dtype=np.int64))
    if bounds.size > 1 and np.diff(bounds).max() > ITER2_TILE_ROWS:
        return None
    return _pack_tiles(bounds, n_edges)


def split_tiles(graph_ptr: np.ndarray, node_ptr: np.ndarray, n_edges: int) -> np.ndarray | None:
    """:func:`iter2_tiles` for a batch that holds molecules of more rows than
    a tile: such a molecule may be cut at the boundaries of its nodes
    (``node_ptr[v] .. node_ptr[v+1]`` are the rows of node ``v``, its
    in-edges), every other molecule stays whole. None if a node has more
    rows than a tile."""
    tile = ITER2_TILE_ROWS
    bounds = np.unique(np.asarray(graph_ptr, dtype=np.int64))
    node_ptr = np.asarray(node_ptr, dtype=np.int64)
    cuts = [bounds]
    for i in np.flatnonzero(np.diff(bounds) > tile):
        lo, hi = bounds[i], bounds[i + 1]
        cuts.append(node_ptr[(node_ptr > lo) & (node_ptr < hi)])
    bounds = np.unique(np.concatenate(cuts))
    if bounds.size > 1 and np.diff(bounds).max() > tile:
        return None
    return _pack_tiles(bounds, n_edges)


def cross_rows(tiles: np.ndarray, dst: np.ndarray, rev: np.ndarray, n_real: int) -> np.ndarray:
    """The real rows ``e`` of a tile table whose transposed message
    ``sum_{j in in(dst[e])} gz[rev[j]] - gz[rev[e]]`` reads a row of another
    tile: every row of a node one of whose in-edges has its reverse in
    another tile (the node's own rows lie in one tile, and ``e`` is one of
    them). Ascending int32; empty where no molecule spans two tiles."""
    tile_of = np.searchsorted(tiles, np.arange(n_real), side="right") - 1
    crossing = tile_of[rev[:n_real]] != tile_of
    node_crosses = np.zeros(int(dst[:n_real].max(initial=-1)) + 1, dtype=bool)
    node_crosses[dst[:n_real][crossing]] = True
    return np.flatnonzero(node_crosses[dst[:n_real]]).astype(np.int32)


def _pack_tiles(bounds: np.ndarray, n_edges: int) -> np.ndarray:
    """Greedy tiles of at most ``ITER2_TILE_ROWS`` rows cut only at
    ``bounds`` (ascending, no gap wider than a tile), then the rows past the
    last bound every ``ITER2_TILE_ROWS`` rows."""
    tile = ITER2_TILE_ROWS
    # the last boundary a tile that starts at boundary i can reach
    reach = np.searchsorted(bounds, bounds + tile, side="right") - 1
    offsets, i = [int(bounds[0])], 0
    while i < bounds.size - 1:
        i = int(reach[i])
        offsets.append(int(bounds[i]))
    offsets += list(range(offsets[-1] + tile, n_edges, tile))
    if offsets[-1] != n_edges:
        offsets.append(n_edges)
    return np.asarray(offsets, dtype=np.int32)


class PadSpec(NamedTuple):
    n_nodes: int
    n_edges: int
    n_graphs: int

    @classmethod
    def for_graphs(cls, mgs: Sequence[MolGraph], n_graphs: int | None = None) -> "PadSpec":
        n_nodes = pad_to_bucket(sum(mg.V.shape[0] for mg in mgs) + 1)  # >=1 padding row
        # the JAX package's edge ladder, aligned to a 512-multiple, so that
        # both packages batch to the same shapes
        n_edges = -(-pad_to_bucket(max(1, sum(mg.E.shape[0] for mg in mgs))) // 512) * 512
        return cls(n_nodes, n_edges, n_graphs or len(mgs))


def batch_mol_graphs(
    mgs: Sequence[MolGraph], pad: PadSpec | None = None, return_perm: bool = False
) -> BatchMolGraph:
    """Disjoint union of ``mgs`` with static-shape padding and edges sorted
    by destination. ``return_perm=True`` also returns the sort permutation
    (row ``i`` of the sorted edge table is row ``perm[i]`` of the
    concatenation). The batch lies on the CPU; move it with ``.to``."""
    pad = pad or PadSpec.for_graphs(mgs)
    n_real_nodes = sum(mg.V.shape[0] for mg in mgs)
    n_real_edges = sum(mg.E.shape[0] for mg in mgs)
    if n_real_nodes >= pad.n_nodes:
        raise ValueError(
            f"pad.n_nodes={pad.n_nodes} must exceed total node count {n_real_nodes} "
            "(one padding row is required)"
        )
    if n_real_edges > pad.n_edges:
        raise ValueError(f"pad.n_edges={pad.n_edges} < total edge count {n_real_edges}")
    if len(mgs) > pad.n_graphs:
        raise ValueError(f"pad.n_graphs={pad.n_graphs} < batch size {len(mgs)}")

    d_v = mgs[0].V.shape[1]
    d_e = mgs[0].E.shape[1]
    V = np.zeros((pad.n_nodes, d_v), dtype=np.float32)
    E = np.zeros((pad.n_edges, d_e), dtype=np.float32)
    pad_node = pad.n_nodes - 1
    src = np.full(pad.n_edges, pad_node, dtype=np.int32)
    dst = np.full(pad.n_edges, pad_node, dtype=np.int32)
    rev = np.arange(pad.n_edges, dtype=np.int32)  # identity on padding
    batch = np.full(pad.n_nodes, pad.n_graphs, dtype=np.int32)
    node_mask = np.zeros(pad.n_nodes, dtype=bool)
    edge_mask = np.zeros(pad.n_edges, dtype=bool)

    nvs = np.fromiter((mg.V.shape[0] for mg in mgs), np.int64, len(mgs))
    nes = np.fromiter((mg.E.shape[0] for mg in mgs), np.int64, len(mgs))
    v_offs = np.concatenate([[0], np.cumsum(nvs)[:-1]])
    e_offs = np.concatenate([[0], np.cumsum(nes)[:-1]])
    V[:n_real_nodes] = np.concatenate([mg.V for mg in mgs], 0)
    if n_real_edges:
        E[:n_real_edges] = np.concatenate([mg.E for mg in mgs if mg.E.shape[0]], 0)
        ei = np.concatenate([mg.edge_index for mg in mgs if mg.E.shape[0]], 1)
        e_node_off = np.repeat(v_offs, nes).astype(np.int32)
        src[:n_real_edges] = ei[0] + e_node_off
        dst[:n_real_edges] = ei[1] + e_node_off
        rev[:n_real_edges] = np.concatenate(
            [mg.rev_edge_index for mg in mgs if mg.E.shape[0]]
        ) + np.repeat(e_offs, nes).astype(np.int32)
    batch[:n_real_nodes] = np.repeat(np.arange(len(mgs), dtype=np.int32), nvs)
    node_mask[:n_real_nodes] = True
    edge_mask[:n_real_edges] = True

    # stable sort by destination; padding edges (dst = pad_node, the largest
    # index) land at the tail, and rev is remapped through the permutation
    perm = np.argsort(dst, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    E, src, dst, edge_mask = E[perm], src[perm], dst[perm], edge_mask[perm]
    rev = inv[rev[perm]]

    edge_ptr = np.searchsorted(dst, np.arange(pad.n_nodes + 1)).astype(np.int32)
    node_ptr = np.searchsorted(batch, np.arange(pad.n_graphs + 2)).astype(np.int32)
    # rows of graph g; padding nodes other than the last own no edge, so the
    # last offset is the first padding row
    graph_rows = edge_ptr[node_ptr[: pad.n_graphs + 1]]
    tiles = iter2_tiles(graph_rows, pad.n_edges)
    split = crossing = None
    if tiles is None:
        split = split_tiles(graph_rows, edge_ptr[: n_real_nodes + 1], pad.n_edges)
        if split is not None:
            crossing = cross_rows(split, dst, rev, n_real_edges)

    t = torch.from_numpy
    bmg = BatchMolGraph(
        V=t(V),
        E=t(E),
        src=t(src),
        dst=t(dst),
        rev=t(rev),
        batch=t(batch),
        edge_ptr=t(edge_ptr),
        node_ptr=t(node_ptr),
        node_mask=t(node_mask),
        edge_mask=t(edge_mask),
        n_graphs=pad.n_graphs,
        tile_ptr=None if tiles is None else t(tiles),
        last_node_padding=True,  # n_real_nodes < pad.n_nodes, checked above
        split_ptr=None if split is None else t(split),
        cross_rows=None if crossing is None else t(crossing),
    )
    return (bmg, perm) if return_perm else bmg


class TrainingBatch(NamedTuple):
    """The JAX package's fields in its order, so that a batch unpacks the same
    way: ``bmg, V_d, X_d, Y, w, lt_mask, gt_mask``."""

    bmg: BatchMolGraph
    V_d: torch.Tensor | None  # [N_pad, d_vd] float32 atom descriptors; padding rows 0
    X_d: torch.Tensor | None  # [B, d_xd] float32 molecule descriptors; padding rows 0
    Y: torch.Tensor | None  # [B, t] float32; padding rows are NaN, masked by isfinite
    w: torch.Tensor  # [B, 1] float32 sample weights; padding rows are 0
    lt_mask: torch.Tensor | None = None  # [B, t] bool; padding rows False
    gt_mask: torch.Tensor | None = None

    @property
    def pad_mask(self) -> np.ndarray:
        """[B] bool: True for real samples."""
        return self.w.reshape(-1).cpu().numpy() > 0

    def to(self, device: str | torch.device) -> "TrainingBatch":
        def move(x):
            return None if x is None else x.to(device, non_blocking=True)

        return TrainingBatch(self.bmg.to(device), move(self.V_d), move(self.X_d), move(self.Y),
                             move(self.w), move(self.lt_mask), move(self.gt_mask))


def collate_batch(data: Iterable, pad: PadSpec | None = None) -> TrainingBatch:
    """Collate ``Datum`` tuples ``(mg, V_d, x_d, y, weight, lt_mask,
    gt_mask)`` into a padded :class:`TrainingBatch`. Padding samples get NaN
    targets, zero weight and false bounds, so that the masked loss ignores
    them; padding rows of the descriptors are zero."""
    mgs, V_ds, x_ds, ys, weights, lt_masks, gt_masks = zip(*data)
    pad = pad or PadSpec.for_graphs(mgs)
    bmg = batch_mol_graphs(mgs, pad)
    b_real, b_pad = len(mgs), pad.n_graphs
    t = torch.from_numpy
    V_d = None
    if V_ds[0] is not None:
        V_d = np.zeros((pad.n_nodes, V_ds[0].shape[1]), dtype=np.float32)
        v0 = 0
        for mg, vd in zip(mgs, V_ds):
            if vd is not None:
                V_d[v0 : v0 + vd.shape[0]] = vd
            v0 += mg.V.shape[0]
    X_d = None
    if x_ds[0] is not None:
        X_d = np.zeros((b_pad, len(x_ds[0])), dtype=np.float32)
        X_d[:b_real] = np.array(x_ds, dtype=np.float32)
    Y = None
    if ys[0] is not None:
        Y = np.full((b_pad, len(ys[0])), np.nan, dtype=np.float32)
        Y[:b_real] = np.array(ys, dtype=np.float32)
    w = np.zeros((b_pad, 1), dtype=np.float32)
    w[:b_real, 0] = weights
    bounds = []
    for masks in (lt_masks, gt_masks):
        m = None
        if masks[0] is not None:
            m = np.zeros((b_pad, len(masks[0])), dtype=bool)
            m[:b_real] = np.array(masks)
        bounds.append(m)
    return TrainingBatch(bmg, *(None if x is None else t(x) for x in (V_d, X_d, Y)), t(w),
                         *(None if m is None else t(m) for m in bounds))
