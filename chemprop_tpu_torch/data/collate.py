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
transposed message reads a row of another tile (:func:`cross_rows`). The
message A, its transpose F, the last iterations' backward kernels G and H
and the fused backward E take that table and form those rows in a second
pass; one list serves all five, since every row whose message reads another
tile (its reverse lies there) is one whose transposed message does. The
chained iterations D take it with two lists of their own (:func:`iter2_rows`):
``y1_rows``, the rows the first iteration cannot form in its tile, and
``y2_rows``, those the second cannot form given those. A mol-atom-bond batch
(:func:`collate_mol_atom_bond_batch`) is such a graph with the per-atom
tables on its node rows and the per-bond tables on both of a bond's
directed edges, in the sorted order."""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from functools import partial
from typing import Iterable, NamedTuple, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

from chemprop_tpu_torch.ops.message import ITER2_TILE_ROWS, cross_to, mark_table, tiles_to
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
    # whether the last edge row is padding, so that only it names itself as
    # its reverse (the zero rule of the row gather by rev); None: read from
    # edge_mask
    last_edge_padding: bool | None = None
    # beside split_ptr: the ascending int32 rows that the chained iterations
    # (kernel D) cannot form in their tile, in the first iteration and, given
    # those, in the second (iter2_rows)
    y1_rows: torch.Tensor | None = None
    y2_rows: torch.Tensor | None = None

    def __len__(self) -> int:
        return self.n_graphs

    def last_node_is_padding(self) -> bool:
        if self.last_node_padding is None:
            return not bool(self.node_mask[-1])
        return self.last_node_padding

    def last_edge_is_padding(self) -> bool:
        if self.last_edge_padding is None:
            return not bool(self.edge_mask[-1])
        return self.last_edge_padding

    def to(self, device: str | torch.device) -> "BatchMolGraph":
        """The batch on ``device``; the tile tables and the row lists are
        checked before they move, so that the kernels need not read them back,
        and each table is marked whole or split (``ops.message.tiles_to``,
        ``ops.message.cross_to``)."""
        tables = {"tile_ptr": tiles_to, "split_ptr": partial(tiles_to, split=True),
                  **{name: cross_to for name in ROW_LISTS}}
        moved = {
            f.name: getattr(self, f.name).to(device, non_blocking=True)
            for f in fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor) and f.name not in tables
        }
        for name, move in tables.items():
            if getattr(self, name) is not None:
                moved[name] = move(getattr(self, name), self.E.shape[0], device)
        return replace(self, **moved)


# the row lists that come with a split table: the passes' rows
ROW_LISTS = ("cross_rows", "y1_rows", "y2_rows")


# BatchMolGraph as a pytree node (cf. the JAX package's registration for
# jax.export): the tensor fields are its children, None where a table is
# absent, and the static ones (n_graphs and the two padding flags) its
# context, which a traced program fixes
_STATIC = ("n_graphs", "last_node_padding", "last_edge_padding")
TENSOR_FIELDS = tuple(f.name for f in fields(BatchMolGraph) if f.name not in _STATIC)


def _flatten_bmg(bmg: BatchMolGraph):
    return [getattr(bmg, name) for name in TENSOR_FIELDS], tuple(getattr(bmg, n) for n in _STATIC)


def _flatten_bmg_with_keys(bmg: BatchMolGraph):
    children, context = _flatten_bmg(bmg)
    return [(pytree.GetAttrKey(n), c) for n, c in zip(TENSOR_FIELDS, children)], context


def _unflatten_bmg(children, context) -> BatchMolGraph:
    return BatchMolGraph(**dict(zip(TENSOR_FIELDS, children)), **dict(zip(_STATIC, context)))


pytree.register_pytree_node(
    BatchMolGraph, _flatten_bmg, _unflatten_bmg,
    serialized_type_name="chemprop_tpu_torch.data.collate.BatchMolGraph",
    to_dumpable_context=list, from_dumpable_context=tuple,
    flatten_with_keys_fn=_flatten_bmg_with_keys,
)


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


def iter2_rows(tiles: np.ndarray, src: np.ndarray, rev: np.ndarray, edge_ptr: np.ndarray,
               n_real: int) -> tuple[np.ndarray, np.ndarray]:
    """The rows of the chained two iterations (kernel D, ``csrc/iter2.cu``)
    that D cannot form inside their tile: first the real rows ``e`` whose
    message ``sum_{k in in(src[e])} H[k] - H[rev[e]]`` reads a row of another
    tile (D's own rule: the in-edge range of ``src[e]`` or ``rev[e]`` leaves
    ``e``'s tile); then, given those, the rows whose second message reads one
    of them, or itself leaves the tile. Each ascending int32, empty where no
    molecule spans two tiles. The first list is within :func:`cross_rows`,
    the second is not: a row of a node whose in-edges are all whole may read
    a row of the first list."""
    e = np.arange(n_real)
    tile_of = np.searchsorted(tiles, e, side="right") - 1
    t0, t1 = tiles[tile_of], tiles[tile_of + 1]
    s = src[:n_real]
    lo, hi, rv = edge_ptr[s], edge_ptr[s + 1], rev[:n_real]
    leaves = (lo < t0) | (hi > t1) | (rv < t0) | (rv >= t1)
    first = np.zeros(len(rev), dtype=bool)
    first[:n_real] = leaves
    seen = np.concatenate([[0], np.cumsum(first)])  # listed rows before each row
    second = leaves | (seen[hi] > seen[lo])  # rev[e] is one of src[e]'s in-edges
    return np.flatnonzero(leaves).astype(np.int32), np.flatnonzero(second).astype(np.int32)


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
    split = crossing = rows1 = rows2 = None
    if tiles is None:
        split = split_tiles(graph_rows, edge_ptr[: n_real_nodes + 1], pad.n_edges)
        if split is not None:
            crossing = cross_rows(split, dst, rev, n_real_edges)
            rows1, rows2 = iter2_rows(split, src, rev, edge_ptr, n_real_edges)

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
        split_ptr=None if split is None else mark_table(t(split), split=True),
        cross_rows=None if crossing is None else t(crossing),
        last_edge_padding=n_real_edges < pad.n_edges,
        y1_rows=None if rows1 is None else t(rows1),
        y2_rows=None if rows2 is None else t(rows2),
    )
    if tiles is not None:
        mark_table(bmg.tile_ptr, split=False)
    return (bmg, perm) if return_perm else bmg


def _move(x, device):
    """A batch field on ``device``: a tensor, a graph, None, or a tuple of
    them."""
    if isinstance(x, tuple):
        return tuple(_move(part, device) for part in x)
    if isinstance(x, BatchMolGraph):
        return x.to(device)
    return None if x is None else x.to(device, non_blocking=True)


class TrainingBatch(NamedTuple):
    """The JAX package's fields in its order, so that a batch unpacks the same
    way: ``bmg, V_d, X_d, Y, w, lt_mask, gt_mask``. A multicomponent batch
    (:func:`collate_multicomponent`) holds a tuple of graphs in ``bmg``, one
    per component, and a tuple of their atom descriptors (or None) in
    ``V_d``."""

    bmg: BatchMolGraph | tuple[BatchMolGraph, ...]
    V_d: torch.Tensor | tuple | None  # [N_pad, d_vd] float32 atom descriptors; padding rows 0
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
        return TrainingBatch(*(_move(x, device) for x in self))

    @property
    def graphs(self) -> tuple[BatchMolGraph, ...]:
        """The batch's graphs: one, or one per component."""
        return self.bmg if isinstance(self.bmg, tuple) else (self.bmg,)


def collate_batch(data: Iterable, pad: PadSpec | None = None, n_targets: int | None = None
                  ) -> TrainingBatch:
    """Collate ``Datum`` tuples ``(mg, V_d, x_d, y, weight, lt_mask,
    gt_mask)`` into a padded :class:`TrainingBatch`. Padding samples get NaN
    targets, zero weight and false bounds, so that the masked loss ignores
    them; padding rows of the descriptors are zero. ``n_targets``, where it
    is given, is the number of target columns of ``Y`` (else the first
    datum's)."""
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
        Y = np.full((b_pad, len(ys[0]) if n_targets is None else n_targets), np.nan,
                    dtype=np.float32)
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


def collate_multicomponent(data: Iterable, pads: Sequence[PadSpec | None] | None = None
                           ) -> TrainingBatch:
    """Collate rows of per-component ``Datum`` lists (cf.
    ``collate_multicomponent`` of ``chemprop_tpu/data/collate.py``): each
    component is collated on its own, into a padded graph with its own tile
    table (or split table and cross rows); ``bmg`` and ``V_d`` are tuples of
    the components' (``V_d`` None where no component has atom descriptors),
    and the targets, weights, bounds and ``X_d`` are component 0's."""
    rows = list(data)
    columns = [[row[i] for row in rows] for i in range(len(rows[0]))]
    tbs = [collate_batch(col, pad) for col, pad in zip(columns, pads or [None] * len(columns))]
    first = tbs[0]
    V_d = tuple(tb.V_d for tb in tbs) if any(tb.V_d is not None for tb in tbs) else None
    return TrainingBatch(tuple(tb.bmg for tb in tbs), V_d, first.X_d, first.Y, first.w,
                         first.lt_mask, first.gt_mask)


class MABTrainingBatch(NamedTuple):
    """A mol-atom-bond batch (cf. ``MABTrainingBatch`` of
    ``chemprop_tpu/data/collate.py``), the JAX package's fields in its order:
    the targets ``Ys``, weights ``ws`` and bounds' masks per kind (mol,
    atom, bond): molecule tables ``[B, t]``, atom tables ``[N_pad, ta]`` on
    the node rows, bond tables ``[E_pad, tb]`` on both directed edges of each
    bond in the sorted edge order, NaN targets and zero weights on padding.
    A bond's weight counts on its primary edge alone (``e < rev[e]``), so
    that each bond counts once. ``constraints`` is ``(atom [B, ca] or None,
    bond [B, cb] or None)`` or None; ``E_d`` the bond descriptors on the
    directed edges; ``edge_origin`` the sort permutation (row ``i`` of the
    sorted edges is directed edge ``edge_origin[i]`` of the concatenation,
    bond ``edge_origin[i] // 2``)."""

    bmg: BatchMolGraph
    V_d: torch.Tensor | None
    E_d: torch.Tensor | None
    X_d: torch.Tensor | None
    Ys: tuple
    ws: tuple
    lt_masks: tuple
    gt_masks: tuple
    constraints: tuple | None
    edge_origin: np.ndarray | None = None

    def to(self, device: str | torch.device) -> "MABTrainingBatch":
        """The batch on ``device``; ``edge_origin`` stays a host array."""
        return MABTrainingBatch(*(_move(x, device) for x in self[:-1]), self.edge_origin)

    @property
    def graphs(self) -> tuple[BatchMolGraph, ...]:
        return (self.bmg,)

    @property
    def pad_mask(self) -> np.ndarray:
        """[B] bool: True for real samples."""
        return self.ws[0].reshape(-1).cpu().numpy() > 0


def collate_mol_atom_bond_batch(data: Iterable, pad: PadSpec | None = None) -> MABTrainingBatch:
    """Collate ``MABDatum`` rows into a padded :class:`MABTrainingBatch` (cf.
    ``collate_mol_atom_bond_batch`` of ``chemprop_tpu/data/collate.py``): the
    graph and its tile table as :func:`batch_mol_graphs` makes them, the
    per-atom tables packed onto the node rows, the per-bond ones repeated
    onto both directed edges and routed through the sort permutation."""
    rows = list(data)
    mgs = [r.mg for r in rows]
    pad = pad or PadSpec.for_graphs(mgs)
    bmg, perm = batch_mol_graphs(mgs, pad, return_perm=True)
    b_real, b_pad = len(rows), pad.n_graphs
    nvs = np.array([mg.V.shape[0] for mg in mgs], dtype=np.int64)
    nes = np.array([mg.E.shape[0] for mg in mgs], dtype=np.int64)
    n_nodes, n_edges = int(nvs.sum()), int(nes.sum())

    def pack_nodes(values, width, fill=0.0):
        out = np.full((pad.n_nodes, width), fill, dtype=np.float32)
        out[:n_nodes] = np.concatenate([
            np.zeros((nv, width), np.float32) if v is None else np.reshape(v, (-1, width))
            for v, nv in zip(values, nvs)])
        return out

    def pack_edges(values, width, fill=0.0):
        out = np.full((pad.n_edges, width), fill, dtype=np.float32)
        if n_edges:
            out[:n_edges] = np.repeat(np.concatenate([
                np.zeros((ne // 2, width), np.float32) if v is None
                else np.reshape(v, (-1, width)) for v, ne in zip(values, nes)]), 2, axis=0)
        return out[perm]

    def width(v) -> int:
        return v.shape[1] if v.ndim > 1 else 1

    def per_mol(values, dtype=np.float32, fill=np.nan):
        out = np.full((b_pad, len(values[0])), fill, dtype=dtype)
        out[:b_real] = np.array(values, dtype=dtype)
        return out

    V_d = None if rows[0].V_d is None else pack_nodes([r.V_d for r in rows],
                                                      rows[0].V_d.shape[1])
    E_d = None if rows[0].E_d is None else pack_edges([r.E_d for r in rows],
                                                      rows[0].E_d.shape[1])
    X_d = None if rows[0].x_d is None else per_mol([r.x_d for r in rows], fill=0.0)

    mol_ys, atom_ys, bond_ys = ([r.ys[k] for r in rows] for k in range(3))
    Ys = (None if mol_ys[0] is None else per_mol(mol_ys),
          None if atom_ys[0] is None else pack_nodes(atom_ys, atom_ys[0].shape[1], np.nan),
          None if bond_ys[0] is None else pack_edges(bond_ys, width(bond_ys[0]), np.nan))

    def masks(triples):
        mol, atom, bond = ([tr[k] for tr in triples] for k in range(3))
        return (None if mol[0] is None else per_mol(mol, bool, False),
                None if atom[0] is None else pack_nodes(atom, atom[0].shape[1]).astype(bool),
                None if bond[0] is None else pack_edges(bond, width(bond[0])).astype(bool))

    lt_masks, gt_masks = masks([r.lt_masks for r in rows]), masks([r.gt_masks for r in rows])

    w_dp = np.array([r.weight for r in rows], dtype=np.float32)
    w_mol = np.zeros((b_pad, 1), dtype=np.float32)
    w_mol[:b_real, 0] = w_dp
    w_atom = np.zeros((pad.n_nodes, 1), dtype=np.float32)
    w_atom[:n_nodes, 0] = np.repeat(w_dp, nvs)
    w_bond = np.zeros((pad.n_edges, 1), dtype=np.float32)
    w_bond[:n_edges, 0] = np.repeat(w_dp, nes)
    rev, edge_mask = bmg.rev.numpy(), bmg.edge_mask.numpy()
    primary = (np.arange(pad.n_edges) < rev) & edge_mask
    w_bond = w_bond[perm] * primary[:, None]

    constraints = None
    if rows[0].constraints is not None:
        ac, bc = ([r.constraints[k] for r in rows] for k in range(2))
        atom_c = None if ac[0] is None else per_mol(ac, fill=0.0)
        bond_c = None if bc[0] is None else per_mol(bc, fill=0.0)
        if atom_c is not None or bond_c is not None:
            constraints = (atom_c, bond_c)

    t = torch.from_numpy

    def tensors(xs):
        return tuple(None if x is None else t(x) for x in xs)

    return MABTrainingBatch(bmg, *tensors((V_d, E_d, X_d)), tensors(Ys),
                            tensors((w_mol, w_atom, w_bond)), tensors(lt_masks),
                            tensors(gt_masks),
                            None if constraints is None else tensors(constraints),
                            np.asarray(perm))


# --------------------------------------------------------------------------
# sharded batches: a rank's self-contained padded shard of a global batch
# --------------------------------------------------------------------------


def partition_shards(sizes: Sequence[int], n_shards: int) -> list[list[int]]:
    """Deterministic LPT partition of items into ``n_shards`` load-balanced
    groups of at most ``ceil(n / n_shards)`` items (the JAX package's, bit
    for bit): each item, largest first, joins the open group of least load.
    Each graph's loss and gradient are independent and summed over the
    shards, so the assignment never changes the result."""
    sizes = np.asarray(list(sizes), dtype=np.int64)
    cap = -(-len(sizes) // max(n_shards, 1))
    order = np.argsort(-sizes, kind="stable")
    loads = np.zeros(n_shards, dtype=np.int64)
    groups: list[list[int]] = [[] for _ in range(n_shards)]
    for i in order:
        open_shards = [k for k in range(n_shards) if len(groups[k]) < cap]
        k = min(open_shards, key=lambda k: (loads[k], k))
        groups[k].append(int(i))
        loads[k] += sizes[i]
    return [sorted(g) for g in groups]


def _empty_like_bmg(bmg: BatchMolGraph) -> BatchMolGraph:
    """An all-padding graph of ``bmg``'s shape: every edge runs from the last
    node to itself, every node is in the sacrificial graph."""
    n_nodes, n_edges = bmg.V.shape[0], bmg.E.shape[0]
    dst = np.full(n_edges, n_nodes - 1, dtype=np.int32)
    batch = np.full(n_nodes, bmg.n_graphs, dtype=np.int32)
    edge_ptr = np.searchsorted(dst, np.arange(n_nodes + 1)).astype(np.int32)
    node_ptr = np.searchsorted(batch, np.arange(bmg.n_graphs + 2)).astype(np.int32)
    tiles = iter2_tiles(edge_ptr[node_ptr[: bmg.n_graphs + 1]], n_edges)
    t = torch.from_numpy
    return BatchMolGraph(
        V=torch.zeros_like(bmg.V), E=torch.zeros_like(bmg.E), src=t(dst.copy()), dst=t(dst),
        rev=t(np.arange(n_edges, dtype=np.int32)), batch=t(batch), edge_ptr=t(edge_ptr),
        node_ptr=t(node_ptr), node_mask=torch.zeros(n_nodes, dtype=torch.bool),
        edge_mask=torch.zeros(n_edges, dtype=torch.bool), n_graphs=bmg.n_graphs,
        tile_ptr=None if tiles is None else t(tiles), last_node_padding=True,
        last_edge_padding=True,
    )


def _empty_like_batch(tb: TrainingBatch) -> TrainingBatch:
    """An all-padding batch shaped like ``tb``: zero weights and NaN
    targets, so it adds nothing to any summed loss or metric."""
    tup = isinstance(tb.bmg, tuple)
    bmg = tuple(_empty_like_bmg(b) for b in tb.bmg) if tup else _empty_like_bmg(tb.bmg)
    zeros = lambda x: None if x is None else torch.zeros_like(x)
    V_d = tuple(zeros(v) for v in tb.V_d) if tup and tb.V_d is not None else zeros(tb.V_d)
    return TrainingBatch(
        bmg=bmg, V_d=V_d, X_d=zeros(tb.X_d),
        Y=None if tb.Y is None else torch.full_like(tb.Y, float("nan")), w=torch.zeros_like(tb.w),
        lt_mask=zeros(tb.lt_mask), gt_mask=zeros(tb.gt_mask),
    )


class Shard(NamedTuple):
    """Shard ``index`` of a global batch cut into ``len(groups)`` shards:
    ``batch`` holds the rows ``groups[index]`` of the global batch (in that
    order, then padding), under the padding every shard shares."""

    batch: TrainingBatch
    groups: list[list[int]]
    index: int

    @property
    def n_shards(self) -> int:
        return len(self.groups)

    def to(self, device: str | torch.device) -> "Shard":
        return Shard(self.batch.to(device), self.groups, self.index)


def _shard_pads(rows: list, groups: list[list[int]], multi: bool, pad):
    """The one padding (a PadSpec, or one per component) every shard shares,
    as the JAX package's ``collate_sharded`` picks it."""
    cap = max(len(g) for g in groups)
    if multi:
        pads = []
        for c in range(len(rows[0])):
            per = [PadSpec.for_graphs([rows[i][c].mg for i in g], n_graphs=cap)
                   for g in groups if g]
            pads.append(PadSpec(max(p.n_nodes for p in per), max(p.n_edges for p in per), cap))
        return pads
    if pad is not None:
        return pad
    per = [PadSpec.for_graphs([rows[i][0] for i in g], n_graphs=cap) for g in groups if g]
    return PadSpec(max(p.n_nodes for p in per), max(p.n_edges for p in per), cap)


def collate_sharded(data: Iterable, n_shards: int, pad: PadSpec | None = None,
                    n_targets: int | None = None, shard_index: int = 0) -> Shard:
    """Shard ``shard_index`` of the rows ``data`` cut into ``n_shards``
    self-contained padded shards (cf. ``collate_sharded`` of
    ``chemprop_tpu/data/collate.py``, whose stacked shard ``k`` it equals):
    graphs LPT-balanced by edge count (:func:`partition_shards`), every
    shard under one padding (``pad`` per shard, or the largest of the
    shards' buckets); a shard left without graphs is all padding. Only this
    shard is collated; multicomponent rows give one graph per component.
    ``n_targets`` is :func:`collate_batch`'s, for single-component rows."""
    rows = list(data)
    if not rows:
        raise ValueError("collate_sharded needs at least one datum")
    if not 0 <= shard_index < n_shards:
        raise ValueError(f"shard_index {shard_index} is not in [0, {n_shards})")
    multi = isinstance(rows[0], list)
    sizes = ([sum(c.mg.E.shape[0] for c in row) for row in rows] if multi
             else [row[0].E.shape[0] for row in rows])
    groups = partition_shards(sizes, n_shards)
    pads = _shard_pads(rows, groups, multi, pad)

    def collate(g):
        if multi:
            return collate_multicomponent([rows[i] for i in g], pads)
        return collate_batch([rows[i] for i in g], pads, n_targets)

    mine = groups[shard_index]
    tb = collate(mine) if mine else _empty_like_batch(collate(groups[0]))
    return Shard(tb, groups, shard_index)


def unbatch(tb: TrainingBatch) -> list:
    """The real rows of a collated batch as ``Datum`` (lists of them for a
    multicomponent batch), each graph's edges in the batch's sorted order:
    collating them again gives the same tables."""
    from chemprop_tpu_torch.data.datasets import Datum

    n = int(tb.pad_mask.sum())
    graphs = tb.graphs
    V_ds = tb.V_d if isinstance(tb.V_d, tuple) else (tb.V_d,) * len(graphs)
    cols = []
    for bmg, V_d in zip(graphs, V_ds):
        node_ptr, edge_ptr = bmg.node_ptr.numpy(), bmg.edge_ptr.numpy()
        col = []
        for g in range(n):
            v0, v1 = int(node_ptr[g]), int(node_ptr[g + 1])
            e0, e1 = int(edge_ptr[v0]), int(edge_ptr[v1])
            mg = MolGraph(
                V=bmg.V[v0:v1].numpy(), E=bmg.E[e0:e1].numpy(),
                edge_index=np.stack([bmg.src[e0:e1].numpy() - v0, bmg.dst[e0:e1].numpy() - v0]),
                rev_edge_index=bmg.rev[e0:e1].numpy() - e0,
            )
            pick = lambda x: None if x is None else x[g].numpy()
            col.append(Datum(mg, None if V_d is None else V_d[v0:v1].numpy(), pick(tb.X_d),
                             pick(tb.Y), float(tb.w[g, 0]), pick(tb.lt_mask), pick(tb.gt_mask)))
        cols.append(col)
    return cols[0] if len(cols) == 1 else [list(r) for r in zip(*cols)]


def shard_of_batch(tb: TrainingBatch, n_shards: int, shard_index: int) -> Shard:
    """The host cut of a collated batch into whole-graph shards: shard
    ``shard_index`` of :func:`collate_sharded` over its real rows."""
    return collate_sharded(unbatch(tb), n_shards, shard_index=shard_index)
