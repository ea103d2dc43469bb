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
``node_ptr`` over ``batch`` (the nodes of graph ``g``)."""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import NamedTuple, Sequence

import numpy as np
import torch

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

    def __len__(self) -> int:
        return self.n_graphs

    def to(self, device: str | torch.device) -> "BatchMolGraph":
        moved = {
            f.name: getattr(self, f.name).to(device, non_blocking=True)
            for f in fields(self)
            if f.name != "n_graphs"
        }
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


class PadSpec(NamedTuple):
    n_nodes: int
    n_edges: int
    n_graphs: int

    @classmethod
    def for_graphs(cls, mgs: Sequence[MolGraph]) -> "PadSpec":
        n_nodes = pad_to_bucket(sum(mg.V.shape[0] for mg in mgs) + 1)  # >=1 padding row
        # the JAX package's edge ladder, aligned to a 512-multiple, so that
        # both packages batch to the same shapes
        n_edges = -(-pad_to_bucket(max(1, sum(mg.E.shape[0] for mg in mgs))) // 512) * 512
        return cls(n_nodes, n_edges, len(mgs))


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
    )
    return (bmg, perm) if return_perm else bmg
