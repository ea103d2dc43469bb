"""The split tile table of a batch that holds a molecule of more edge rows
than a tile, and how G and H (``bwd_message_nodes``, ``bwd_message_premul``)
take it, on the CPU.

Such a batch has no ``tile_ptr``: every row a tile's row gathers must lie in
its tile, and a molecule of more than ``ITER2_TILE_ROWS`` rows cannot. Its
``split_ptr`` cuts those molecules at their nodes' boundaries (every other
molecule stays whole), so the tile kernels of G and H form every row whose
sum reads only its own tile, and ``cross_rows`` lists the others, which a
second pass forms from the ``gz`` table in device memory. These tests hold
the collate's two tables to that on Tox21 (``classification/mol.csv``, 8 of
its 500 molecules larger than a tile) and on a chain of 70 carbons, check
the wrappers' refusals, and show that ``BondMessagePassing``'s bfloat16
backward hands the split table and its cross rows to G and H and leaves
nothing in ``UNSERVED``. test_torch_cuda.py runs the kernels on the card."""

from __future__ import annotations

import csv
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.data.collate import batch_mol_graphs
from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.nn import BondMessagePassing
from chemprop_tpu_torch.ops import UNSERVED, KernelOptions, bwd_message_nodes, bwd_message_premul
from chemprop_tpu_torch.ops.message import ITER2_TILE_ROWS, check_tiles

message_ops = sys.modules["chemprop_tpu_torch.ops.message"]  # the module, not ops.message()

DATA = Path(__file__).resolve().parent / "data"
SMALL = ["CCO", "c1ccccc1", "C", "[Na+].CC(=O)[O-]", "CC(=O)Nc1ccc(O)cc1"]


@pytest.fixture(scope="module")
def featurizer():
    return SimpleMoleculeMolGraphFeaturizer()


@pytest.fixture(scope="module")
def tox21(featurizer):
    with open(DATA / "classification" / "mol.csv", newline="") as f:
        smis = [row[0] for row in list(csv.reader(f))[1:]]
    return [featurizer(make_mol(s)) for s in smis]


def _chain(featurizer):
    mgs = [featurizer(make_mol(s)) for s in SMALL[:3] + ["C" * 70] + SMALL[3:]]
    assert max(mg.E.shape[0] for mg in mgs) > ITER2_TILE_ROWS
    return mgs


def _assert_split(b, mgs):
    """The split table's rules: runs of at most a tile from 0 to E; a cut
    inside a molecule only in one larger than a tile, and there only at a
    node's boundary; and ``cross_rows`` exactly the real rows whose sum
    ``sum_{j in in(dst[e])} gz[rev[j]] - gz[rev[e]]`` reads another tile."""
    assert b.tile_ptr is None and b.split_ptr is not None
    tiles = b.split_ptr.numpy().astype(np.int64)
    n = b.E.shape[0]
    assert tiles[0] == 0 and tiles[-1] == n and np.diff(tiles).max() <= ITER2_TILE_ROWS
    assert (np.diff(tiles) > 0).all()
    check_tiles(b.split_ptr, n, b.split_ptr.device)
    ptr, dst, rev = (t.numpy().astype(np.int64) for t in (b.edge_ptr, b.dst, b.rev))
    node_ptr = b.node_ptr.numpy().astype(np.int64)
    graph_rows = ptr[node_ptr[: len(mgs) + 1]]
    for t in tiles[1:-1]:
        g = np.searchsorted(graph_rows, t, "right") - 1
        if g < len(mgs) and graph_rows[g] < t < graph_rows[g + 1]:  # inside molecule g
            assert graph_rows[g + 1] - graph_rows[g] > ITER2_TILE_ROWS
            assert t in ptr  # a node's first in-edge row
    tile_of = np.searchsorted(tiles, np.arange(n), "right")
    n_real = int(b.edge_mask.sum())
    want = [e for e in range(n_real)
            if any(tile_of[rev[j]] != tile_of[e] for j in range(ptr[dst[e]], ptr[dst[e] + 1]))
            or tile_of[rev[e]] != tile_of[e]]
    np.testing.assert_array_equal(b.cross_rows.numpy(), np.asarray(want, dtype=np.int32))
    assert b.cross_rows.dtype == torch.int32


def test_tox21_in_one_batch_has_a_split_table(tox21):
    b = batch_mol_graphs(tox21)
    assert sum(mg.E.shape[0] > ITER2_TILE_ROWS for mg in tox21) == 8
    _assert_split(b, tox21)
    assert 0 < b.cross_rows.numel() < int(b.edge_mask.sum()) // 20


@pytest.mark.parametrize("start", [0, 100, 300, 450])
def test_tox21_batches_of_50_have_one_table_or_the_other(tox21, start):
    mgs = tox21[start : start + 50]
    b = batch_mol_graphs(mgs)
    if max(mg.E.shape[0] for mg in mgs) > ITER2_TILE_ROWS:
        _assert_split(b, mgs)
    else:
        assert b.tile_ptr is not None and b.split_ptr is None and b.cross_rows is None


def test_a_chain_larger_than_a_tile_is_cut_at_its_atoms(featurizer):
    mgs = _chain(featurizer)
    b = batch_mol_graphs(mgs)
    _assert_split(b, mgs)
    # the chain's rows span three tiles: the rows next to each cut read
    # across it, the rest of the chain does not
    assert 0 < b.cross_rows.numel() <= 8


def test_the_split_table_moves_checked(featurizer):
    b = batch_mol_graphs(_chain(featurizer))
    moved = b.to("cpu")
    assert torch.equal(moved.split_ptr, b.split_ptr)
    assert torch.equal(moved.cross_rows, b.cross_rows)
    bad = b.split_ptr.clone()
    bad[1] = bad[2] + ITER2_TILE_ROWS  # not ascending
    with pytest.raises(ValueError):
        type(b)(**{**b.__dict__, "split_ptr": bad}).to("cpu")


def test_g_and_h_refuse_cross_rows_without_their_table(featurizer):
    b = batch_mol_graphs(_chain(featurizer))
    graph = (b.src, b.dst, b.rev, b.edge_ptr)
    n, d = b.E.shape[0], 128
    y = torch.ones((n, d), dtype=torch.bfloat16)
    g_nodes = torch.ones((b.V.shape[0], d), dtype=torch.bfloat16)
    W = torch.eye(d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="split tile table"):
        bwd_message_nodes(g_nodes, y, *graph, cross=b.cross_rows)
    with pytest.raises(ValueError, match="split tile table"):
        bwd_message_premul(y, y, None, W, *graph, cross=b.cross_rows)
    with pytest.raises(ValueError, match="int32"):
        bwd_message_nodes(g_nodes, y, *graph, tiles=b.split_ptr, cross=b.cross_rows.long())
    # on the CPU, the plain versions: the table and the rows change nothing
    got = bwd_message_nodes(g_nodes, y, *graph, tiles=b.split_ptr, cross=b.cross_rows)
    want = bwd_message_nodes(g_nodes, y, *graph)
    assert all(torch.equal(x, w) for x, w in zip(got, want))


def test_message_passing_hands_the_split_table_to_g_and_h(featurizer, monkeypatch):
    b = batch_mol_graphs(_chain(featurizer))
    seen = []
    for name in ("bwd_message_nodes", "bwd_message_premul"):
        real = getattr(message_ops, name)

        def spy(*args, _name=name, _real=real, **kwargs):
            seen.append((_name, kwargs.get("tiles"), kwargs.get("cross")))
            return _real(*args, **kwargs)

        monkeypatch.setattr(message_ops, name, spy)
    mp = BondMessagePassing(d_v=b.V.shape[1], d_e=b.E.shape[1], d_h=64, depth=4,
                            compute_dtype=torch.bfloat16, kernel_options=KernelOptions())
    UNSERVED.clear()
    mp(b).float().sum().backward()
    assert [name for name, *_ in seen] == ["bwd_message_nodes"] + ["bwd_message_premul"] * 2
    assert all(t is b.split_ptr and c is b.cross_rows for _, t, c in seen)
    assert UNSERVED["bwd_message_nodes"] == UNSERVED["bwd_message_premul"] == 0
