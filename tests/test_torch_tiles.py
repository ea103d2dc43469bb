"""The tile table that the port's tile kernels (``fused_iter2``,
``bwd_message_premul``) rely on, and how the premultiplied backward takes it,
on the CPU.

``bwd_message_premul``'s kernel keeps a tile's ``gz`` in shared memory and
forms ``G`` from it there, so every row a tile's row gathers must lie in the
tile: the reverse of each row and every in-edge of its destination. These
tests hold the collate's table (``BatchMolGraph.tile_ptr``) to that for the
test batches and for random mixes of the molecules under tests/data, check
the wrapper's refusals of a table the kernel cannot take, and show that
``loop_readout``'s bfloat16 backward hands the table to the kernel and counts
a batch without one in ``UNSERVED``. test_torch_cuda.py runs the kernel
itself on the card."""

from __future__ import annotations

import csv
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.ops import UNSERVED, bwd_message_premul, fused_iter2, loop_readout
from chemprop_tpu_torch.ops.message import ITER2_TILE_ROWS, check_tiles, tiles_to

message_ops = sys.modules["chemprop_tpu_torch.ops.message"]  # the module, not ops.message()

DATA = Path(__file__).resolve().parent / "data"
SMIS = [
    "CCO",
    "c1ccccc1",
    "CC(=O)Nc1ccc(O)cc1",
    "CNC(C)Cc1ccccc1",
    "CC(C)CC1=CC=C(C=C1)C(C)C(=O)O",
    "c1ccc2ccccc2c1",
    "CC(=O)OC1=CC=CC=C1C(=O)O",
    "C1CCNCC1",
    "C",  # zero-edge molecule: a node with no in-edges
    "O=[N+]([O-])c1ccc(Cl)cc1",
]
D = 128


@pytest.fixture(scope="module")
def featurizer():
    return SimpleMoleculeMolGraphFeaturizer()


@pytest.fixture(scope="module")
def data_smiles():
    """The SMILES of tests/data/smis.csv and of the lipophilicity set."""
    smis = []
    for path in (DATA / "smis.csv", DATA / "regression" / "mol" / "mol.csv"):
        with open(path, newline="") as f:
            smis += [row[0] for row in list(csv.reader(f))[1:]]
    return smis


def _graph(b):
    return b.src, b.dst, b.rev, b.edge_ptr


def _assert_tiles_hold_their_rows(b):
    """The kernel's invariant: each tile at most ITER2_TILE_ROWS rows, from 0
    to E; every real row's reverse and every in-edge of its destination in
    the row's own tile; a tile of padding rows holds no real row."""
    tiles = b.tile_ptr.numpy().astype(np.int64)
    n = b.E.shape[0]
    rows = np.diff(tiles)
    assert tiles[0] == 0 and tiles[-1] == n
    assert (rows >= 0).all() and rows.max() <= ITER2_TILE_ROWS
    check_tiles(b.tile_ptr, n, b.tile_ptr.device)
    dst, rev, ptr = b.dst.numpy(), b.rev.numpy(), b.edge_ptr.numpy()
    tile_of = np.searchsorted(tiles, np.arange(n), "right")
    real = b.edge_mask.numpy()
    assert (tile_of[rev] == tile_of)[real].all()
    lo, hi = ptr[dst], ptr[dst + 1]
    assert (tile_of[lo] == tile_of)[real].all()  # the first in-edge of dst[j]
    assert (tile_of[np.maximum(hi - 1, lo)] == tile_of)[real].all()  # and the last
    first_pad = int(ptr[-2])
    assert real[:first_pad].all() and not real[first_pad:].any()
    # no tile holds both real and padding rows
    assert first_pad in tiles or first_pad == n


def test_tiles_of_the_test_batch_hold_their_rows(featurizer):
    mgs = [featurizer(make_mol(s)) for s in SMIS]
    for pad in (None, PadSpec(256, 768, len(SMIS))):
        b = batch_mol_graphs(mgs, pad)
        assert b.tile_ptr is not None
        _assert_tiles_hold_their_rows(b)


@pytest.mark.parametrize("seed", range(8))
def test_tiles_of_random_mixes_hold_their_rows(featurizer, data_smiles, seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 160))
    mgs = [featurizer(make_mol(data_smiles[i])) for i in rng.choice(len(data_smiles), k)]
    b = batch_mol_graphs(mgs)
    assert max(mg.E.shape[0] for mg in mgs) <= ITER2_TILE_ROWS and b.tile_ptr is not None
    _assert_tiles_hold_their_rows(b)
    # a moved table is checked before it moves and carries that mark along
    moved = b.to("cpu")
    assert moved.tile_ptr.checked_for_rows == b.E.shape[0]


def test_a_molecule_larger_than_a_tile_leaves_no_table(featurizer):
    mgs = [featurizer(make_mol(s)) for s in SMIS[:3] + ["C" * 70]]
    assert max(mg.E.shape[0] for mg in mgs) > ITER2_TILE_ROWS
    assert batch_mol_graphs(mgs).tile_ptr is None


@pytest.fixture(scope="module")
def batch(featurizer):
    return batch_mol_graphs([featurizer(make_mol(s)) for s in SMIS])


def _premul_inputs(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    G_in = torch.randn((n, D), generator=g).to(torch.bfloat16)
    y = torch.randn((n, D), generator=g).clamp_min(0).to(torch.bfloat16)
    H0 = torch.randn((n, D), generator=g).to(torch.bfloat16)
    W = (torch.randn((D, D), generator=g) * D**-0.5).to(torch.bfloat16)
    return G_in, y, H0, W


@pytest.mark.parametrize("fold_h0", [False, True])
def test_premul_with_tiles_equals_without(batch, fold_h0):
    G_in, y, H0, W = _premul_inputs(batch.E.shape[0])
    got = bwd_message_premul(G_in, y, H0, W, *_graph(batch), fold_h0=fold_h0,
                             tiles=batch.tile_ptr)
    want = bwd_message_premul(G_in, y, H0, W, *_graph(batch), fold_h0=fold_h0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _malformed(tiles: torch.Tensor, n: int) -> dict[str, torch.Tensor]:
    t = tiles.tolist()
    return {
        "past_the_end": torch.tensor(t[:-1] + [n + 1], dtype=torch.int32),
        "short_of_the_end": torch.tensor(t[:-1] + [n - 1], dtype=torch.int32),
        "not_from_zero": torch.tensor([1] + t[1:], dtype=torch.int32),
        "tile_too_large": torch.tensor([0, ITER2_TILE_ROWS + 1]
                                       + list(range(2 * ITER2_TILE_ROWS, n, ITER2_TILE_ROWS))
                                       + [n], dtype=torch.int32),
        "descending": torch.tensor([0, 100, 50] + t[2:], dtype=torch.int32),
        "int64": tiles.long(),
        "two_dimensional": tiles[None],
        "one_offset": tiles[:1],
    }


@pytest.mark.parametrize("case", ["past_the_end", "short_of_the_end", "not_from_zero",
                                  "tile_too_large", "descending", "int64", "two_dimensional",
                                  "one_offset"])
def test_tile_kernels_refuse_a_malformed_table(batch, case):
    n = batch.E.shape[0]
    bad = _malformed(batch.tile_ptr, n)[case]
    G_in, y, H0, W = _premul_inputs(n)
    with pytest.raises(ValueError):
        bwd_message_premul(G_in, y, H0, W, *_graph(batch), fold_h0=True, tiles=bad)
    with pytest.raises(ValueError):
        fused_iter2(H0, W, None, *_graph(batch), bad)
    with pytest.raises(ValueError):
        tiles_to(bad, n, "cpu")


def test_a_table_with_an_empty_tile_is_taken(batch):
    n = batch.E.shape[0]
    tiles = torch.cat([batch.tile_ptr[:1], batch.tile_ptr])  # a first tile of no rows
    check_tiles(tiles, n, tiles.device)
    G_in, y, H0, W = _premul_inputs(n)
    got = bwd_message_premul(G_in, y, H0, W, *_graph(batch), fold_h0=True, tiles=tiles)
    want = bwd_message_premul(G_in, y, H0, W, *_graph(batch), fold_h0=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("depth", [3, 4])
def test_loop_readout_hands_the_tile_table_to_the_premultiplied_kernel(batch, monkeypatch,
                                                                      depth):
    seen = []
    real = message_ops.bwd_message_premul

    def spy(*args, **kwargs):
        seen.append((kwargs.get("tiles"), kwargs.get("fold_h0")))
        return real(*args, **kwargs)

    monkeypatch.setattr(message_ops, "bwd_message_premul", spy)
    G_in, _, H0, W = _premul_inputs(batch.E.shape[0])
    H0 = H0.masked_fill(~batch.edge_mask[:, None], 0).requires_grad_()
    UNSERVED.clear()
    out = loop_readout(H0, W, None, *_graph(batch), depth, None, batch.tile_ptr)
    torch.autograd.grad(out.float().sum(), H0)
    assert [t is batch.tile_ptr for t, _ in seen] == [True] * (depth - 2)
    assert [f for _, f in seen] == [False] * (depth - 3) + [True]
    assert UNSERVED["bwd_message_premul"] == 0


@pytest.mark.parametrize("depth", [3, 4, 5])
def test_loop_readout_counts_a_batch_without_a_table(featurizer, depth):
    b = batch_mol_graphs([featurizer(make_mol(s)) for s in SMIS[:3] + ["C" * 70]])
    assert b.tile_ptr is None
    _, _, H0, W = _premul_inputs(b.E.shape[0])
    H0 = H0.masked_fill(~b.edge_mask[:, None], 0).requires_grad_()
    UNSERVED.clear()
    out = loop_readout(H0, W, None, *_graph(b), depth, None, b.tile_ptr)
    assert UNSERVED["bwd_message_premul"] == 0  # the forward takes no tiles
    torch.autograd.grad(out.float().sum(), H0)
    assert UNSERVED["bwd_message_premul"] == depth - 2  # one per premultiplied call
