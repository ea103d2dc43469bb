"""Kernel D (``ops.fused_iter2``, the first two bfloat16 depth iterations in
one launch over the batch's tile table) on the CPU: the bytes its bound in
``chip_smoke.py`` counts, worked out by hand on a small batch; the widths it
takes (d <= 512, where a cluster of d / 128 CTAs holds W), its refusal of the
others on the CPU as on the card, and ``loop_readout`` taking two iterations
at such a width with the refusal counted; its wrapper on CPU tensors takes
the plain version and launches nothing. The kernel itself runs on the card
(``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED, KernelOptions, fused_iter2, loop_readout
from chemprop_tpu_torch.ops.message import ITER2_WIDTHS, fused_iter2_plain

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import fused_iter2_bytes  # noqa: E402


@pytest.fixture(scope="module")
def small():
    """CCO (3 atoms, 2 bonds: 4 edge rows), C (1 atom, none) and CC (2
    atoms, 1 bond: 2 rows), padded to 8 node and 16 edge rows."""
    feat = SimpleMoleculeMolGraphFeaturizer()
    return batch_mol_graphs([feat(make_mol(s)) for s in ("CCO", "C", "CC")], PadSpec(8, 16, 3))


def test_the_small_batch_is_as_worked_out(small):
    assert small.E.shape[0] == 16 and small.V.shape[0] == 8
    assert int(small.edge_mask.sum()) == 6 and int(small.node_mask.sum()) == 6
    # one tile of the three molecules' 6 rows, one of the 10 padding rows
    assert small.tile_ptr.tolist() == [0, 6, 16]


@pytest.mark.parametrize("d,want", [
    # H0 read and y1, y2 written over all 16 rows: 3 * 16 * d * 2 bytes; W
    # once: d * d * 2; src and rev of the 6 real rows: 6 * 8; the ptr entries
    # of the 6 real nodes and the one after them: 7 * 4; the tile table's 3
    # entries: 3 * 4
    (128, 12288 + 32768 + 48 + 28 + 12),
    (384, 36864 + 294912 + 48 + 28 + 12),
])
def test_fused_iter2_bytes_counts_only_what_the_kernel_moves(small, d, want):
    assert fused_iter2_bytes(small, d) == want


def _inputs(b, d, seed):
    rng = np.random.default_rng(seed)
    n = b.E.shape[0]
    H0 = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(torch.bfloat16)
    W = torch.from_numpy((rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)).to(
        torch.bfloat16)
    return H0, W


@pytest.mark.parametrize("d", [128, 256, 384, 512, 640, 768, 896, 1024])
def test_the_widths_it_takes(small, d):
    """A cluster of d / 128 CTAs, each with a 128-column slice of W beside
    its buffers, serves d <= 512; a wider width is refused before any launch,
    on the CPU as on the card."""
    assert ITER2_WIDTHS == (128, 256, 384, 512)
    H0, W = _inputs(small, d, d)
    graph = (small.src, small.dst, small.rev, small.edge_ptr)
    if d in ITER2_WIDTHS:
        fused_iter2(H0, W, None, *graph, small.tile_ptr)
    else:
        with pytest.raises(ValueError, match="fused_iter2 takes d in"):
            fused_iter2(H0, W, None, *graph, small.tile_ptr)


@pytest.mark.parametrize("d", [128, 640])
def test_the_wrapper_takes_the_plain_version_on_the_cpu(small, d):
    H0, W = _inputs(small, d, d)
    graph = (small.src, small.dst, small.rev, small.edge_ptr)
    LAUNCHES.clear()
    UNSERVED.clear()
    if d in ITER2_WIDTHS:
        y1, y2 = fused_iter2(H0, W, None, *graph, small.tile_ptr)
        want = fused_iter2_plain(H0, W, None, *graph)
        assert torch.equal(y1, want[0]) and torch.equal(y2, want[1])
    # loop_readout with iter2: one fused_iter2 where the width is taken, two
    # iterations (counted as unserved) where it is not; the same result
    out = loop_readout(H0, W, None, *graph, 3, KernelOptions(iter2=True), small.tile_ptr)
    want = loop_readout(H0, W, None, *graph, 3, KernelOptions(iter2=False), small.tile_ptr)
    assert torch.equal(out, want)
    assert sum(LAUNCHES.values()) == 0
    assert UNSERVED["fused_iter2"] == (0 if d in ITER2_WIDTHS else 1)
