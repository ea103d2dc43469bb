"""Kernel G (``bwd_message_nodes``) over the molecule tiles, on the CPU.

On a CUDA tensor with the batch's tile table the wrapper launches
``csrc/bwd_nodes.cu``: one launch over the tiles, each tile's ``gz`` formed in
shared memory from the rows of ``g_nodes`` of the nodes that own its rows.
Here, on the CPU, the wrapper takes its plain version; these tests hold it
against the JAX package's ``_bwd_msg_nodes_impl`` (its Pallas kernel in
interpret mode) on the layouts that stress the design (test_torch_kernels_bwd.py
holds a batch of ordinary molecules): salts, whose counter-ion owns no rows,
zero-edge molecules ("C"), and a run of 200 "C" between two molecules of one
tile. They check the byte count of the kernel's bound on those layouts, the
wrapper's refusals, and that ``loop_readout`` hands the tile table to the
kernel and counts a batch without one in ``UNSERVED``. test_torch_cuda.py
runs the kernel itself on the card."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chemprop_tpu.data import MoleculeDatapoint
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.ops.fused_message import _bwd_msg_nodes_impl
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED, bwd_message_nodes, loop_readout
from chemprop_tpu_torch.ops.message import ITER2_TILE_ROWS

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import bwd_nodes_bytes  # noqa: E402

message_ops = sys.modules["chemprop_tpu_torch.ops.message"]  # the module, not ops.message()

LAYOUTS = {
    "salts": ["CCO", "CC(=O)[O-].[Na+]", "[Na+].CC(=O)[O-]", "C", "c1ccccc1"],
    "run_of_200_C": ["CCO", "CC(=O)[O-].[Na+]", "[Na+].CC(=O)[O-]"] + ["C"] * 200
    + ["c1ccccc1"],
}
D = 128
BF16_ULP = 2.0**-7


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def batches(request):
    """The layout batched by both packages to the same padded shapes."""
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(MoleculeDatapoint.from_smi(s).mol) for s in LAYOUTS[request.param]]
    pad = PadSpec.for_graphs(mgs)
    # the JAX node kernel reads a window of two 128-node chunks
    pad = pad._replace(n_nodes=max(pad.n_nodes, 256))
    jb = jax_batch(mgs, JaxPadSpec(*pad), sort_edges=True)
    assert jb.fused_ok and jb.readout_ok  # the JAX node kernel takes it
    tb = batch_mol_graphs(mgs, pad)
    assert tb.tile_ptr is not None
    return request.param, jb, tb


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")


def _graph(tb):
    return tb.src, tb.dst, tb.rev, tb.edge_ptr


def _bf16(shape, seed):
    """bf16-representable values from a numpy seed, as float32."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _inputs(tb, seed=0):
    g = _bf16((tb.V.shape[0], D), seed)
    g[-1] = 0  # the sacrificial node's cotangent
    y = np.maximum(_bf16((tb.E.shape[0], D), seed + 1), 0)  # a ReLU output
    return g, y


def test_tiled_matches_jax_kernel(batches, interpret):
    name, jb, tb = batches
    if name == "run_of_200_C":  # the first tile's node range holds the run
        first = tb.dst[: int(tb.tile_ptr[1])][tb.edge_mask[: int(tb.tile_ptr[1])]]
        assert int(first[-1]) - int(first[0]) > 200
    g, y = _inputs(tb, seed=3)
    gj, yj = jnp.asarray(g, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    want_G, want_gz = _bwd_msg_nodes_impl(gj, yj, jb.src, jb.dst, jb.rev, jb.fused_window)
    gt, yt = torch.from_numpy(g).to(torch.bfloat16), torch.from_numpy(y).to(torch.bfloat16)
    LAUNCHES.clear()
    G, gz = bwd_message_nodes(gt, yt, *_graph(tb), tiles=tb.tile_ptr)
    assert sum(LAUNCHES.values()) == 0  # the plain version: no kernel on the CPU
    real = tb.edge_mask.numpy()
    # both sum in f32 and round once; a sum in another order may round to the
    # neighbouring bf16 value; gz is a masked copy
    G, gz = G.float().numpy(), gz.float().numpy()
    np.testing.assert_allclose(G[real], np.asarray(want_G, np.float32)[real],
                               rtol=2 * BF16_ULP, atol=1e-6)
    np.testing.assert_array_equal(gz[real], np.asarray(want_gz, np.float32)[real])
    assert not G[~real].any() and not gz[~real].any()  # padding rows: exact zeros
    # the function does not depend on the table: without one, the same bits
    G2, gz2 = bwd_message_nodes(gt, yt, *_graph(tb))
    assert np.array_equal(G, G2.float().numpy()) and np.array_equal(gz, gz2.float().numpy())


@pytest.mark.parametrize("d", [128, 384])
def test_bwd_nodes_bytes_counts_only_what_the_kernel_moves(batches, d):
    """The bound's byte count: y over the real rows only, g_nodes only at the
    nodes that own rows (not the counter-ions or the atoms of "C", not the
    padding node), G and gz over every row, the ids of the real rows, the
    tile table and one entry of ptr."""
    _, _, tb = batches
    real = tb.edge_mask
    n_e, n_real = tb.E.shape[0], int(real.sum())
    owners = torch.unique(tb.dst[real]).numel()
    assert owners < tb.V.shape[0] - 1 and n_real < n_e
    want = (n_real + owners + 2 * n_e) * d * 2 + 8 * n_real + 4 * tb.tile_ptr.numel() + 4
    assert bwd_nodes_bytes(tb, d) == want


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


@pytest.fixture(scope="module")
def salts():
    feat = SimpleMoleculeMolGraphFeaturizer()
    return batch_mol_graphs([feat(MoleculeDatapoint.from_smi(s).mol)
                             for s in LAYOUTS["salts"]])


@pytest.mark.parametrize("case", ["past_the_end", "short_of_the_end", "not_from_zero",
                                  "tile_too_large", "descending", "int64", "two_dimensional",
                                  "one_offset"])
def test_refuses_a_malformed_table(salts, case):
    n = salts.E.shape[0]
    g = torch.zeros((salts.V.shape[0], D), dtype=torch.bfloat16)
    y = torch.zeros((n, D), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        bwd_message_nodes(g, y, *_graph(salts), tiles=_malformed(salts.tile_ptr, n)[case])


@pytest.mark.parametrize("d", [64, 200, 300])
def test_refuses_a_width_the_tiled_kernel_does_not_take(salts, d):
    g = torch.zeros((salts.V.shape[0], d), dtype=torch.bfloat16)
    y = torch.zeros((salts.E.shape[0], d), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        bwd_message_nodes(g, y, *_graph(salts), tiles=salts.tile_ptr)
    bwd_message_nodes(g, y, *_graph(salts))  # the form without a table takes it


def test_refuses_float32(salts):
    g = torch.zeros((salts.V.shape[0], D))
    y = torch.zeros((salts.E.shape[0], D))
    with pytest.raises(TypeError):
        bwd_message_nodes(g, y, *_graph(salts), tiles=salts.tile_ptr)


def _loop_inputs(tb, seed=9):
    g = torch.Generator().manual_seed(seed)
    H0 = torch.randn((tb.E.shape[0], D), generator=g).to(torch.bfloat16)
    H0 = H0.masked_fill(~tb.edge_mask[:, None], 0).requires_grad_()
    W = (torch.randn((D, D), generator=g) * D**-0.5).to(torch.bfloat16)
    return H0, W


@pytest.mark.parametrize("depth", [3, 4])
def test_loop_readout_hands_the_tile_table_to_bwd_message_nodes(salts, monkeypatch, depth):
    seen = []
    real = message_ops.bwd_message_nodes

    def spy(*args, **kwargs):
        seen.append(kwargs.get("tiles"))
        return real(*args, **kwargs)

    monkeypatch.setattr(message_ops, "bwd_message_nodes", spy)
    H0, W = _loop_inputs(salts)
    UNSERVED.clear()
    out = loop_readout(H0, W, None, *_graph(salts), depth, None, salts.tile_ptr)
    torch.autograd.grad(out.float().sum(), H0)
    assert len(seen) == 1 and seen[0] is salts.tile_ptr
    assert UNSERVED["bwd_message_nodes"] == 0


@pytest.mark.parametrize("depth", [3, 4, 5])
def test_loop_readout_counts_a_batch_without_a_table(depth):
    feat = SimpleMoleculeMolGraphFeaturizer()
    b = batch_mol_graphs([feat(MoleculeDatapoint.from_smi(s).mol)
                          for s in ["CCO", "C", "[Na+].CC(=O)[O-]", "C" * 70]])
    assert b.tile_ptr is None  # a molecule of more rows than a tile
    H0, W = _loop_inputs(b)
    UNSERVED.clear()
    out = loop_readout(H0, W, None, *_graph(b), depth, None, b.tile_ptr)
    assert UNSERVED["bwd_message_nodes"] == 0  # the forward takes no G
    torch.autograd.grad(out.float().sum(), H0)
    assert UNSERVED["bwd_message_nodes"] == 1  # one G per backward
