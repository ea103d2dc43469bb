"""The port's differentiable ops (``message``, ``sorted_segment_sum``,
``sorted_segment_sum_counts``, ``loop_readout``) on their plain CPU paths.

The plain versions compute in float32, so instead of a finite-difference
check in float64 each hand-written backward is held against autograd's own
gradient of the same function composed from PyTorch's indexing ops, and
``loop_readout`` also against ``jax.grad`` of the JAX package's
``fused_loop_readout``: in bfloat16 with its Pallas backward kernels in
interpret mode, in float32 through its composed XLA chain."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chemprop_tpu.data import MoleculeDatapoint
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.ops.fused_message import fused_loop_readout
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.ops import (
    UNSERVED,
    loop_readout,
    message,
    sorted_segment_sum,
    sorted_segment_sum_counts,
)

SMIS = [
    "CCO",
    "c1ccccc1",
    "CC(=O)Nc1ccc(O)cc1",
    "CNC(C)Cc1ccccc1",
    "CC(C)CC1=CC=C(C=C1)C(C)C(=O)O",
    "c1ccc2ccccc2c1",
    "CC(=O)OC1=CC=CC=C1C(=O)O",
    "C1CCNCC1",
    "C",
    "O=[N+]([O-])c1ccc(Cl)cc1",
]
D = 128


@pytest.fixture(scope="module")
def batches():
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(MoleculeDatapoint.from_smi(s).mol) for s in SMIS]
    pad = (256, 768, len(SMIS))
    jb = jax_batch(mgs, JaxPadSpec(*pad), sort_edges=True)
    assert jb.fused_ok and jb.readout_ok
    return jb, batch_mol_graphs(mgs, PadSpec(*pad))


def _graph(tb):
    return tb.src, tb.dst, tb.rev, tb.edge_ptr


def _rand(shape, seed, scale=1.0, bf16=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    if bf16:  # bf16-representable values, handed to both packages
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _message_composed(H, tb):
    """The message from PyTorch's own differentiable indexing ops."""
    n_nodes = tb.V.shape[0]
    M_node = torch.zeros((n_nodes, H.shape[1])).index_add(0, tb.dst.long(), H)
    M = M_node[tb.src.long()] - H[tb.rev.long()]
    return M * (tb.src != n_nodes - 1)[:, None]


def _loop_composed(H0, W, b, tb, depth):
    H = torch.relu(H0)
    for _ in range(1, depth):
        z = _message_composed(H, tb) @ W
        H = torch.relu(H0 + (z if b is None else z + b))
    return torch.zeros((tb.V.shape[0], H.shape[1])).index_add(0, tb.dst.long(), H)


def test_message_backward_matches_autograd(batches):
    _, tb = batches
    H = torch.from_numpy(_rand((tb.E.shape[0], D), 0)).requires_grad_()
    # a cotangent that arrives non-contiguous
    c = torch.from_numpy(_rand((D, tb.E.shape[0]), 1)).t()
    assert not c.is_contiguous()
    (got,) = torch.autograd.grad(message(H, *_graph(tb)), H, c)
    (want,) = torch.autograd.grad(_message_composed(H, tb), H, c)
    real = tb.edge_mask
    # f32 sums in another order
    torch.testing.assert_close(got[real], want[real], rtol=1e-5, atol=1e-5)
    # no real row's message reads a padding row, and the port says so exactly
    assert not got[~real].any()


@pytest.mark.parametrize("readout", ["edge_to_node", "node_to_graph"])
def test_segment_sum_backward_is_the_gather(batches, readout):
    _, tb = batches
    ids, ptr = (tb.dst, tb.edge_ptr) if readout == "edge_to_node" else (tb.batch, tb.node_ptr)
    x = torch.from_numpy(_rand((ids.shape[0], D), 2)).requires_grad_()
    c = torch.from_numpy(_rand((ptr.numel() - 1, D), 3))
    (got,) = torch.autograd.grad(sorted_segment_sum(x, ids, ptr), x, c)
    want = torch.zeros((ptr.numel() - 1, D)).index_add(0, ids.long(), x)
    (want,) = torch.autograd.grad(want, x, c)
    assert torch.equal(got, want)  # a gather on both sides


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_counts_backward(batches, dtype):
    """The mean readout's backward: the plain gather in float32, the row
    gather (zero row for the sacrificial graph) in bfloat16; the counts carry
    no gradient."""
    _, tb = batches
    x = torch.from_numpy(_rand((tb.V.shape[0], D), 4, bf16=True)).to(dtype).requires_grad_()
    totals, counts = sorted_segment_sum_counts(x, tb.batch, tb.node_ptr)
    assert totals.dtype == torch.float32 and not counts.requires_grad
    mean = totals[: tb.n_graphs] / counts[: tb.n_graphs, None].clamp_min(1.0)
    c = torch.from_numpy(_rand((tb.n_graphs, D), 5))
    (got,) = torch.autograd.grad(mean, x, c)
    assert got.dtype == dtype
    want = (c / counts[: tb.n_graphs, None].clamp_min(1.0))
    want = torch.cat([want, torch.zeros(1, D)])[tb.batch.long()]
    # bfloat16: the cotangent is rounded once, when the small table is cast
    torch.testing.assert_close(got.float(), want.to(dtype).float(), rtol=0, atol=0)
    assert not got[tb.batch == tb.n_graphs].any()


@pytest.mark.parametrize("depth,bias", [(2, False), (3, False), (3, True), (4, False)])
def test_loop_readout_f32_matches_autograd(batches, depth, bias):
    """float32 takes the per-iteration chain through ``bwd_message``."""
    _, tb = batches
    H0 = torch.from_numpy(_rand((tb.E.shape[0], D), 6)).requires_grad_()
    W = torch.from_numpy(_rand((D, D), 7, scale=D**-0.5)).requires_grad_()
    b = torch.from_numpy(_rand((D,), 8, scale=0.1)).requires_grad_() if bias else None
    c = torch.from_numpy(_rand((tb.V.shape[0], D), 9))
    inputs = [H0, W] + ([b] if bias else [])
    out = loop_readout(H0, W, b, *_graph(tb), depth)
    ref = _loop_composed(H0, W, b, tb, depth)
    real_nodes = tb.node_mask
    torch.testing.assert_close(out[real_nodes], ref[real_nodes], rtol=1e-5, atol=1e-4)
    # the sacrificial node's cotangent is zero in the model; with a bias the
    # padding rows are not zero, and their only reader is that node
    c[-1] = 0
    got = torch.autograd.grad(out, inputs, c)
    want = torch.autograd.grad(ref, inputs, c)
    real = tb.edge_mask
    # f32 sums in another order, through up to three products with W
    torch.testing.assert_close(got[0][real], want[0][real], rtol=1e-4, atol=1e-4)
    assert not got[0][~real].any()  # dH0's padding rows: exact zeros
    scale = float(want[1].abs().max())
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-5 * scale)
    if bias:
        torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-5 * scale)


def _jax_loop_grads(jb, H0, W, c, depth, dtype):
    n_nodes = jb.V.shape[0]

    def f(H0, W):
        M_v = fused_loop_readout(
            H0, W, None, jb.src, jb.dst, jb.rev, n_nodes, jb.fused_window, depth,
            jb.readout_ok, jb.edge_band,
        )
        return (M_v.astype(jnp.float32) * c).sum()

    dH0, dW = jax.grad(f, argnums=(0, 1))(jnp.asarray(H0, dtype), jnp.asarray(W, dtype))
    return np.asarray(dH0, np.float32), np.asarray(dW, np.float32)


def _torch_loop_grads(tb, H0, W, c, depth, dtype):
    H0t = torch.from_numpy(H0).to(dtype).requires_grad_()
    Wt = torch.from_numpy(W).to(dtype).requires_grad_()
    out = loop_readout(H0t, Wt, None, *_graph(tb), depth)
    dH0, dW = torch.autograd.grad(out, [H0t, Wt], torch.from_numpy(c).to(dtype))
    assert dH0.dtype == dW.dtype == dtype
    return dH0.float().numpy(), dW.float().numpy()


def _loop_inputs(tb, bf16):
    H0 = _rand((tb.E.shape[0], D), 20, bf16=bf16)
    H0[~tb.edge_mask.numpy()] = 0  # as W_i without a bias leaves the padding rows
    W = _rand((D, D), 21, scale=D**-0.5, bf16=bf16)
    c = _rand((tb.V.shape[0], D), 22, bf16=bf16)
    c[-1] = 0  # the sacrificial node's cotangent
    return H0, W, c


@pytest.mark.parametrize("depth", [3, 4])
def test_loop_readout_f32_matches_jax_grad(batches, depth):
    jb, tb = batches
    H0, W, c = _loop_inputs(tb, bf16=False)
    want_dH0, want_dW = _jax_loop_grads(jb, H0, W, c, depth, jnp.float32)
    got_dH0, got_dW = _torch_loop_grads(tb, H0, W, c, depth, torch.float32)
    real = tb.edge_mask.numpy()
    # the same chain in f32 on both sides; only summation orders differ
    np.testing.assert_allclose(got_dH0[real], want_dH0[real], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_dW, want_dW, rtol=1e-4, atol=1e-5 * np.abs(want_dW).max())


@pytest.mark.parametrize("depth", [3, 4])
def test_loop_readout_bf16_matches_jax_grad(batches, monkeypatch, depth):
    """bfloat16 takes the node-cotangent kernel for the last iteration and
    the premultiplied one for the earlier ones (``fold_h0`` for the first),
    as the JAX package does with its kernels in interpret mode."""
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")
    jb, tb = batches
    H0, W, c = _loop_inputs(tb, bf16=True)
    want_dH0, want_dW = _jax_loop_grads(jb, H0, W, c, depth, jnp.bfloat16)
    got_dH0, got_dW = _torch_loop_grads(tb, H0, W, c, depth, torch.bfloat16)
    real = tb.edge_mask.numpy()
    # the two forwards may differ by a bf16 ulp in a saved y, which flips a
    # ReLU mask where y is near zero and moves every value downstream by a
    # few ulps of the largest term: errors are held against the tables' scale
    for got, want in ((got_dH0[real], want_dH0[real]), (got_dW, want_dW)):
        scale = np.abs(want).max()
        err = np.abs(got - want)
        assert err.max() <= 0.05 * scale, (err.max(), scale)
        assert err.mean() <= 2e-3 * scale, (err.mean(), scale)
    assert not got_dH0[~real].any()


@pytest.mark.parametrize("depth", [3, 4])
def test_loop_readout_bf16_without_a_tile_table_matches_jax_grad(monkeypatch, depth):
    """A batch holding a molecule of more edge rows than a tile has no tile
    table: the premultiplied backward takes its form without one, counted
    once per call in ``UNSERVED``, and the gradients still follow the JAX
    package's."""
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(MoleculeDatapoint.from_smi(s).mol) for s in SMIS[:4] + ["C" * 70]]
    pad = (256, 768, len(mgs))
    jb = jax_batch(mgs, JaxPadSpec(*pad), sort_edges=True)
    tb = batch_mol_graphs(mgs, PadSpec(*pad))
    assert jb.fused_ok and jb.readout_ok and tb.tile_ptr is None
    H0, W, c = _loop_inputs(tb, bf16=True)
    want_dH0, want_dW = _jax_loop_grads(jb, H0, W, c, depth, jnp.bfloat16)
    UNSERVED.clear()
    got_dH0, got_dW = _torch_loop_grads(tb, H0, W, c, depth, torch.bfloat16)
    assert UNSERVED["bwd_message_premul"] == depth - 2
    real = tb.edge_mask.numpy()
    # as test_loop_readout_bf16_matches_jax_grad: a bf16 ulp in a saved y may
    # flip a ReLU mask, so errors are held against the tables' scale
    for got, want in ((got_dH0[real], want_dH0[real]), (got_dW, want_dW)):
        scale = np.abs(want).max()
        err = np.abs(got - want)
        assert err.max() <= 0.05 * scale, (err.max(), scale)
        assert err.mean() <= 2e-3 * scale, (err.mean(), scale)
    assert not got_dH0[~real].any()


def test_loop_readout_rejects_depth_1(batches):
    _, tb = batches
    H0 = torch.zeros((tb.E.shape[0], D))
    with pytest.raises(ValueError):
        loop_readout(H0, torch.zeros(D, D), None, *_graph(tb), 1)
