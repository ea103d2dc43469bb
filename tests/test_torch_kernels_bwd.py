"""The port's backward kernels (chemprop_tpu_torch.ops: bwd_message,
bwd_message_nodes, bwd_message_premul, row_gather) against the JAX package's
functions, on the same inputs made with numpy from a seed.

On the CPU each wrapper takes its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode (CHEMPROP_TPU_INTERPRET=1), and
``window_gather``, which has no interpret switch, through its CPU reference
``M[ids]``. Both sides get the same saved output ``y``, so the ReLU masks
agree exactly. Edge tables are compared on real rows only (the JAX kernels
leave garbage on padding rows); the port's padding rows are exact zeros.
test_torch_cuda.py holds each CUDA kernel against its plain version on the
card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chemprop_tpu.data import MoleculeDatapoint
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.ops.fused_message import (
    _bwd_msg_impl,
    _bwd_msg_nodes_impl,
    _bwd_msg_premul_impl,
)
from chemprop_tpu.ops.window_gather import window_gather
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.ops import (
    LAUNCHES,
    bwd_message,
    bwd_message_nodes,
    bwd_message_premul,
    row_gather,
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
    "C",  # zero-edge molecule: a node with no in-edges
    "O=[N+]([O-])c1ccc(Cl)cc1",
]
D = 128
BF16_ULP = 2.0**-7  # relative spacing of bfloat16 (8 significant bits)


@pytest.fixture(scope="module")
def batches():
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(MoleculeDatapoint.from_smi(s).mol) for s in SMIS]
    pad = (256, 768, len(SMIS))
    jb = jax_batch(mgs, JaxPadSpec(*pad), sort_edges=True)
    assert jb.fused_ok and jb.readout_ok
    return jb, batch_mol_graphs(mgs, PadSpec(*pad))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")


def _graph(tb):
    return tb.src, tb.dst, tb.rev, tb.edge_ptr


def _rand(shape, seed, dtype="float32", scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    if dtype == "bfloat16":  # bf16-representable values, handed to both packages
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _both(x, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, real, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        # the JAX f32 kernel splits its operand into bf16 hi + lo parts (~16
        # significant bits); the port sums in full f32
        np.testing.assert_allclose(got[real], want[real], rtol=1e-4, atol=1e-4)
    else:
        # both sum in f32 and round once; a sum taken in another order may
        # round to the neighbouring bf16 value: two bf16 ulps
        np.testing.assert_allclose(got[real], want[real], rtol=2 * BF16_ULP, atol=1e-6)
    assert not got[~real].any()  # padding rows: exact zeros


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_message_matches_jax_kernel(batches, interpret, dtype, with_acc):
    jb, tb = batches
    n = tb.E.shape[0]
    gj, gt = _both(_rand((n, D), 10, dtype), dtype)
    yj, yt = _both(np.maximum(_rand((n, D), 11, dtype), 0), dtype)  # a ReLU output
    aj, at = _both(_rand((n, D), 12, dtype), dtype) if with_acc else (None, None)
    want_G, want_gz = _bwd_msg_impl(gj, yj, jb.src, jb.dst, jb.rev, jb.fused_window, gz_acc=aj)
    G, gz = bwd_message(gt, yt, *_graph(tb), gz_acc=at)
    real = tb.edge_mask.numpy()
    _close(G, want_G, real, dtype)
    _close(gz, want_gz, real, dtype)


def test_bwd_message_nodes_matches_jax_kernel(batches, interpret):
    jb, tb = batches
    n, n_nodes = tb.E.shape[0], tb.V.shape[0]
    g = _rand((n_nodes, D), 13, "bfloat16")
    g[-1] = 0  # the sacrificial node's cotangent is zero
    gj, gt = _both(g, "bfloat16")
    yj, yt = _both(np.maximum(_rand((n, D), 14, "bfloat16"), 0), "bfloat16")
    want_G, want_gz = _bwd_msg_nodes_impl(gj, yj, jb.src, jb.dst, jb.rev, jb.fused_window)
    G, gz = bwd_message_nodes(gt, yt, *_graph(tb))
    real = tb.edge_mask.numpy()
    _close(G, want_G, real, "bfloat16")
    _close(gz, want_gz, real, "bfloat16")
    # the same as the edge-cotangent form on the expanded table
    G2, gz2 = bwd_message(gt[tb.dst.long()], yt, *_graph(tb))
    assert torch.equal(G, G2) and torch.equal(gz, gz2)


@pytest.mark.parametrize("fold_h0", [False, True])
def test_bwd_message_premul_matches_jax_kernel(batches, interpret, fold_h0):
    jb, tb = batches
    n = tb.E.shape[0]
    Gj, Gt = _both(_rand((n, D), 15, "bfloat16"), "bfloat16")
    yj, yt = _both(np.maximum(_rand((n, D), 16, "bfloat16"), 0), "bfloat16")
    H0j, H0t = _both(_rand((n, D), 17, "bfloat16"), "bfloat16")
    Wj, Wt = _both(_rand((D, D), 18, "bfloat16", scale=D**-0.5), "bfloat16")
    want_G, want_z = _bwd_msg_premul_impl(
        Gj, yj, H0j if fold_h0 else None, Wj, jb.src, jb.dst, jb.rev, jb.fused_window, fold_h0
    )
    G, z = bwd_message_premul(Gt, yt, H0t, Wt, *_graph(tb), fold_h0=fold_h0)
    real = tb.edge_mask.numpy()
    # dh = G_in W^T sums 128 products in f32 in another order, so gz and z may
    # round to the neighbouring bf16 value, and G sums a few such values
    G, z = G.float().numpy(), z.float().numpy()
    want_G, want_z = np.asarray(want_G, np.float32), np.asarray(want_z, np.float32)
    np.testing.assert_allclose(z[real], want_z[real], rtol=2 * BF16_ULP, atol=1e-5)
    np.testing.assert_allclose(G[real], want_G[real], rtol=2 * BF16_ULP, atol=0.05)
    assert np.mean(np.abs(G[real] - want_G[real]) > BF16_ULP * np.abs(want_G[real]) + 1e-6) < 0.01
    assert not G[~real].any() and not z[~real].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_gather_matches_jax(batches, dtype):
    jb, tb = batches
    m = _rand((tb.n_graphs + 1, D), 19, dtype)
    m[-1] = 0  # the sacrificial graph's cotangent
    mj, mt = _both(m, dtype)
    want = np.asarray(window_gather(mj, jb.batch), np.float32)  # off the TPU: M[ids]
    got = row_gather(mt, tb.batch)
    assert got.dtype == mt.dtype and got.shape == (tb.V.shape[0], D)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_row_gather_zeros_the_sacrificial_id(batches):
    _, tb = batches
    m = torch.from_numpy(_rand((tb.n_graphs + 1, D), 20)).to(torch.bfloat16)
    got = row_gather(m, tb.batch)  # the last row of m is not zero here
    pad = (tb.batch == tb.n_graphs).numpy()
    assert pad.any() and not got[pad].any()
    assert torch.equal(got[~pad], m[tb.batch.long()][~pad])


def test_cpu_wrappers_count_no_launch(batches):
    _, tb = batches
    LAUNCHES.clear()
    z = torch.zeros((tb.E.shape[0], D), dtype=torch.bfloat16)
    W = torch.zeros((D, D), dtype=torch.bfloat16)
    bwd_message(z, z, *_graph(tb))
    bwd_message_nodes(torch.zeros((tb.V.shape[0], D), dtype=torch.bfloat16), z, *_graph(tb))
    bwd_message_premul(z, z, z, W, *_graph(tb), fold_h0=True)
    row_gather(W, tb.batch.clamp_max(D - 1))
    assert sum(LAUNCHES.values()) == 0


@pytest.mark.parametrize(
    "call",
    [
        lambda tb, z: bwd_message(z.double(), z.double(), *_graph(tb)),  # unsupported dtype
        lambda tb, z: bwd_message(z, z.float(), *_graph(tb)),  # y of another dtype
        lambda tb, z: bwd_message(z, z[:-1], *_graph(tb)),  # y of another shape
        lambda tb, z: bwd_message_nodes(z.float()[: tb.V.shape[0]], z.float(), *_graph(tb)),
        lambda tb, z: bwd_message_nodes(z[:5], z, *_graph(tb)),  # node table of the wrong height
        lambda tb, z: bwd_message_premul(z, z, None, z[:D], *_graph(tb), fold_h0=True),
        lambda tb, z: bwd_message_premul(z, z, None, z[:D].float(), *_graph(tb)),
        lambda tb, z: bwd_message_premul(z, z, None, z[: D - 1], *_graph(tb)),
        lambda tb, z: row_gather(z, tb.batch.long()),  # int64 ids
        lambda tb, z: row_gather(z[:, :3], tb.batch),  # not contiguous
    ],
)
def test_wrappers_reject_bad_inputs(batches, call):
    _, tb = batches
    z = torch.zeros((tb.E.shape[0], D), dtype=torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        call(tb, z)
