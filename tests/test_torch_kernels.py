"""The port's three kernels (chemprop_tpu_torch.ops) against the JAX package's
functions, on the same inputs made with numpy from a seed.

On the CPU each wrapper takes its plain PyTorch version; the JAX side runs
its Pallas kernels as its own tests do: the message and the fused iteration
in interpret mode (CHEMPROP_TPU_INTERPRET=1), the sorted segment sum through
its CPU reference. Rows of padding edges are left out: the JAX kernels leave
garbage there, the port zeros. test_torch_cuda.py holds each CUDA kernel
against its plain version on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chemprop_tpu.data import MoleculeDatapoint
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.ops.fused_message import _fused_message_impl, _iter_impl
from chemprop_tpu.ops.sorted_segments import sorted_segment_sum as jax_segment_sum
from chemprop_tpu.ops.sorted_segments import sorted_segment_sum_counts as jax_segment_sum_counts
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.ops import LAUNCHES, fused_iter, message
from chemprop_tpu_torch.ops import sorted_segment_sum, sorted_segment_sum_counts

SMIS = [
    "CCO",
    "c1ccccc1",
    "CC(=O)Nc1ccc(O)cc1",
    "CNC(C)Cc1ccccc1",
    "CC(C)CC1=CC=C(C=C1)C(C)C(=O)O",
    "c1ccc2ccccc2c1",
    "CC(=O)OC1=CC=CC=C1C(=O)O",
    "C1CCNCC1",
    "C",  # zero-edge molecule: an empty segment
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
    assert jb.fused_ok
    return jb, batch_mol_graphs(mgs, PadSpec(*pad))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")


def _graph(tb):
    return tb.src, tb.dst, tb.rev, tb.edge_ptr


def _rand(shape, seed, dtype=np.float32, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    if dtype == "bfloat16":  # bf16-representable values, handed to both packages
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _both(x, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_message_matches_jax_kernel(batches, interpret, dtype):
    jb, tb = batches
    Hj, Ht = _both(_rand((tb.E.shape[0], D), 0, dtype), dtype)
    want = np.asarray(_fused_message_impl(Hj, jb.src, jb.dst, jb.rev, jb.fused_window), np.float32)
    got = message(Ht, *_graph(tb)).float().numpy()
    real = tb.edge_mask.numpy()
    if dtype == "float32":
        # the JAX kernel splits f32 into bf16 hi + lo parts (~16 significant
        # bits); the port sums in full f32
        np.testing.assert_allclose(got[real], want[real], rtol=1e-4, atol=1e-4)
    else:
        # both sum in f32 and cast once: at most one bf16 rounding apart
        np.testing.assert_allclose(got[real], want[real], rtol=BF16_ULP, atol=1e-6)
    assert not got[~real].any()  # padding rows: exact zeros


@pytest.mark.parametrize("relu_stream", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_iter_matches_jax_kernel(batches, interpret, relu_stream, bias):
    jb, tb = batches
    n = tb.E.shape[0]
    Hj, Ht = _both(_rand((n, D), 1, "bfloat16"), "bfloat16")
    H0j, H0t = _both(_rand((n, D), 2, "bfloat16"), "bfloat16")
    Wj, Wt = _both(_rand((D, D), 3, "bfloat16", scale=D**-0.5), "bfloat16")
    bj, bt = _both(_rand((D,), 4, "bfloat16"), "bfloat16") if bias else (None, None)
    if relu_stream:  # the first iteration streams relu(H0) from H0 itself
        Hj, Ht = H0j, H0t
    graph = (jb.src, jb.dst, jb.rev, jb.fused_window)
    want = np.asarray(_iter_impl(Hj, H0j, Wj, bj, *graph, relu_stream=relu_stream), np.float32)
    got = fused_iter(Ht, H0t, Wt, bt, *_graph(tb), relu_stream=relu_stream).float().numpy()
    real = tb.edge_mask.numpy()
    # the bf16 message may round one ulp apart (f32 sums in another order);
    # through W that moves y by about one ulp of |M| |W|, and y's own bf16
    # rounding adds one ulp of y
    np.testing.assert_allclose(got[real], want[real], rtol=2 * BF16_ULP, atol=0.05)
    assert np.mean(np.abs(got[real] - want[real]) > BF16_ULP * np.abs(want[real]) + 1e-6) < 0.01


@pytest.mark.parametrize(
    "data_dtype,out_dtype",
    [(a, b) for a in ("float32", "bfloat16") for b in ("float32", "bfloat16")],
)
@pytest.mark.parametrize("readout", ["edge_to_node", "node_to_graph"])
def test_segment_sum_matches_jax(batches, readout, data_dtype, out_dtype):
    jb, tb = batches
    if readout == "edge_to_node":
        ids_j, ids_t, ptr, n_seg = jb.dst, tb.dst, tb.edge_ptr, tb.V.shape[0]
    else:
        ids_j, ids_t, ptr, n_seg = jb.batch, tb.batch, tb.node_ptr, tb.n_graphs + 1
    x = _rand((ids_t.shape[0], D), 5, data_dtype)
    _, xt = _both(x, data_dtype)
    jdt = jnp.bfloat16 if out_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if out_dtype == "bfloat16" else torch.float32
    # JAX's CPU reference sums in the data dtype, so it is handed the f32
    # values (bf16-representable where the port gets bf16): both then sum in
    # f32 and cast once
    want = np.asarray(jax_segment_sum(jnp.asarray(x), ids_j, n_seg, jdt), np.float32)
    got = sorted_segment_sum(xt, ids_t, ptr, tdt).float().numpy()
    assert got.shape == want.shape == (n_seg, D)
    rtol = BF16_ULP if out_dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("data_dtype", ["float32", "bfloat16"])
def test_segment_sum_counts_matches_jax(batches, data_dtype):
    jb, tb = batches
    x = _rand((tb.V.shape[0], D), 6, data_dtype)
    _, xt = _both(x, data_dtype)
    want, want_counts = jax_segment_sum_counts(
        jnp.asarray(x), jb.batch, jb.n_graphs + 1, jnp.float32
    )
    got, counts = sorted_segment_sum_counts(xt, tb.batch, tb.node_ptr)
    assert got.dtype == counts.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    assert counts[SMIS.index("C")] == 1  # one atom, no edges


def test_cpu_wrappers_count_no_launch(batches):
    _, tb = batches
    LAUNCHES.clear()
    H = torch.zeros((tb.E.shape[0], D), dtype=torch.bfloat16)
    W = torch.zeros((D, D), dtype=torch.bfloat16)
    message(H, *_graph(tb))
    fused_iter(H, H, W, None, *_graph(tb))
    sorted_segment_sum(H, tb.dst, tb.edge_ptr)
    assert sum(LAUNCHES.values()) == 0


@pytest.mark.parametrize(
    "call",
    [
        lambda tb, H: message(H.double(), *_graph(tb)),  # unsupported dtype
        lambda tb, H: message(H, tb.src.long(), tb.dst, tb.rev, tb.edge_ptr),  # int64 ids
        lambda tb, H: fused_iter(H.float(), H.float(), torch.zeros(D, D), None, *_graph(tb)),
        lambda tb, H: fused_iter(H, H, torch.zeros((D, D + 1), dtype=H.dtype), None, *_graph(tb)),
        lambda tb, H: sorted_segment_sum(H[:, :3].contiguous().T, tb.dst, tb.edge_ptr),
        lambda tb, H: sorted_segment_sum(H[:-1], tb.dst, tb.edge_ptr),  # ids do not fit
    ],
)
def test_wrappers_reject_bad_inputs(batches, call):
    _, tb = batches
    H = torch.zeros((tb.E.shape[0], D), dtype=torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        call(tb, H)
