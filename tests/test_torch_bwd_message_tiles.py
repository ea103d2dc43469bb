"""Kernel F (``bwd_message``, the masked transposed message) over the molecule
tiles, on the CPU.

On a CUDA tensor with the batch's tile table the wrapper launches
``csrc/message_bwd_tiles.cu``: one launch over the tiles, each tile's rows of
g and y (and gz_acc) brought into shared memory and every row of G formed
from there. Here, on the CPU, the wrapper checks the table and takes its
plain version; these tests hold it against the JAX package's
``_bwd_msg_impl`` (its Pallas kernel in interpret mode) on ordinary molecules
and on the layouts that stress the design (salts, zero-edge molecules, a run
of 200 "C" between two molecules of one tile), in both dtypes, with and
without ``gz_acc``; the unmasked form (the message's own backward) against
the JAX message's VJP. They check the byte count of the kernel's bound, the
wrapper's refusals, which calls count in ``UNSERVED``, and that every route
whose backward runs F hands it the batch's table. test_torch_cuda.py runs the
kernel itself on the card."""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu.data import MoleculeDatapoint
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.ops.fused_message import _bwd_msg_impl, fused_message
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.nn import BondMessagePassing
from chemprop_tpu_torch.ops import (
    LAUNCHES,
    UNSERVED,
    KernelOptions,
    bwd_message,
    depth_loop,
    first_iter,
    loop_readout,
    message,
    message_iter,
)
from chemprop_tpu_torch.ops.message import bwd_message_plain
from test_torch_bwd_nodes import LAYOUTS, _malformed
from test_torch_kernels_bwd import SMIS

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import bwd_message_bytes  # noqa: E402

message_ops = sys.modules["chemprop_tpu_torch.ops.message"]  # the module, not ops.message()

D = 128
BF16_ULP = 2.0**-7
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BATCHES = {"ordinary": SMIS, **LAYOUTS}


@pytest.fixture(scope="module", params=sorted(BATCHES))
def batches(request):
    """The batch by both packages, padded to the same shapes."""
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(MoleculeDatapoint.from_smi(s).mol) for s in BATCHES[request.param]]
    pad = PadSpec.for_graphs(mgs)
    pad = pad._replace(n_nodes=max(pad.n_nodes, 256))  # the JAX kernel's node window
    jb = jax_batch(mgs, JaxPadSpec(*pad), sort_edges=True)
    assert jb.fused_ok  # the JAX kernel takes it
    tb = batch_mol_graphs(mgs, pad)
    assert tb.tile_ptr is not None
    return request.param, jb, tb


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")


def _graph(tb):
    return tb.src, tb.dst, tb.rev, tb.edge_ptr


def _both(n, seed, dtype, relu=False):
    """The same values as a jax array and a torch tensor of ``dtype``
    (bf16-representable in bfloat16)."""
    x = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    if relu:
        x = np.maximum(x, 0)  # a ReLU output
    t = torch.from_numpy(x).to(TORCH_DTYPES[dtype])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(t.float().numpy(), jdt), t


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


@pytest.mark.parametrize("with_acc", [False, True], ids=["no_acc", "acc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_matches_jax_kernel(batches, interpret, dtype, with_acc):
    name, jb, tb = batches
    n = tb.E.shape[0]
    gj, gt = _both(n, 10, dtype)
    yj, yt = _both(n, 11, dtype, relu=True)
    aj, at = _both(n, 12, dtype) if with_acc else (None, None)
    want_G, want_gz = _bwd_msg_impl(gj, yj, jb.src, jb.dst, jb.rev, jb.fused_window, gz_acc=aj)
    LAUNCHES.clear()
    UNSERVED.clear()
    G, gz = bwd_message(gt, yt, *_graph(tb), gz_acc=at, tiles=tb.tile_ptr)
    assert sum(LAUNCHES.values()) == 0  # the plain version: no kernel on the CPU
    assert UNSERVED["bwd_message"] == 0
    real = tb.edge_mask.numpy()
    _close(G, want_G, real, dtype)
    _close(gz, want_gz, real, dtype)
    # the function does not depend on the table: without one, the same bits
    G2, gz2 = bwd_message(gt, yt, *_graph(tb), gz_acc=at)
    assert torch.equal(G, G2) and torch.equal(gz, gz2)
    assert UNSERVED["bwd_message"] == 1


def _spy(monkeypatch):
    """Record the tile table of every call of F (``ops.message._transposed``,
    which ``bwd_message`` and the message's backward both take)."""
    seen = []
    real = message_ops._transposed

    def spy(g, y, acc, graph, tiles, with_gz):
        seen.append((tiles, y is not None, acc is not None))
        return real(g, y, acc, graph, tiles, with_gz)

    monkeypatch.setattr(message_ops, "_transposed", spy)
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unmasked_form_matches_jax_message_vjp(batches, interpret, monkeypatch, dtype):
    """The message's own backward is F without its mask and without gz, over
    the batch's table: the JAX message's VJP, whose Pallas kernel runs with
    the roles of src and dst swapped."""
    name, jb, tb = batches
    n = tb.E.shape[0]
    Hj, Ht = _both(n, 13, dtype)
    cj, ct = _both(n, 14, dtype)
    n_nodes = jb.V.shape[0]
    _, vjp = jax.vjp(lambda h: fused_message(h, jb.src, jb.dst, jb.rev, n_nodes,
                                             jb.fused_window), Hj)
    (want,) = vjp(cj)
    seen = _spy(monkeypatch)
    UNSERVED.clear()
    x = Ht.clone().requires_grad_()
    (got,) = torch.autograd.grad(message(x, *_graph(tb), tb.tile_ptr), x, ct)
    assert seen == [(tb.tile_ptr, False, False)]
    assert UNSERVED["bwd_message"] == 0
    _close(got, want, tb.edge_mask.numpy(), dtype)
    assert torch.equal(got, bwd_message_plain(ct, None, *_graph(tb))[0])


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "message_backward"])
@pytest.mark.parametrize("acc", [False, True], ids=["no_acc", "acc"])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", [128, 384])
def test_bwd_message_bytes_counts_only_what_the_kernel_moves(batches, d, itemsize, acc, masked):
    """The bound's byte count: g (and y with the mask, gz_acc with acc) over
    the real rows only, G (and gz with the mask) over every row, dst and rev
    of the real rows, the tile table and one entry of ptr."""
    _, _, tb = batches
    n_e, n_real = tb.E.shape[0], int(tb.edge_mask.sum())
    assert n_real < n_e
    reads = n_real * (1 + masked + acc)
    writes = n_e * (2 if masked else 1)
    want = (reads + writes) * d * itemsize + 8 * n_real + 4 * tb.tile_ptr.numel() + 4
    assert bwd_message_bytes(tb, d, itemsize, acc, masked) == want


@pytest.fixture(scope="module")
def salts():
    feat = SimpleMoleculeMolGraphFeaturizer()
    return batch_mol_graphs([feat(MoleculeDatapoint.from_smi(s).mol)
                             for s in LAYOUTS["salts"]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["past_the_end", "short_of_the_end", "not_from_zero",
                                  "tile_too_large", "descending", "int64", "two_dimensional",
                                  "one_offset"])
def test_refuses_a_malformed_table(salts, case, dtype):
    n = salts.E.shape[0]
    z = torch.zeros((n, D), dtype=TORCH_DTYPES[dtype])
    with pytest.raises(ValueError):
        bwd_message(z, z, *_graph(salts), tiles=_malformed(salts.tile_ptr, n)[case])


def test_refuses_a_table_on_another_device(salts):
    z = torch.zeros((salts.E.shape[0], D))
    with pytest.raises(ValueError):
        bwd_message(z, z, *_graph(salts), tiles=salts.tile_ptr.to("meta"))


def _big_batch():
    """A batch holding a molecule of more rows than a tile: no tile table."""
    feat = SimpleMoleculeMolGraphFeaturizer()
    b = batch_mol_graphs([feat(MoleculeDatapoint.from_smi(s).mol)
                          for s in ["CCO", "C", "[Na+].CC(=O)[O-]", "C" * 70]])
    assert b.tile_ptr is None
    return b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["d64", "d300", "no_table"])
def test_a_call_the_tiled_kernel_does_not_take_counts_unserved(salts, dtype, case):
    """A width that is no multiple of 128, or a batch without a table: the
    node-warp form, counted in UNSERVED, with the plain version's values."""
    b, d = (_big_batch(), D) if case == "no_table" else (salts, int(case[1:]))
    rng = np.random.default_rng(5)
    g, y, acc = (torch.from_numpy(rng.standard_normal((b.E.shape[0], d)).astype(np.float32))
                 .to(TORCH_DTYPES[dtype]) for _ in range(3))
    UNSERVED.clear()
    G, gz = bwd_message(g, y, *_graph(b), gz_acc=acc, tiles=b.tile_ptr)
    assert UNSERVED["bwd_message"] == 1
    want_G, want_gz = bwd_message_plain(g, y, *_graph(b), gz_acc=acc)
    assert torch.equal(G, want_G) and torch.equal(gz, want_gz)


def _leaves(tb, dtype, seed=9):
    g = torch.Generator().manual_seed(seed)
    n = tb.E.shape[0]
    pad = ~tb.edge_mask[:, None]
    H0 = torch.randn((n, D), generator=g).to(dtype).masked_fill(pad, 0).requires_grad_()
    H = torch.randn((n, D), generator=g).clamp_min(0).to(dtype).masked_fill(pad, 0)
    W = (torch.randn((D, D), generator=g) * D**-0.5).to(dtype).requires_grad_()
    return H0, H.requires_grad_(), W


def _check_route(seen, tb, calls):
    assert len(seen) == calls and all(t is tb.tile_ptr for t, _, _ in seen)
    assert UNSERVED["bwd_message"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_first_iter_hands_the_table_to_f(salts, monkeypatch, dtype):
    seen = _spy(monkeypatch)
    H0, _, W = _leaves(salts, TORCH_DTYPES[dtype])
    UNSERVED.clear()
    y = first_iter(H0, W, None, *_graph(salts), None, salts.tile_ptr)
    torch.autograd.grad(y.float().sum(), [H0, W])
    _check_route(seen, salts, 1)
    assert seen[0][1:] == (True, False)  # masked, no gz_acc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_message_iter_hands_the_table_to_f(salts, monkeypatch, dtype):
    seen = _spy(monkeypatch)
    H0, H, W = _leaves(salts, TORCH_DTYPES[dtype])
    UNSERVED.clear()
    y = message_iter(H, H0, W, None, *_graph(salts), None, salts.tile_ptr)
    torch.autograd.grad(y.float().sum(), [H, H0, W])
    _check_route(seen, salts, 1)


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depth_loop_hands_the_table_to_f(salts, monkeypatch, dtype, depth):
    """One F per iteration, every one after the first with the running dH0
    (gz_acc), each over the batch's table."""
    seen = _spy(monkeypatch)
    H0, _, W = _leaves(salts, TORCH_DTYPES[dtype])
    UNSERVED.clear()
    H = depth_loop(H0, W, None, *_graph(salts), depth, None, salts.tile_ptr)
    torch.autograd.grad(H.float().sum(), [H0, W])
    _check_route(seen, salts, depth - 1)
    assert [a for _, _, a in seen] == [False] + [True] * (depth - 2)


@pytest.mark.parametrize("depth", [2, 3])
def test_loop_readout_float32_chain_hands_the_table_to_f(salts, monkeypatch, depth):
    """The float32 loop_readout's backward is the per-iteration chain: F per
    iteration over the batch's table."""
    seen = _spy(monkeypatch)
    H0, _, W = _leaves(salts, torch.float32)
    UNSERVED.clear()
    M_v = loop_readout(H0, W, None, *_graph(salts), depth, None, salts.tile_ptr)
    torch.autograd.grad(M_v.sum(), [H0, W])
    _check_route(seen, salts, depth - 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_composed_message_hands_the_table_to_f(salts, monkeypatch, dtype):
    """A tanh model composes the message through autograd: each message's
    backward is F without its mask, over the batch's table."""
    seen = _spy(monkeypatch)
    mp = BondMessagePassing(d_h=64, compute_dtype=TORCH_DTYPES[dtype], activation="tanh")
    UNSERVED.clear()
    out = mp(salts, is_training=True)
    torch.autograd.grad(out.float().sum(), list(mp.parameters()))
    _check_route(seen, salts, mp.depth - 1)
    assert all(not masked for _, masked, _ in seen)


@pytest.mark.parametrize("options,dropout,calls",
                         [(KernelOptions(), 0.0, 2), (KernelOptions(), 0.2, 2),
                          (KernelOptions(depth_loop=True), 0.0, 2)],
                         ids=["loop_readout", "dropout", "depth_loop"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_message_passing_hands_the_table_to_f(salts, monkeypatch, dtype, options, dropout,
                                              calls):
    """The default model's training routes that run F (the bfloat16 one
    without dropout takes G and H instead): each F call gets the batch's
    table, none is unserved."""
    seen = _spy(monkeypatch)
    mp = BondMessagePassing(d_h=64, compute_dtype=TORCH_DTYPES[dtype], dropout=dropout,
                            kernel_options=options)
    UNSERVED.clear()
    out = mp(salts, is_training=True, generator=torch.Generator().manual_seed(0))
    torch.autograd.grad(out.float().sum(), list(mp.parameters()))
    runs_f = dtype == "float32" or dropout > 0 or options.depth_loop
    _check_route(seen, salts, calls if runs_f else 0)
