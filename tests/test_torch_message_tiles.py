"""Kernel A (``message``) over the molecule tiles, on the CPU.

On a CUDA tensor with the batch's tile table the wrapper launches
``csrc/message_tiles.cu``: one launch over the tiles, each tile's rows of H
brought into shared memory and every message row formed from there. Here,
on the CPU, the wrapper checks the table and takes its plain version; these
tests hold it against the JAX package's ``_fused_message_impl`` (its Pallas
kernel in interpret mode) on the layouts that stress the design: salts,
zero-edge molecules ("C"), and a run of 200 "C" between two molecules of one
tile. They check the byte count of the kernel's bound and that the sparse
product the smoke run times beside the kernel computes the same function,
the wrapper's refusals, which calls count in ``UNSERVED``, that every path
of ``BondMessagePassing`` that forms a message hands the kernel the table,
and that the composed models (tanh, ``undirected``) through ``MPNN`` stay
within the JAX package's tolerances. test_torch_cuda.py runs the kernel
itself on the card."""

from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu import data as jdata
from chemprop_tpu.data import MoleculeDatapoint
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.ops.fused_message import _fused_message_impl
from chemprop_tpu.train import Trainer as JaxTrainer
from chemprop_tpu_torch.data import DataLoader
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.models import from_jax_params
from chemprop_tpu_torch.nn import BondMessagePassing
from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED, KernelOptions, message
from chemprop_tpu_torch.ops.message import message_plain, message_tile_width
from test_torch_bwd_nodes import LAYOUTS, _malformed
from test_torch_per_iteration import (  # noqa: F401  (fixtures)
    _interpret,
    _models,
    datasets,
    one_torch_thread,
)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import message_bytes, message_matrix  # noqa: E402

message_ops = sys.modules["chemprop_tpu_torch.ops.message"]  # the module, not ops.message()
mp_base = sys.modules["chemprop_tpu_torch.nn.message_passing.base"]

D = 128
BF16_ULP = 2.0**-7
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def batches(request):
    """The layout batched by both packages to the same padded shapes."""
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(MoleculeDatapoint.from_smi(s).mol) for s in LAYOUTS[request.param]]
    pad = PadSpec.for_graphs(mgs)
    pad = pad._replace(n_nodes=max(pad.n_nodes, 256))  # the JAX kernel's node window
    jb = jax_batch(mgs, JaxPadSpec(*pad), sort_edges=True)
    assert jb.fused_ok  # the JAX message kernel takes it
    tb = batch_mol_graphs(mgs, pad)
    assert tb.tile_ptr is not None
    return request.param, jb, tb


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")


def _graph(tb):
    return tb.src, tb.dst, tb.rev, tb.edge_ptr


def _table(n, seed, dtype):
    """The same values for both packages: bf16-representable in bfloat16."""
    x = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    t = torch.from_numpy(x).to(TORCH_DTYPES[dtype])
    return jnp.asarray(t.float().numpy(), jnp.bfloat16 if dtype == "bfloat16" else jnp.float32), t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_matches_jax_kernel(batches, interpret, dtype):
    name, jb, tb = batches
    Hj, Ht = _table(tb.E.shape[0], 5, dtype)
    want = np.asarray(_fused_message_impl(Hj, jb.src, jb.dst, jb.rev, jb.fused_window), np.float32)
    LAUNCHES.clear()
    UNSERVED.clear()
    got = message(Ht, *_graph(tb), tb.tile_ptr)
    assert sum(LAUNCHES.values()) == 0  # the plain version: no kernel on the CPU
    assert UNSERVED["message"] == 0
    real = tb.edge_mask.numpy()
    g = got.float().numpy()
    if dtype == "float32":
        # the JAX kernel splits f32 into bf16 hi + lo parts (~16 significant
        # bits); the port sums in full f32
        np.testing.assert_allclose(g[real], want[real], rtol=1e-4, atol=1e-4)
    else:  # both sum in f32 and round once: at most one bf16 rounding apart
        np.testing.assert_allclose(g[real], want[real], rtol=BF16_ULP, atol=1e-6)
    assert not g[~real].any()  # padding rows: exact zeros
    # the function does not depend on the table: without one, the same bits
    assert torch.equal(got, message(Ht, *_graph(tb)))
    assert UNSERVED["message"] == 1


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", [128, 384])
def test_message_bytes_counts_only_what_the_kernel_moves(batches, d, itemsize):
    """The bound's byte count: H over the real rows only, M over every row,
    src and rev of the real rows, the ptr entries of the real nodes and the
    one of the first padding row, and the tile table."""
    _, _, tb = batches
    n_e, n_real = tb.E.shape[0], int(tb.edge_mask.sum())
    n_nodes = int(tb.node_mask.sum())
    assert n_real < n_e and n_nodes < tb.V.shape[0]
    want = ((n_real + n_e) * d * itemsize + 8 * n_real + 4 * (n_nodes + 1) + 4
            + 4 * tb.tile_ptr.numel())
    assert message_bytes(tb, d, itemsize) == want


def test_sparse_yardstick_computes_the_message(batches):
    """``S - R`` in CSR form times H, the one library call the smoke run
    times beside the kernel, is the message on the real rows and zero on the
    padding rows; it holds one entry per in-edge of a row's source other
    than the row's reverse."""
    _, _, tb = batches
    H = torch.from_numpy(np.random.default_rng(7).standard_normal((tb.E.shape[0], D))
                         .astype(np.float32))
    SR = message_matrix(tb)
    got = torch.sparse.mm(SR, H)
    want = message_plain(H, *_graph(tb))
    # the same terms; the reverse row's +1 and -1 cancel in the matrix, so
    # the sums differ from the plain version's by f32 rounding only
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    real = tb.edge_mask
    assert not got[~real].any()
    src, ptr = tb.src.long(), tb.edge_ptr.long()
    in_deg = (ptr[src + 1] - ptr[src])[real]
    assert SR.values().numel() == int((in_deg - 1).sum()) and bool((SR.values() == 1).all())


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
    H = torch.zeros((n, D), dtype=TORCH_DTYPES[dtype])
    with pytest.raises(ValueError):
        message(H, *_graph(salts), _malformed(salts.tile_ptr, n)[case])


def test_refuses_a_table_on_another_device(salts):
    H = torch.zeros((salts.E.shape[0], D))
    with pytest.raises(ValueError):
        message(H, *_graph(salts), salts.tile_ptr.to("meta"))


@pytest.mark.parametrize("d,served", [(128, True), (384, True), (512, True), (1024, True),
                                      (64, False), (200, False), (300, False), (1152, False)])
def test_the_widths_the_tiled_kernel_takes(d, served):
    assert message_tile_width(d) == served


@pytest.mark.parametrize("d", [64, 300])
def test_a_width_the_tiled_kernel_does_not_take_counts_unserved(salts, d):
    H = torch.from_numpy(np.random.default_rng(3).standard_normal((salts.E.shape[0], d))
                         .astype(np.float32))
    UNSERVED.clear()
    got = message(H, *_graph(salts), salts.tile_ptr)
    assert UNSERVED["message"] == 1
    assert torch.equal(got, message_plain(H, *_graph(salts)))


def _big_batch():
    """A batch holding a molecule of more rows than a tile: no tile table."""
    feat = SimpleMoleculeMolGraphFeaturizer()
    b = batch_mol_graphs([feat(MoleculeDatapoint.from_smi(s).mol)
                          for s in ["CCO", "C", "[Na+].CC(=O)[O-]", "C" * 70]])
    assert b.tile_ptr is None
    return b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_batch_without_a_table_counts_unserved(dtype):
    b = _big_batch()
    H = torch.from_numpy(np.random.default_rng(4).standard_normal((b.E.shape[0], D))
                         .astype(np.float32)).to(TORCH_DTYPES[dtype])
    UNSERVED.clear()
    got = message(H, *_graph(b), b.tile_ptr)
    assert UNSERVED["message"] == 1
    assert torch.equal(got, message_plain(H, *_graph(b)))


def _spy(monkeypatch, module, name):
    """Record the tile table of every call of ``module.name``."""
    seen = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        seen.append(args[5] if len(args) > 5 else kwargs.get("tiles"))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kwargs", [dict(activation="tanh"), dict(undirected=True),
                                    dict(activation="tanh", depth=2)],
                         ids=["tanh", "undirected", "tanh_depth2"])
def test_composed_path_hands_the_table_to_message(salts, monkeypatch, dtype, kwargs):
    """Another activation, or undirected, composes ``message`` through
    autograd: every one of its depth - 1 calls gets the batch's table, and
    none is unserved."""
    seen = _spy(monkeypatch, mp_base, "message")
    mp = BondMessagePassing(d_h=64, compute_dtype=TORCH_DTYPES[dtype], **kwargs)
    UNSERVED.clear()
    out = mp(salts, is_training=True)
    torch.autograd.grad(out.float().sum(), list(mp.parameters()))
    assert len(seen) == mp.depth - 1 and all(t is salts.tile_ptr for t in seen)
    assert UNSERVED["message"] == 0


@pytest.mark.parametrize("options,dropout", [(KernelOptions(), 0.0),
                                             (KernelOptions(fused_readout=False), 0.0),
                                             (KernelOptions(), 0.2)],
                         ids=["loop_readout", "per_iteration", "dropout"])
def test_float32_iterations_hand_the_table_to_message(salts, monkeypatch, options, dropout):
    """The float32 ReLU model forms its messages inside ``loop_readout``, or
    ``first_iter`` and ``message_iter``: each of them passes the batch's table
    to the message kernel."""
    seen = _spy(monkeypatch, message_ops, "_message_fwd")
    mp = BondMessagePassing(d_h=64, compute_dtype=torch.float32, dropout=dropout,
                            kernel_options=options)
    UNSERVED.clear()
    mp(salts, is_training=True, generator=torch.Generator().manual_seed(0))
    assert len(seen) == mp.depth - 1 and all(t is salts.tile_ptr for t in seen)
    assert UNSERVED["message"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["tanh", "undirected"])
def test_composed_models_match_jax(datasets, monkeypatch, kind, dtype):
    """A tanh model and an undirected model through ``MPNN``, from the JAX
    package's initial parameters, on one batch of 32: the predictions agree
    within the JAX package's tolerances, and every message went over the
    batch's tile table."""
    _interpret(monkeypatch, dtype)
    mp_kwargs = dict(activation="tanh") if kind == "tanh" else dict(undirected=True)
    jds, tds = datasets
    jmodel, model = _models(mp_kwargs, dtype)
    jb = next(iter(jdata.DataLoader(jds, batch_size=32, shuffle=False, prefetch=0)))
    tb = next(iter(DataLoader(tds, batch_size=32, shuffle=False)))
    state = JaxTrainer(jmodel, max_epochs=50, warmup_epochs=2, seed=12).init_state(jb, 4)
    model.load_state_dict(from_jax_params(state.params, state.batch_stats))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    want = np.asarray(jmodel.apply(variables, jb.bmg, None, None, is_training=False), np.float32)
    LAUNCHES.clear()
    UNSERVED.clear()
    with torch.no_grad():
        got = model.eval()(tb.bmg).float().numpy()
    assert sum(LAUNCHES.values()) == 0 and UNSERVED["message"] == 0
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:  # the JAX package's bf16 parity envelope
        np.testing.assert_allclose(got, want, rtol=0.05, atol=0.1)
    assert not np.allclose(want, want[0])  # the molecules' predictions differ
