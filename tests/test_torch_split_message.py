"""Kernels A (``message``) and F (``bwd_message``) over a split tile table,
on the CPU.

A batch that holds a molecule of more than 128 directed edges has no tile
table. Its ``split_ptr`` cuts such molecules at their nodes' boundaries and
``cross_rows`` lists the rows whose sum reads another tile (Tox21,
``classification/mol.csv``, has 8 such molecules, the largest of 264 edges).
On a CUDA tensor A and F launch their tile kernels over that table and then a
second pass over those rows (``message_rows`` of ``csrc/message.cu``,
``bwd_message_rows`` of ``csrc/message_bwd.cu``); on a CPU tensor the
wrappers take the full plain version and then the pass's plain version over
the same rows. These tests show that every route of the message passing
hands A and F the split table (nothing counted in ``UNSERVED``, the card's
launches counted by a rehearsal), hold the passes' plain versions to the
full plain versions, check that the one list of cross rows covers every row
A's tile kernel cannot form, check the refusals, and hold a small f32 model
on a batch with the 264-edge molecule against the JAX package: the whole
model against its plain CPU path, and A and F against its Pallas kernels at
window width 3 in interpret mode. test_torch_cuda.py runs the kernels on the
card (``-k split``)."""

from __future__ import annotations

import csv
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu import data as jdata
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import (
    SimpleMoleculeMolGraphFeaturizer as JaxFeaturizer,
)
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.ops.fused_message import _bwd_msg_impl, _fused_message_impl, fused_message
from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.data import DataLoader, MoleculeDatapoint, MoleculeDataset
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.data.datasets import MulticomponentDataset
from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.models import MPNN, MulticomponentMPNN, from_jax_params
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.nn.message_passing import MulticomponentMessagePassing
from chemprop_tpu_torch.ops import (
    UNSERVED,
    bwd_message,
    depth_loop,
    first_iter,
    loop_readout,
    message,
    message_iter,
)
from chemprop_tpu_torch.ops.message import (
    bwd_message_plain,
    bwd_message_rows_plain,
    message_plain,
    message_rows_plain,
)
from chemprop_tpu_torch.train import Trainer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the rehearsal that counts the card's launches)

DATA = Path(__file__).resolve().parent / "data"
D = 128
D_H = 64
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# rows 300-349 of Tox21 hold three molecules of more than 128 directed edges,
# row 304 the largest (264)
WINDOW = slice(300, 350)
LARGEST = 304
# the JAX comparison's five molecules, Tox21's 264-edge one among them
SMALL = ["CCO", "c1ccccc1", "CC(=O)Nc1ccc(O)cc1", "[Na+].CC(=O)[O-]"]


@pytest.fixture(scope="module")
def tox21():
    """Tox21's SMILES and their graphs, featurised once."""
    with open(DATA / "classification" / "mol.csv", newline="") as f:
        smis = [row[0] for row in list(csv.reader(f))[1:]]
    feat = SimpleMoleculeMolGraphFeaturizer()
    return smis, [feat(make_mol(s)) for s in smis]


@pytest.fixture(scope="module")
def split_batch(tox21):
    b = batch_mol_graphs(tox21[1][WINDOW])
    assert b.tile_ptr is None and b.split_ptr is not None and b.cross_rows.numel() > 0
    return b


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(b):
    return b.src, b.dst, b.rev, b.edge_ptr


def _rand(shape, seed, dtype=torch.float32, relu=False):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))
    return (x.clamp_min(0) if relu else x).to(dtype)


def _rehearsed(run):
    """``run()`` under a rehearsal: the launches the same run makes on the
    card, and the calls it leaves without a table."""
    UNSERVED.clear()
    with chip_smoke.rehearsal() as counts:
        run()
    return dict(counts), {k: v for k, v in UNSERVED.items() if v}


# ------------------------------------------------------ every route serves
def _mp_step(b, dtype, **mp_kwargs):
    mp = BondMessagePassing(d_v=b.V.shape[1], d_e=b.E.shape[1], d_h=D_H, depth=3,
                            compute_dtype=dtype, **mp_kwargs)
    out = mp(b, is_training=True, generator=torch.Generator().manual_seed(0))
    torch.autograd.grad(out.float().sum(), list(mp.parameters()))


@pytest.mark.parametrize("case", ["float32", "bfloat16_dropout", "tanh"])
def test_every_route_takes_the_split_table(split_batch, case):
    """An f32 forward and backward at depth 3 (``loop_readout``: two A, then
    the chain's two F), a bf16 step with dropout 0.1 (the per-iteration ops:
    two F) and the composed tanh route (two A and their two transposes):
    every A and F over the split table, each followed by its second pass,
    nothing unserved."""
    kwargs = {"float32": (torch.float32, {}),
              "bfloat16_dropout": (torch.bfloat16, dict(dropout=0.1)),
              "tanh": (torch.float32, dict(activation="tanh"))}[case]
    counts, unserved = _rehearsed(lambda: _mp_step(split_batch, kwargs[0], **kwargs[1]))
    assert not unserved
    a = 0 if case == "bfloat16_dropout" else 2
    assert counts.get("message", 0) == counts.get("message_rows", 0) == a, counts
    assert counts["bwd_message"] == counts["bwd_message_rows"] == 2, counts


def test_a_multicomponent_step_takes_each_components_table():
    """One f32 training step of a mol+mol ``MulticomponentMPNN``: the dyes'
    component has a split table and the solvents' a tile table; A and F run
    over both, the passes only over the split one, nothing unserved."""
    with open(DATA / "regression" / "mol+mol" / "mol+mol.csv", newline="") as f:
        rows = list(csv.reader(f))[1:]
    dsets = [MoleculeDataset([MoleculeDatapoint.from_smi(r[c], y=np.array([float(r[2])]))
                              for r in rows]) for c in (0, 1)]
    loader = DataLoader(MulticomponentDataset(dsets), batch_size=50)
    batch = next(b for b in loader if b.bmg[0].split_ptr is not None)
    assert batch.bmg[1].tile_ptr is not None
    widths = [(g.V.shape[1], g.E.shape[1]) for g in batch.bmg]
    blocks = [BondMessagePassing(d_v=v, d_e=e, d_h=D_H) for v, e in widths]
    model = MulticomponentMPNN(MulticomponentMessagePassing(blocks, 2, False), MeanAggregation(),
                               RegressionFFN(input_dim=2 * D_H, hidden_dim=D_H))
    trainer = Trainer(model, max_epochs=2, warmup_epochs=1, device="cpu")
    trainer.init_state(batch, 2)
    counts, unserved = _rehearsed(lambda: trainer.train_step(batch))
    assert not unserved
    assert counts["message"] == counts["bwd_message"] == 4, counts
    assert counts["message_rows"] == counts["bwd_message_rows"] == 2, counts


@pytest.mark.parametrize("route", ["first_iter", "message_iter", "depth_loop", "loop_readout"])
def test_each_route_hands_a_and_f_the_split_table(split_batch, route):
    """Each route of ``ops.message`` in f32 with the split table as ``split``:
    its A and F calls are over it, nothing unserved, and it gives the values
    it gives without a table."""
    b = split_batch
    graph, n = _graph(b), b.E.shape[0]
    H0 = _rand((n, D), 1).masked_fill(~b.edge_mask[:, None], 0)
    W = _rand((D, D), 2) * D**-0.5

    def run(split):
        x, w = H0.clone().requires_grad_(), W.clone().requires_grad_()
        if route == "first_iter":
            out = first_iter(x, w, None, *graph, None, None, split)
        elif route == "message_iter":
            out = message_iter(torch.relu(x), x, w, None, *graph, None, None, split)
        elif route == "depth_loop":
            out = depth_loop(x, w, None, *graph, 3, None, None, split)
        else:
            out = loop_readout(x, w, None, *graph, 3, None, None, split)
        return (out, *torch.autograd.grad(out.sum(), [x, w]))

    want = run(None)
    split = (b.split_ptr, b.cross_rows)
    counts, unserved = _rehearsed(lambda: run(split))
    assert not unserved
    calls = 1 if route in ("first_iter", "message_iter") else 2
    for k in ("message", "message_rows", "bwd_message", "bwd_message_rows"):
        assert counts[k] == calls, counts
    assert all(torch.equal(g, w) for g, w in zip(run(split), want))


# --------------------------------------------------- the passes' plain versions
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_message_rows_plain_equals_the_plain_message_at_its_rows(split_batch, dtype):
    b = split_batch
    H = _rand((b.E.shape[0], D), 3, TORCH_DTYPES[dtype])
    want = message_plain(H, *_graph(b))
    out = want.clone()
    out[b.cross_rows.long()] = float("nan")
    got = message_rows_plain(H, *_graph(b), b.cross_rows, out)
    assert got is out and torch.equal(got, want)


@pytest.mark.parametrize("acc", [False, True], ids=["no_acc", "acc"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_message_rows_plain_equals_the_plain_form_at_its_rows(split_batch, dtype, masked,
                                                                  acc):
    """F's pass forms G from g and y alone: with ``gz_acc`` the full form's G
    is still the unaccumulated one's, and the pass gives it."""
    b, dt = split_batch, TORCH_DTYPES[dtype]
    n = b.E.shape[0]
    g, y = _rand((n, D), 4, dt), _rand((n, D), 5, dt, relu=True) if masked else None
    want, _ = bwd_message_plain(g, y, *_graph(b), gz_acc=_rand((n, D), 6, dt) if acc else None)
    G = want.clone()
    G[b.cross_rows.long()] = float("nan")
    got = bwd_message_rows_plain(g, y, *_graph(b), b.cross_rows, G)
    assert got is G and torch.equal(got, want)


# ------------------------------------------------------------ the cross rows
def test_the_cross_rows_hold_every_row_as_tile_kernel_cannot_form(split_batch):
    """By brute force over the split table: a row of A needs its reverse and
    the in-edges of its source, all in its own tile, or the tile kernel flags
    it. Those rows are exactly the rows whose reverse lies in another tile,
    and every one of them is in ``cross_rows`` (which F's node-wide rule
    makes larger)."""
    b = split_batch
    tiles = b.split_ptr.numpy().astype(np.int64)
    src, rev, ptr = (t.numpy().astype(np.int64) for t in (b.src, b.rev, b.edge_ptr))
    n_real = int(b.edge_mask.sum())
    tile_of = np.searchsorted(tiles, np.arange(b.E.shape[0]), "right")
    need = [e for e in range(n_real)
            if tile_of[rev[e]] != tile_of[e]
            or any(tile_of[k] != tile_of[e] for k in range(ptr[src[e]], ptr[src[e] + 1]))]
    assert need == [e for e in range(n_real) if tile_of[rev[e]] != tile_of[e]]
    cross = set(b.cross_rows.tolist())
    assert need and set(need) <= cross and len(cross) > len(need)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_the_passes_bytes_count_what_they_move(split_batch, itemsize):
    """The bytes of the passes' bounds (``chip_smoke.message_rows_bytes``,
    ``bwd_message_rows_bytes``), by brute force: A's pass reads each H row
    of the listed rows' sources' in-edges once; F's reads g and y at the
    reverses of the listed rows' nodes' in-edges once; both write the listed
    rows and read their ids."""
    b = split_batch
    src, dst, rev, ptr = (t.numpy().astype(np.int64) for t in (b.src, b.dst, b.rev, b.edge_ptr))
    rows = b.cross_rows.numpy()
    a_reads = {k for e in rows for k in range(ptr[src[e]], ptr[src[e] + 1])}
    f_reads = {rev[j] for e in rows for j in range(ptr[dst[e]], ptr[dst[e] + 1])}
    n = len(rows)
    assert chip_smoke.message_rows_bytes(b, D, itemsize) == (len(a_reads) + n) * D * itemsize \
        + 20 * n
    assert chip_smoke.bwd_message_rows_bytes(b, D, itemsize) == \
        (2 * len(f_reads) + n) * D * itemsize + 16 * n + 4 * len(f_reads)
    assert chip_smoke.pass_adds(b, "message_rows") == sum(ptr[src[e] + 1] - ptr[src[e]] + 1
                                                          for e in rows)
    assert set(chip_smoke.SPLIT_PASSES) <= set(chip_smoke.PLAIN_VERSIONS["message"].values())


# ----------------------------------------------------------------- refusals
def _a_and_f(b, tiles, cross, dtype=torch.float32):
    H = _rand((b.E.shape[0], D), 7, dtype)
    return (lambda: message(H, *_graph(b), tiles, cross),
            lambda: bwd_message(H, H, *_graph(b), tiles=tiles, cross=cross))


def test_a_and_f_refuse_cross_rows_without_a_table(split_batch):
    for call in _a_and_f(split_batch, None, split_batch.cross_rows):
        with pytest.raises(ValueError, match="split tile table"):
            call()


@pytest.mark.parametrize("case", ["int64", "two_dimensional", "past_the_end", "negative",
                                  "descending", "meta"])
def test_a_and_f_refuse_malformed_cross_rows(split_batch, case):
    c, n = split_batch.cross_rows, split_batch.E.shape[0]
    bad = {"int64": c.long(), "two_dimensional": c[None], "past_the_end": c + n,
           "negative": c - int(c[-1]) - 1, "descending": c.flip(0), "meta": c.to("meta")}[case]
    for call in _a_and_f(split_batch, split_batch.split_ptr, bad):
        with pytest.raises(ValueError, match="cross"):
            call()


@pytest.mark.parametrize("route", ["first_iter", "message_iter", "depth_loop", "loop_readout",
                                   "message_passing"])
def test_a_split_table_without_its_cross_rows_raises(split_batch, route):
    b = split_batch
    graph, n = _graph(b), b.E.shape[0]
    x, w = _rand((n, D), 8), _rand((D, D), 9)
    split = (b.split_ptr, None)
    calls = {
        "first_iter": lambda: first_iter(x, w, None, *graph, None, None, split),
        "message_iter": lambda: message_iter(x, x, w, None, *graph, None, None, split),
        "depth_loop": lambda: depth_loop(x, w, None, *graph, 3, None, None, split),
        "loop_readout": lambda: loop_readout(x, w, None, *graph, 3, None, None, split),
        "message_passing": lambda: BondMessagePassing(d_v=b.V.shape[1], d_e=b.E.shape[1],
                                                      d_h=D_H)(type(b)(**{**b.__dict__,
                                                                          "cross_rows": None})),
    }
    with pytest.raises(ValueError, match="cross rows"):
        calls[route]()


def test_the_cross_rows_move_checked(split_batch):
    moved = split_batch.to("cpu")
    assert moved.cross_rows.checked_for_rows == split_batch.E.shape[0]
    bad = split_batch.cross_rows.flip(0)
    with pytest.raises(ValueError, match="cross"):
        type(split_batch)(**{**split_batch.__dict__, "cross_rows": bad}).to("cpu")


# ------------------------------------------------------- against the JAX package
@pytest.fixture(scope="module")
def five(tox21):
    """Five molecules, Tox21's 264-edge one among them, batched by both
    packages to the same padded shapes: the JAX batch at window width 3, the
    port's with a split table."""
    smis = SMALL[:2] + [tox21[0][LARGEST]] + SMALL[2:]
    jfeat, feat = JaxFeaturizer(), SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(make_mol(s)) for s in smis]
    assert max(mg.E.shape[0] for mg in mgs) == 264
    pad = PadSpec.for_graphs(mgs)
    pad = pad._replace(n_nodes=max(pad.n_nodes, 256))  # the JAX kernel's node window
    jb = jax_batch([jfeat(jdata.MoleculeDatapoint.from_smi(s).mol) for s in smis],
                   JaxPadSpec(*pad), sort_edges=True)
    assert jb.fused_ok and jb.fused_window == 3
    tb = batch_mol_graphs(mgs, pad)
    assert tb.tile_ptr is None and tb.cross_rows.numel() > 0
    return smis, jb, tb


def _close(got, want, real):
    """The f32 tolerance against the JAX package (ROADMAP §3), real rows only."""
    np.testing.assert_allclose(got.float().numpy()[real], np.asarray(want, np.float32)[real],
                               rtol=1e-4, atol=1e-6)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")


def _both(n, seed, relu=False):
    """The same float32 table for both packages, of bf16-representable
    values: the JAX f32 kernel splits each value into bf16 hi and lo parts,
    and on such values the lo part is zero, so both sides sum the same f32
    values and differ only in their order."""
    x = _rand((n, D), seed, relu=relu).to(torch.bfloat16).float()
    return jnp.asarray(x.numpy()), x


def test_a_matches_the_jax_kernel_at_window_3(five, interpret):
    _, jb, tb = five
    Hj, Ht = _both(tb.E.shape[0], 10)
    want = _fused_message_impl(Hj, jb.src, jb.dst, jb.rev, 3)
    UNSERVED.clear()
    got = message(Ht, *_graph(tb), tb.split_ptr, tb.cross_rows)
    assert UNSERVED["message"] == 0
    _close(got, want, tb.edge_mask.numpy())


@pytest.mark.parametrize("acc", [False, True], ids=["no_acc", "acc"])
def test_f_matches_the_jax_kernel_at_window_3(five, interpret, acc):
    _, jb, tb = five
    n = tb.E.shape[0]
    (gj, gt), (yj, yt) = _both(n, 11), _both(n, 12, relu=True)
    aj, at = _both(n, 13) if acc else (None, None)
    want_G, want_gz = _bwd_msg_impl(gj, yj, jb.src, jb.dst, jb.rev, 3, gz_acc=aj)
    UNSERVED.clear()
    G, gz = bwd_message(gt, yt, *_graph(tb), gz_acc=at, tiles=tb.split_ptr, cross=tb.cross_rows)
    assert UNSERVED["bwd_message"] == 0
    real = tb.edge_mask.numpy()
    _close(G, want_G, real)
    _close(gz, want_gz, real)


def test_the_message_backward_matches_the_jax_vjp_at_window_3(five, interpret):
    """A's backward is F without its mask over the same split table: the
    JAX message's VJP, its kernel with the roles of src and dst swapped."""
    _, jb, tb = five
    n = tb.E.shape[0]
    (Hj, Ht), (cj, ct) = _both(n, 14), _both(n, 15)
    _, vjp = jax.vjp(lambda h: fused_message(h, jb.src, jb.dst, jb.rev, jb.V.shape[0], 3), Hj)
    (want,) = vjp(cj)
    UNSERVED.clear()
    x = Ht.clone().requires_grad_()
    (got,) = torch.autograd.grad(message(x, *_graph(tb), tb.split_ptr, tb.cross_rows), x, ct)
    assert UNSERVED["bwd_message"] == 0
    _close(got, want, tb.edge_mask.numpy())


def test_a_small_model_matches_jax(five):
    """The f32 model at hidden width 64 (padded to 128), depth 3, on the five
    molecules: predictions and every parameter's gradient against the JAX
    package's plain CPU path, the port's A and F over the split table."""
    smis, _, _ = five
    rng = np.random.default_rng(16)
    ys = rng.standard_normal(len(smis))
    jds = jdata.MoleculeDataset([jdata.MoleculeDatapoint.from_smi(s, y=np.array([y]))
                                 for s, y in zip(smis, ys)])
    tds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=np.array([y]))
                           for s, y in zip(smis, ys)])
    jb = next(iter(jdata.DataLoader(jds, batch_size=len(smis), shuffle=False, prefetch=0)))
    tb = next(iter(DataLoader(tds, batch_size=len(smis), shuffle=False)))
    assert tb.bmg.tile_ptr is None and tb.bmg.split_ptr is not None
    jmodel = JaxMPNN(message_passing=JaxBondMP(d_h=D_H), agg=JaxMean(),
                     predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H))
    model = MPNN(BondMessagePassing(d_h=D_H), MeanAggregation(),
                 RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False))
    params = jmodel.init(jax.random.PRNGKey(3), jb.bmg, None, None)["params"]
    model.load_state_dict(from_jax_params(params))
    c = rng.standard_normal((len(smis), 1)).astype(np.float32)

    def jloss(p):
        out = jmodel.apply({"params": p}, jb.bmg, None, None, is_training=False)
        return (out[: len(smis)] * c).sum(), out

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    UNSERVED.clear()
    got = model(tb.bmg)
    grads = torch.autograd.grad((got[: len(smis)] * torch.from_numpy(c)).sum(),
                                [p for _, p in model.named_parameters()])
    assert not UNSERVED
    np.testing.assert_allclose(got.detach().numpy()[: len(smis)],
                               np.asarray(want)[: len(smis)], rtol=1e-4, atol=1e-6)
    want_grads = from_jax_params(jgrads)
    for (name, _), g in zip(model.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
