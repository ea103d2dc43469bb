"""Kernels D (``fused_iter2``) and E (``iter_bwd``) over a split tile table,
and exported programs over it, on the CPU.

A batch that holds a molecule of more than 128 directed edges has no tile
table. Its ``split_ptr`` cuts such molecules at their nodes' boundaries;
``cross_rows`` lists the rows whose transposed message reads another tile,
and ``y1_rows`` and ``y2_rows`` the rows the chained iterations cannot form
in their tile, in the first iteration and, given those, in the second
(Tox21, ``classification/mol.csv``, has 8 such molecules, the largest of 264
edges). On a CUDA tensor D launches over that table and then B's row pass
over each list (``fused_iter_rows`` of ``csrc/fused_iter.cu``), and E forms
the cross rows' G first (``iter_bwd_rows`` of ``csrc/message_bwd.cu``) and
takes it into its tile launch; on a CPU tensor the wrappers take the full
plain version and then the passes' plain versions. These
tests hold the lists to their definitions by brute force, D and E over the
split table to their plain versions, every route to a rehearsal's launches
with nothing unserved, D and E to the JAX package's Pallas kernels at window
width 3 in interpret mode, an exported program on a split batch to the eager
forward, and check the refusals. test_torch_cuda.py runs the kernels on the
card (``-k split``)."""

from __future__ import annotations

import csv
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chemprop_tpu import data as jdata
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import (
    SimpleMoleculeMolGraphFeaturizer as JaxFeaturizer,
)
from chemprop_tpu.ops import fused_message as fm
from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.data import MoleculeDatapoint
from chemprop_tpu_torch.data.collate import PadSpec, TrainingBatch, batch_mol_graphs
from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.models import MPNN
from chemprop_tpu_torch.models.export import export_forward, program_inputs
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.ops import (
    UNSERVED,
    KernelOptions,
    fused_iter2,
    iter_bwd,
    loop_readout,
    message,
    message_iter,
)
from chemprop_tpu_torch.ops.message import (
    bwd_message_plain,
    fused_iter_plain,
    fused_iter_rows_plain,
    iter_bwd_plain,
    iter_bwd_rows_plain,
)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the rehearsal that counts the card's launches)

DATA = Path(__file__).resolve().parent / "data"
D = 128
D_H = 64
BF16_ULP = 2.0**-7
LARGEST = 304  # Tox21's 264-edge molecule
SMALL = ["CCO", "c1ccccc1", "CC(=O)Nc1ccc(O)cc1", "[Na+].CC(=O)[O-]"]


@pytest.fixture(scope="module")
def tox21():
    """Tox21's SMILES and its 500 molecules in one batch, collated once."""
    with open(DATA / "classification" / "mol.csv", newline="") as f:
        smis = [row[0] for row in list(csv.reader(f))[1:]]
    feat = SimpleMoleculeMolGraphFeaturizer()
    b = batch_mol_graphs([feat(make_mol(s)) for s in smis])
    assert b.tile_ptr is None and b.split_ptr is not None
    return smis, b


@pytest.fixture(scope="module")
def chain():
    """A batch with a chain of 70 carbons among small molecules."""
    feat = SimpleMoleculeMolGraphFeaturizer()
    b = batch_mol_graphs([feat(make_mol(s)) for s in SMALL[:3] + ["C" * 70] + SMALL[3:]])
    assert b.tile_ptr is None and b.split_ptr is not None
    return b


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(request, tox21, chain):
    return tox21[1] if request == "tox21" else chain


def _graph(b):
    return b.src, b.dst, b.rev, b.edge_ptr


def _rand(shape, seed, dtype=torch.bfloat16, scale=1.0, relu=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(np.maximum(x, 0) if relu else x).to(dtype)


def _rows(b):
    return b.y1_rows, b.y2_rows


def _split(b):
    return b.split_ptr, b.cross_rows, b.y1_rows, b.y2_rows


def _rehearsed(run):
    """``run()`` under a rehearsal: the launches the same run makes on the
    card, and the calls it leaves without a table."""
    UNSERVED.clear()
    with chip_smoke.rehearsal() as counts:
        run()
    return dict(counts), {k: v for k, v in UNSERVED.items() if v}


# ------------------------------------------------------------- the lists
def _tile_of(b):
    return np.searchsorted(b.split_ptr.numpy(), np.arange(b.E.shape[0]), "right") - 1


@pytest.mark.parametrize("which", ["tox21", "chain"])
def test_d_lists_follow_their_definitions(tox21, chain, which):
    """By brute force over the split table: iteration 1 cannot form a row
    whose source's in-edges (its reverse among them) leave its tile;
    iteration 2 cannot form those rows, nor any row whose message reads one
    of them. The first list lies within the cross rows, the second does not."""
    b = _batch(which, tox21, chain)
    src, rev, ptr = (t.numpy().astype(np.int64) for t in (b.src, b.rev, b.edge_ptr))
    tile_of, n_real = _tile_of(b), int(b.edge_mask.sum())
    reads = {e: [rev[e], *range(ptr[src[e]], ptr[src[e] + 1])] for e in range(n_real)}
    first = [e for e in range(n_real) if any(tile_of[k] != tile_of[e] for k in reads[e])]
    second = [e for e in range(n_real)
              if e in set(first) or any(k in set(first) for k in reads[e])]
    assert b.y1_rows.tolist() == first and b.y2_rows.tolist() == second
    cross = set(b.cross_rows.tolist())
    assert first and set(first) <= cross and not set(second) <= cross
    if which == "tox21":  # the counts the design was made for
        assert (len(first), len(second), len(set(second) - cross)) == (102, 260, 124)


@pytest.mark.parametrize("which", ["tox21", "chain"])
def test_e_leaves_out_exactly_the_cross_rows(tox21, chain, which):
    """E's tile kernel cannot form the rows of a node one of whose in-edges
    has its reverse outside the node's tile (``csrc/iter_bwd.cu``'s IB_BAD
    rule): those rows are exactly ``cross_rows``."""
    b = _batch(which, tox21, chain)
    dst, rev, ptr = (t.numpy().astype(np.int64) for t in (b.dst, b.rev, b.edge_ptr))
    tile_of, n_real = _tile_of(b), int(b.edge_mask.sum())
    bad = []
    for v in range(int(dst[:n_real].max()) + 1):
        ins = range(ptr[v], ptr[v + 1])
        if ins and any(tile_of[k] != tile_of[ins[0]] or tile_of[rev[k]] != tile_of[ins[0]]
                       for k in ins):
            bad += list(ins)
    assert bad == b.cross_rows.tolist()


# ----------------------------------------------- D and E against plain ones
@pytest.mark.parametrize("bias", [False, True])
def test_d_over_the_split_table_equals_two_plain_iterations(tox21, bias):
    """D over the split table with its lists (on the CPU the full plain
    version, then the row pass's plain version over each list): two plain
    iterations bit for bit; the pass alone forms its rows and nothing else."""
    b = tox21[1]
    graph, n = _graph(b), b.E.shape[0]
    H0, W = _rand((n, D), 1), _rand((D, D), 2, scale=D**-0.5)
    bb = _rand((D,), 3, scale=0.1) if bias else None
    w1 = fused_iter_plain(H0, H0, W, bb, *graph, relu_stream=True)
    w2 = fused_iter_plain(w1, H0, W, bb, *graph)
    got = []
    counts, unserved = _rehearsed(
        lambda: got.extend(fused_iter2(H0, W, bb, *graph, b.split_ptr, _rows(b))))
    assert counts == {"fused_iter2": 1, "fused_iter_rows": 2} and not unserved
    assert torch.equal(got[0], w1) and torch.equal(got[1], w2)
    out = torch.full_like(H0, float("nan"))
    fused_iter_rows_plain(w1, H0, W, bb, *graph, b.y2_rows, out)
    listed = torch.zeros(n, dtype=torch.bool)
    listed[b.y2_rows.long()] = True
    assert torch.equal(out[listed], w2[listed]) and out[~listed].isnan().all()


def test_e_over_the_split_table_matches_the_plain_version(tox21):
    """E over the split table with its cross rows: the plain version's bits,
    with the launch that forms the cross rows' G first counted. That
    launch's plain version gives G_c: the plain G at the cross rows, in the
    list's order, bit for bit; a G whose cross rows come from G_c, as the
    tile launch takes them in, gives the whole dW."""
    b = tox21[1]
    graph, n = _graph(b), b.E.shape[0]
    g, y, H = _rand((n, D), 4), _rand((n, D), 5, relu=True), _rand((n, D), 6, relu=True)
    W = _rand((D, D), 7, scale=D**-0.5)
    got = []
    counts, unserved = _rehearsed(
        lambda: got.extend(iter_bwd(g, y, H, W, *graph, tiles=b.split_ptr, cross=b.cross_rows)))
    assert counts == {"iter_bwd": 1, "iter_bwd_rows": 1} and not unserved
    want = iter_bwd_plain(g, y, H, W, *graph)
    assert all(torch.equal(x, w) for x, w in zip(got, want))
    Gc = iter_bwd_rows_plain(g, y, *graph, b.cross_rows)
    rows = b.cross_rows.long()
    G = bwd_message_plain(g, y, *graph)[0]  # rounded once, as E rounds it
    assert Gc.shape == (rows.numel(), D) and Gc.dtype == torch.bfloat16
    assert torch.equal(Gc, G[rows])
    taken = torch.full_like(G, float("nan"))
    others = torch.ones(n, dtype=torch.bool)
    others[rows] = False
    taken[others], taken[rows] = G[others], Gc
    H_real = H.float().masked_fill((b.dst == b.V.shape[0] - 1)[:, None], 0.0)
    torch.testing.assert_close(H_real.t() @ taken.float(), want[2], rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------ every route
CASES = {
    # (options, dropout): the launches of D or E and their passes in a step
    "iter2": (dict(iter2=True), 0.0, {"fused_iter2": 1, "fused_iter_rows": 2}),
    "iter2_dropout": (dict(iter2=True), 0.1, {"fused_iter": 2}),
    "fused_bwd_dropout": (dict(fused_bwd=True), 0.1, {"iter_bwd": 1, "iter_bwd_rows": 1}),
    "fused_bwd": (dict(fused_bwd=True), 0.0, {"fused_iter": 2}),
    "all_dropout": (dict(iter2=True, fused_bwd=True, grad_w=True), 0.1,
                    {"iter_bwd": 1, "iter_bwd_rows": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_route_serves_d_and_e(tox21, case):
    """A bf16 training step at depth 3 on Tox21 with ``iter2`` and
    ``fused_bwd``, with and without dropout: D and E over the split table,
    each followed by its passes, nothing unserved (without dropout the
    whole loop is ``loop_readout``, where D runs; with it the per-iteration
    ops, where E runs)."""
    b = tox21[1]
    opts, rate, want = CASES[case]
    mp = BondMessagePassing(d_v=b.V.shape[1], d_e=b.E.shape[1], d_h=D_H, depth=3,
                            dropout=rate, compute_dtype=torch.bfloat16,
                            kernel_options=KernelOptions(**opts))

    def step():
        out = mp(b, is_training=True, generator=torch.Generator().manual_seed(0))
        torch.autograd.grad(out.float().sum(), list(mp.parameters()))

    counts, unserved = _rehearsed(step)
    assert not unserved
    for kernel, n in want.items():
        assert counts.get(kernel, 0) == n, counts
    for kernel in ("fused_iter2", "iter_bwd"):
        if kernel not in want:
            assert kernel not in counts, counts


def test_routes_hand_d_and_e_the_split_table_and_give_the_plain_bits(chain):
    """``loop_readout`` with ``iter2`` and ``message_iter`` with ``fused_bwd``
    over the 70-carbon chain's split table and lists: the values and
    gradients they give without a table, nothing unserved."""
    b = chain
    graph, n = _graph(b), b.E.shape[0]
    H0 = _rand((n, D), 8).masked_fill(~b.edge_mask[:, None], 0)
    W = _rand((D, D), 9, scale=D**-0.5)

    def run(split, route):
        x, w = H0.clone().requires_grad_(), W.clone().requires_grad_()
        if route == "loop_readout":
            out = loop_readout(x, w, None, *graph, 3, KernelOptions(iter2=True), None, split)
        else:
            out = message_iter(torch.relu(x), x, w, None, *graph,
                               KernelOptions(fused_bwd=True), None, split)
        return (out, *torch.autograd.grad(out.float().sum(), [x, w]))

    for route, kernel in (("loop_readout", "fused_iter_rows"), ("message_iter", "iter_bwd_rows")):
        want = run(None, route)
        got = []
        counts, unserved = _rehearsed(lambda: got.extend(run(_split(b), route)))
        assert not unserved and counts[kernel] >= 1, (route, counts)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), route


def test_a_multicomponent_step_hands_each_block_its_lists():
    """A bf16 mol+mol step with ``iter2`` and ``fused_bwd`` and no dropout,
    then with dropout: the dyes' block takes its split table with D's lists
    and its cross rows, the solvents' its tile table, nothing unserved."""
    from chemprop_tpu_torch.data import DataLoader, MoleculeDataset
    from chemprop_tpu_torch.data.datasets import MulticomponentDataset
    from chemprop_tpu_torch.models import MulticomponentMPNN
    from chemprop_tpu_torch.nn.message_passing import MulticomponentMessagePassing

    with open(DATA / "regression" / "mol+mol" / "mol+mol.csv", newline="") as f:
        rows = list(csv.reader(f))[1:]
    dsets = [MoleculeDataset([MoleculeDatapoint.from_smi(r[c], y=np.array([float(r[2])]))
                              for r in rows[:60]]) for c in (0, 1)]
    batch = next(bt for bt in DataLoader(MulticomponentDataset(dsets), batch_size=30)
                 if bt.bmg[0].split_ptr is not None)
    assert batch.bmg[1].tile_ptr is not None
    for rate, want in ((0.0, {"fused_iter2": 2, "fused_iter_rows": 2}),
                       (0.1, {"iter_bwd": 2, "iter_bwd_rows": 1})):
        blocks = [BondMessagePassing(d_v=g.V.shape[1], d_e=g.E.shape[1], d_h=D_H, dropout=rate,
                                     compute_dtype=torch.bfloat16,
                                     kernel_options=KernelOptions(iter2=True, fused_bwd=True))
                  for g in batch.bmg]
        model = MulticomponentMPNN(MulticomponentMessagePassing(blocks, 2, False),
                                   MeanAggregation(), RegressionFFN(input_dim=2 * D_H,
                                                                    hidden_dim=D_H))

        def step():
            out = model(batch.bmg, None, None, is_training=True,
                        generator=torch.Generator().manual_seed(1))
            torch.autograd.grad(out.float().sum(), list(model.parameters()))

        counts, unserved = _rehearsed(step)
        assert not unserved, unserved
        assert {k: counts.get(k, 0) for k in want} == want, counts


# --------------------------------------------------- against the JAX package
@pytest.fixture(scope="module")
def five(tox21):
    """Five molecules, Tox21's 264-edge one among them, batched by both
    packages to the same padded shapes: the JAX batch at window width 3, the
    port's with a split table and its lists."""
    smis = SMALL[:2] + [tox21[0][LARGEST]] + SMALL[2:]
    jfeat, feat = JaxFeaturizer(), SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(make_mol(s)) for s in smis]
    assert max(mg.E.shape[0] for mg in mgs) == 264
    # the JAX kernels' node window, and the seven 128-row chunks that their
    # window of 3 needs (fm._usable)
    pad = PadSpec.for_graphs(mgs)
    pad = pad._replace(n_nodes=max(pad.n_nodes, 256), n_edges=max(pad.n_edges, 1024))
    jb = jax_batch([jfeat(jdata.MoleculeDatapoint.from_smi(s).mol) for s in smis],
                   JaxPadSpec(*pad), sort_edges=True)
    assert jb.fused_ok and jb.fused_window == 3
    tb = batch_mol_graphs(mgs, pad)
    assert tb.tile_ptr is None and tb.y1_rows.numel() > 0
    return jb, tb


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")
    monkeypatch.setattr(fm, "ITER2", True)  # CHEMPROP_TPU_ITER2=1, read at import


def _both(x):
    import jax.numpy as jnp

    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), x


def test_d_matches_the_jax_kernel_at_window_3(five, interpret):
    """D over the split table against JAX's ``_iter2_impl`` at ``kw = 3`` in
    interpret mode, real rows only: y1 within two bf16 ulps and 0.05, y2
    within two ulps and 0.1 (y1's ulp passes through the second message and
    W), fewer than 2% of the values apart by more than one ulp."""
    jb, tb = five
    n = tb.E.shape[0]
    (H0j, H0t), (Wj, Wt) = _both(_rand((n, D), 10)), _both(_rand((D, D), 11, scale=D**-0.5))
    assert fm.iter2_usable(H0j, Wj, 3)
    j1, j2 = fm._iter2_impl(H0j, Wj, None, jb.src, jb.dst, jb.rev, 3)
    UNSERVED.clear()
    y1, y2 = fused_iter2(H0t, Wt, None, *_graph(tb), tb.split_ptr, _rows(tb))
    assert not UNSERVED["fused_iter2"]
    real = tb.edge_mask.numpy()
    for got, want, atol in ((y1, j1, 0.05), (y2, j2, 0.1)):
        got, want = got.float().numpy()[real], np.asarray(want, np.float32)[real]
        np.testing.assert_allclose(got, want, rtol=2 * BF16_ULP, atol=atol)
        assert np.mean(np.abs(got - want) > BF16_ULP * np.abs(want) + 1e-6) < 0.02


def test_e_matches_the_jax_kernel_at_window_3(five, interpret):
    """E over the split table against JAX's ``_iter_bwd_impl`` at ``kw = 3``
    in interpret mode, real rows only: gz equal, dH within two bf16 ulps and
    0.05, dW within 1e-2 and 2e-3 of its largest value."""
    jb, tb = five
    n, real = tb.E.shape[0], tb.edge_mask.numpy()
    g = _rand((n, D), 12).masked_fill(~tb.edge_mask[:, None], 0)
    H = _rand((n, D), 14, relu=True).masked_fill(~tb.edge_mask[:, None], 0)
    (gj, gt), (yj, yt) = _both(g), _both(_rand((n, D), 13, relu=True))
    (Hj, Ht), (Wj, Wt) = _both(H), _both(_rand((D, D), 15, scale=D**-0.5))
    assert fm.iter_usable(Hj, Wj, 3)
    want_dH, want_gz, want_dW = fm._iter_bwd_impl(gj, yj, Hj, Wj, jb.src, jb.dst, jb.rev, 3)
    dH, gz, dW = iter_bwd(gt, yt, Ht, Wt, *_graph(tb), tiles=tb.split_ptr, cross=tb.cross_rows)
    np.testing.assert_array_equal(gz.float().numpy()[real], np.asarray(want_gz, np.float32)[real])
    np.testing.assert_allclose(dH.float().numpy()[real], np.asarray(want_dH, np.float32)[real],
                               rtol=2 * BF16_ULP, atol=0.05)
    want_dW = np.asarray(want_dW, np.float32)
    np.testing.assert_allclose(dW.numpy(), want_dW, rtol=1e-2, atol=2e-3 * np.abs(want_dW).max())


def test_e_cross_rows_g_matches_the_jax_kernel_at_window_3(five, interpret):
    """G at the cross rows, as the launch before E's tile launch forms it
    (``iter_bwd_rows_plain``'s G_c), against G from JAX's ``_bwd_msg_impl``
    at ``kw = 3`` in interpret mode at those rows, with bf16-representable
    inputs, real rows only: within one bf16 ulp of JAX's value (rtol 2^-7,
    no atol: both sum in f32 and round once)."""
    jb, tb = five
    n = tb.E.shape[0]
    g = _rand((n, D), 18).masked_fill(~tb.edge_mask[:, None], 0)
    (gj, gt), (yj, yt) = _both(g), _both(_rand((n, D), 19, relu=True))
    want_G, _ = fm._bwd_msg_impl(gj, yj, jb.src, jb.dst, jb.rev, 3)
    Gc = iter_bwd_rows_plain(gt, yt, *_graph(tb), tb.cross_rows)
    rows = tb.cross_rows.numpy()
    assert rows.size and tb.edge_mask.numpy()[rows].all() and Gc.shape == (rows.size, D)
    np.testing.assert_allclose(Gc.float().numpy(), np.asarray(want_G, np.float32)[rows],
                               rtol=BF16_ULP, atol=0)


# ------------------------------------------------------------------- export
@pytest.mark.parametrize("dtype", ["float32", "bfloat16_iter2"])
def test_an_exported_program_serves_the_split_batch(five, dtype):
    """A program exported from the split batch: on it, and on a batch with a
    tile table, the eager forward's bits, its passes launched as the eager
    forward launches them (a rehearsal), nothing unserved."""
    _, tb = five
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    torch.manual_seed(5)
    model = MPNN(BondMessagePassing(d_v=tb.V.shape[1], d_e=tb.E.shape[1], d_h=D_H,
                                    compute_dtype=dt,
                                    kernel_options=KernelOptions(iter2=dt == torch.bfloat16)),
                 MeanAggregation(), RegressionFFN(input_dim=D_H, hidden_dim=D_H)).eval()
    batch = TrainingBatch(tb, None, None, None, torch.ones(tb.n_graphs), None, None)
    exported = export_forward(model, batch)
    feat = SimpleMoleculeMolGraphFeaturizer()
    tiled = batch_mol_graphs([feat(make_mol(s)) for s in SMALL + ["CCN"]],
                             PadSpec(128, 256, tb.n_graphs))
    assert tiled.tile_ptr is not None
    passes = {"float32": {"message_rows": 2}, "bfloat16_iter2": {"fused_iter_rows": 2}}[dtype]
    for b, want_passes in ((tb, passes), (tiled, {})):
        with torch.no_grad():
            want_counts, _ = _rehearsed(lambda: model(b))
            want = model(b)
        got = []
        counts, unserved = _rehearsed(lambda: got.append(exported(b)))
        assert not unserved and counts == want_counts, (counts, want_counts)
        assert {k: counts.get(k, 0) for k in passes} == {k: want_passes.get(k, 0)
                                                          for k in passes}
        assert torch.equal(got[0], want)


# ----------------------------------------------------------------- refusals
def test_a_split_table_without_its_lists_is_refused(tox21):
    """A, D and E raise before anything runs where a split table comes
    without its row lists (the collate marks the table split), and so do the
    routes with ``iter2`` where D's lists are missing, and an exported
    program's entry."""
    b = tox21[1]
    graph, n = _graph(b), b.E.shape[0]
    x, W = _rand((n, D), 16), _rand((D, D), 17, scale=D**-0.5)
    calls = [lambda: message(x, *graph, b.split_ptr),
             lambda: fused_iter2(x, W, None, *graph, b.split_ptr),
             lambda: iter_bwd(x, x, x, W, *graph, tiles=b.split_ptr),
             lambda: fused_iter2(x, W, None, *graph, b.split_ptr.to("cpu"), (b.y1_rows, None))]
    for call in calls:
        with pytest.raises(ValueError, match="split tile table"):
            _rehearsed(call)
    with pytest.raises(ValueError, match="D's row lists"):
        loop_readout(x, W, None, *graph, 3, KernelOptions(iter2=True), None,
                     (b.split_ptr, b.cross_rows))
    bare = type(b)(**{**b.__dict__, "y2_rows": None})
    with pytest.raises(ValueError, match="row lists"):
        program_inputs(bare)


def test_the_lists_move_checked(tox21):
    """``BatchMolGraph.to`` checks D's lists as it checks the cross rows and
    marks the tables; a malformed list raises there."""
    b = tox21[1]
    moved = b.to("cpu")
    assert moved.y1_rows.checked_for_rows == moved.y2_rows.checked_for_rows == b.E.shape[0]
    assert moved.split_ptr.split_table is True
    bad = b.y2_rows.flip(0)
    with pytest.raises(ValueError, match="cross"):
        type(b)(**{**b.__dict__, "y2_rows": bad}).to("cpu")
