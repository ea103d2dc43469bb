"""The port's per-iteration ops and its three opt-in kernels' plain versions
(``fused_iter2``, ``iter_bwd``, ``grad_weight``, ``first_iter``,
``message_iter``, ``loop_readout`` with ``iter2``) against the JAX package's
functions, on the same inputs made with numpy from a seed.

On the CPU each wrapper takes its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode (CHEMPROP_TPU_INTERPRET=1). Only real
rows are compared: the JAX kernels leave garbage on padding-edge rows, the
port zeros. test_torch_cuda.py holds each CUDA kernel against its plain
version on the card."""

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
from chemprop_tpu.ops import fused_message as fm
from chemprop_tpu.ops import grad_weight as jax_gw
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs, iter2_tiles
from chemprop_tpu_torch.ops import (
    LAUNCHES,
    UNSERVED,
    KernelOptions,
    first_iter,
    fused_iter,
    fused_iter2,
    grad_weight,
    iter_bwd,
    loop_readout,
    message_iter,
)
from chemprop_tpu_torch.ops.grad_weight import grad_weight_plain, matmul
from chemprop_tpu_torch.ops.message import ITER2_TILE_ROWS

SMIS = [
    "CCO",
    "c1ccccc1",
    "CC(=O)Nc1ccc(O)cc1",
    "CNC(C)Cc1ccccc1",
    "CC(C)CC1=CC=C(C=C1)C(C)C(=O)O",
    "c1ccc2ccccc2c1",
    "CC(=O)OC1=CC=CC=C1C(=O)O",
    "C1CCNCC1",
    "C",  # zero-edge molecule
    "O=[N+]([O-])c1ccc(Cl)cc1",
]
D = 128
BF16_ULP = 2.0**-7  # relative spacing of bfloat16 (8 significant bits)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def batches():
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(MoleculeDatapoint.from_smi(s).mol) for s in SMIS]
    pad = (256, 768, len(SMIS))
    jb = jax_batch(mgs, JaxPadSpec(*pad), sort_edges=True)
    assert jb.fused_ok and jb.readout_ok
    return jb, batch_mol_graphs(mgs, PadSpec(*pad))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The models here are small, and the test workers share the machine's
    cores: more than one intra-op thread only makes them wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")


def _graph(tb):
    return tb.src, tb.dst, tb.rev, tb.edge_ptr


def _rand(shape, seed, scale=1.0, bf16=True):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    if bf16:  # bf16-representable values, handed to both packages
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _both(x, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close_to_scale(got, want, max_share=0.05, mean_share=2e-3):
    """bfloat16 gradients: a saved y one ulp apart flips a ReLU mask where y
    is near zero and moves every value downstream by a few ulps of the
    largest term, so errors are held against the table's scale."""
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= max_share * scale, (err.max(), scale)
    assert err.mean() <= mean_share * scale, (err.mean(), scale)


# ------------------------------------------------------------- D: fused_iter2
@pytest.mark.parametrize("bias", [False, True])
def test_fused_iter2_equals_two_iterations_and_matches_jax(batches, interpret, bias):
    jb, tb = batches
    n = tb.E.shape[0]
    H0j, H0t = _both(_rand((n, D), 1), "bfloat16")
    Wj, Wt = _both(_rand((D, D), 2, scale=D**-0.5), "bfloat16")
    bj, bt = _both(_rand((D,), 3, scale=0.1), "bfloat16") if bias else (None, None)
    y1, y2 = fused_iter2(H0t, Wt, bt, *_graph(tb), tb.tile_ptr)
    w1 = fused_iter(H0t, H0t, Wt, bt, *_graph(tb), relu_stream=True)
    w2 = fused_iter(w1, H0t, Wt, bt, *_graph(tb))
    assert torch.equal(y1, w1) and torch.equal(y2, w2)  # bit for bit, every row
    j1, j2 = fm._iter2_impl(H0j, Wj, bj, jb.src, jb.dst, jb.rev, jb.fused_window)
    real = tb.edge_mask.numpy()
    # y1 as the fused iteration against its JAX kernel: the bf16 message may
    # round one ulp apart, which W carries into y, and y rounds once more; y2
    # carries y1's ulp through the second message and W as well
    for got, want, atol in ((y1, j1, 0.05), (y2, j2, 0.1)):
        got, want = got.float().numpy()[real], np.asarray(want, np.float32)[real]
        np.testing.assert_allclose(got, want, rtol=2 * BF16_ULP, atol=atol)
        assert np.mean(np.abs(got - want) > BF16_ULP * np.abs(want) + 1e-6) < 0.02


def test_iter2_tiles_hold_whole_molecules(batches):
    _, tb = batches
    tiles = tb.tile_ptr.numpy()
    assert tiles[0] == 0 and tiles[-1] == tb.E.shape[0] and (np.diff(tiles) > 0).all()
    assert np.diff(tiles).max() <= ITER2_TILE_ROWS
    graph_ptr = tb.edge_ptr.numpy()[tb.node_ptr.numpy()[: tb.n_graphs + 1]]
    for lo, hi in zip(graph_ptr[:-1], graph_ptr[1:]):
        if hi > lo:  # first and last row of a molecule lie in one tile
            assert np.searchsorted(tiles, lo, "right") == np.searchsorted(tiles, hi - 1, "right")
    # every edge a row gathers lies in the row's own tile
    tile_of = np.searchsorted(tiles, np.arange(tb.E.shape[0]), "right")
    real = tb.edge_mask.numpy()
    assert (tile_of[tb.rev.numpy()] == tile_of)[real].all()
    src, ptr = tb.src.numpy(), tb.edge_ptr.numpy()
    for e in np.flatnonzero(real):
        assert (tile_of[ptr[src[e]] : ptr[src[e] + 1]] == tile_of[e]).all()


def test_iter2_tiles_refuse_a_molecule_larger_than_a_tile():
    assert iter2_tiles(np.array([0, 40, 40 + ITER2_TILE_ROWS + 1]), 512) is None
    tiles = iter2_tiles(np.array([0, 40, 40 + ITER2_TILE_ROWS]), 512)
    assert tiles.tolist() == [0, 40, 168, 296, 424, 512]
    # a batch of padding alone, and one with no padding row
    assert iter2_tiles(np.array([0, 0]), 256).tolist() == [0, 128, 256]
    assert iter2_tiles(np.array([0, 100]), 100).tolist() == [0, 100]


def _jax_loop_readout(jb, H0, W, depth):
    return fm.fused_loop_readout(
        H0, W, None, jb.src, jb.dst, jb.rev, jb.V.shape[0], jb.fused_window, depth,
        jb.readout_ok, jb.edge_band,
    )


@pytest.mark.parametrize("depth", [3, 4])
def test_loop_readout_iter2_matches_jax_iter2(batches, interpret, monkeypatch, depth):
    jb, tb = batches
    n = tb.E.shape[0]
    H0 = _rand((n, D), 4)
    H0[~tb.edge_mask.numpy()] = 0
    H0j, H0t = _both(H0, "bfloat16")
    Wj, Wt = _both(_rand((D, D), 5, scale=D**-0.5), "bfloat16")
    c = _rand((tb.V.shape[0], D), 6)
    c[-1] = 0
    monkeypatch.setattr(fm, "ITER2", True)
    assert fm.iter2_usable(H0j, Wj, jb.fused_window)
    want = np.asarray(_jax_loop_readout(jb, H0j, Wj, depth), np.float32)
    want_dH0, want_dW = jax.grad(
        lambda H0, W: (_jax_loop_readout(jb, H0, W, depth).astype(jnp.float32) * c).sum(),
        argnums=(0, 1),
    )(H0j, Wj)

    on = KernelOptions(iter2=True)
    H0t, Wt = H0t.requires_grad_(), Wt.requires_grad_()
    off_out = loop_readout(H0t, Wt, None, *_graph(tb), depth)
    out = loop_readout(H0t, Wt, None, *_graph(tb), depth, on, tb.tile_ptr)
    # inside the port the option changes no bit, forward or backward
    ct = torch.from_numpy(c).to(torch.bfloat16)
    got = torch.autograd.grad(out, [H0t, Wt], ct)
    off = torch.autograd.grad(off_out, [H0t, Wt], ct)
    assert torch.equal(out, off_out) and all(torch.equal(a, b) for a, b in zip(got, off))
    real_nodes = tb.node_mask.numpy()
    # M_v sums a few y rows, each within the fused iteration's tolerance
    np.testing.assert_allclose(
        out.detach().float().numpy()[real_nodes], want[real_nodes], rtol=2 * BF16_ULP, atol=0.25
    )
    real = tb.edge_mask.numpy()
    _close_to_scale(got[0].float().numpy()[real], np.asarray(want_dH0, np.float32)[real])
    _close_to_scale(got[1].float().numpy(), np.asarray(want_dW, np.float32))


def test_loop_readout_iter2_without_tiles_takes_two_iterations(batches):
    _, tb = batches
    H0 = torch.from_numpy(_rand((tb.E.shape[0], D), 7)).to(torch.bfloat16)
    W = torch.from_numpy(_rand((D, D), 8, scale=D**-0.5)).to(torch.bfloat16)
    UNSERVED.clear()
    want = loop_readout(H0, W, None, *_graph(tb), 3)
    got = loop_readout(H0, W, None, *_graph(tb), 3, KernelOptions(iter2=True), None)
    assert torch.equal(got, want) and UNSERVED["fused_iter2"] == 1
    # float32 and depth 2 have no chained form, and count nothing
    loop_readout(H0.float(), W.float(), None, *_graph(tb), 3, KernelOptions(iter2=True), None)
    loop_readout(H0, W, None, *_graph(tb), 2, KernelOptions(iter2=True), None)
    assert UNSERVED["fused_iter2"] == 1


# ---------------------------------------------------------------- E: iter_bwd
def test_iter_bwd_matches_jax_kernel(batches, interpret):
    jb, tb = batches
    n = tb.E.shape[0]
    real = tb.edge_mask.numpy()
    g = _rand((n, D), 10)
    g[~real] = 0  # the cotangent of a padding row is zero in the model
    y = np.maximum(_rand((n, D), 11), 0)
    H = np.maximum(_rand((n, D), 12), 0)
    H[~real] = 0  # the JAX kernel relies on zero rows there
    gj, gt = _both(g, "bfloat16")
    yj, yt = _both(y, "bfloat16")
    Hj, Ht = _both(H, "bfloat16")
    Wj, Wt = _both(_rand((D, D), 13, scale=D**-0.5), "bfloat16")
    want_dH, want_gz, want_dW = fm._iter_bwd_impl(
        gj, yj, Hj, Wj, jb.src, jb.dst, jb.rev, jb.fused_window
    )
    dH, gz, dW = iter_bwd(gt, yt, Ht, Wt, *_graph(tb))
    assert dW.dtype == torch.float32 and dH.dtype == gz.dtype == torch.bfloat16
    # gz is a masked copy
    np.testing.assert_array_equal(gz.float().numpy()[real], np.asarray(want_gz, np.float32)[real])
    # G (a sum of a few gz rows, rounded once) may round one ulp apart; W^T
    # carries that into dH, which rounds once more
    np.testing.assert_allclose(
        dH.float().numpy()[real], np.asarray(want_dH, np.float32)[real],
        rtol=2 * BF16_ULP, atol=0.05,
    )
    # dW sums E products of H with the rounded G in f32
    want_dW = np.asarray(want_dW, np.float32)
    np.testing.assert_allclose(dW.numpy(), want_dW, rtol=1e-2, atol=2e-3 * np.abs(want_dW).max())
    assert not dH[~tb.edge_mask].any() and not gz[~tb.edge_mask].any()  # exact zeros


def test_iter_bwd_ignores_the_padding_rows_of_its_input(batches):
    """Padding rows of ``g`` and ``H`` that are not zero reach nothing."""
    _, tb = batches
    n = tb.E.shape[0]
    pad = ~tb.edge_mask
    t = [torch.from_numpy(_rand((n, D), s)).to(torch.bfloat16) for s in (14, 15, 16)]
    W = torch.from_numpy(_rand((D, D), 17, scale=D**-0.5)).to(torch.bfloat16)
    want = iter_bwd(t[0], t[1], t[2], W, *_graph(tb))
    t[0][pad], t[2][pad] = 3.0, -7.0
    got = iter_bwd(t[0], t[1], t[2], W, *_graph(tb))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------- J: grad_weight
@pytest.mark.parametrize("dx,dg", [(128, 128), (256, 128)])
def test_grad_weight_matches_jax_kernel(interpret, monkeypatch, dx, dg):
    monkeypatch.setenv("CHEMPROP_TPU_GRAD_W", "1")
    n = 1024  # the JAX kernel takes multiples of 512 rows
    Xj, Xt = _both(_rand((n, dx), 20), "bfloat16")
    Gj, Gt = _both(_rand((n, dg), 21), "bfloat16")
    assert jax_gw.grad_weight_usable(Xj, Gj)
    want = np.asarray(jax_gw.grad_weight(Xj, Gj))
    for use_kernel in (True, False):  # the plain version, and the library product
        got = grad_weight(Xt, Gt, use_kernel=use_kernel)
        assert got.dtype == torch.float32 and got.shape == (dx, dg)
        # exact bf16 products summed in f32 in another order
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    assert torch.equal(grad_weight(Xt, Gt, use_kernel=True), grad_weight_plain(Xt, Gt))


def test_grad_weight_kernel_option_takes_what_the_kernel_takes():
    X = torch.zeros((64, 128), dtype=torch.bfloat16)
    assert grad_weight(X.float(), X.float()).dtype == torch.float32  # library: any dtype
    with pytest.raises(TypeError):
        grad_weight(X.float(), X.float(), use_kernel=True)
    with pytest.raises(ValueError):
        grad_weight(X[:, :64].contiguous(), X, use_kernel=True)
    with pytest.raises(ValueError):
        grad_weight(X[:32], X)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_matmul_matches_jax_matmul(interpret, monkeypatch, use_kernel):
    monkeypatch.setenv("CHEMPROP_TPU_GRAD_W", "1" if use_kernel else "0")
    xj, xt = _both(_rand((512, 128), 22), "bfloat16")
    kj, kt = _both(_rand((128, 256), 23, scale=0.1), "bfloat16")
    c = _rand((512, 256), 24)
    want = jax.grad(
        lambda x, k: (jax_gw.matmul(x, k).astype(jnp.float32) * c).sum(), argnums=(0, 1)
    )(xj, kj)
    xt, kt = xt.requires_grad_(), kt.requires_grad_()
    got = torch.autograd.grad(matmul(xt, kt, use_kernel), [xt, kt], torch.from_numpy(c).bfloat16())
    for a, w in zip(got, want):  # f32 sums rounded once to bfloat16
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(w, np.float32), rtol=2 * BF16_ULP, atol=1e-3
        )


# ------------------------------------------- first_iter and message_iter
def _iter_inputs(tb, dtype, bias):
    bf16 = dtype == "bfloat16"
    n = tb.E.shape[0]
    real = tb.edge_mask.numpy()
    H = np.maximum(_rand((n, D), 30, bf16=bf16), 0)
    H0 = _rand((n, D), 31, bf16=bf16)
    H[~real] = 0
    H0[~real] = 0
    W = _rand((D, D), 32, scale=D**-0.5, bf16=bf16)
    b = _rand((D,), 33, scale=0.1, bf16=bf16) if bias else None
    c = _rand((n, D), 34, bf16=bf16)
    c[~real] = 0  # no real row reads a padding row, so none sends it a cotangent
    return H, H0, W, b, c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("fused_bwd", ["0", "1"])
def test_message_iter_gradients_match_jax(batches, interpret, monkeypatch, dtype, bias, fused_bwd):
    monkeypatch.setenv("CHEMPROP_TPU_FUSED_BWD", fused_bwd)
    jb, tb = batches
    H, H0, W, b, c = _iter_inputs(tb, dtype, bias)
    jdt, tdt = DTYPES[dtype]
    n_nodes = jb.V.shape[0]

    def f(H, H0, W, b):
        y = fm.fused_message_iter(H, H0, W, b, jb.src, jb.dst, jb.rev, n_nodes, jb.fused_window)
        return (y.astype(jnp.float32) * c).sum()

    jargs = [jnp.asarray(H, jdt), jnp.asarray(H0, jdt), jnp.asarray(W, jdt)]
    jargs.append(jnp.asarray(b, jdt) if bias else None)
    want = jax.grad(f, argnums=(0, 1, 2, 3) if bias else (0, 1, 2))(*jargs)

    targs = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (H, H0, W)]
    bt = torch.from_numpy(b).to(tdt).requires_grad_() if bias else None
    opts = KernelOptions(fused_bwd=fused_bwd == "1")
    y = message_iter(*targs, bt, *_graph(tb), opts)
    got = torch.autograd.grad(y, targs + ([bt] if bias else []), torch.from_numpy(c).to(tdt))
    real = tb.edge_mask.numpy()
    for name, a, w in zip(("dH", "dH0", "dW", "db"), got, want):
        a, w = a.float().numpy(), np.asarray(w, np.float32)
        assert a.dtype == np.float32 and got[0].dtype == tdt
        if a.shape[0] == tb.E.shape[0]:
            a, w = a[real], w[real]
        if dtype == "float32":
            # the JAX f32 message kernels keep ~16 significant bits (bf16 hi +
            # lo parts); the port sums in full f32
            np.testing.assert_allclose(a, w, rtol=1e-3, atol=1e-4 * np.abs(w).max(), err_msg=name)
        else:
            _close_to_scale(a, w)
    assert not got[0][~tb.edge_mask].any() and not got[1][~tb.edge_mask].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_first_iter_gradients_match_jax(batches, interpret, dtype, bias):
    jb, tb = batches
    _, H0, W, b, c = _iter_inputs(tb, dtype, bias)
    jdt, tdt = DTYPES[dtype]
    n_nodes = jb.V.shape[0]

    def f(H0, W, b):
        y = fm.fused_first_iter(H0, W, b, jb.src, jb.dst, jb.rev, n_nodes, jb.fused_window)
        return (y.astype(jnp.float32) * c).sum()

    jargs = [jnp.asarray(H0, jdt), jnp.asarray(W, jdt), jnp.asarray(b, jdt) if bias else None]
    want = jax.grad(f, argnums=(0, 1, 2) if bias else (0, 1))(*jargs)
    targs = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (H0, W)]
    bt = torch.from_numpy(b).to(tdt).requires_grad_() if bias else None
    y = first_iter(*targs, bt, *_graph(tb))
    # the forward is the fused iteration with the streamed ReLU
    want_y = fm.fused_first_iter(*jargs, jb.src, jb.dst, jb.rev, n_nodes, jb.fused_window)
    real = tb.edge_mask.numpy()
    np.testing.assert_allclose(
        y.detach().float().numpy()[real], np.asarray(want_y, np.float32)[real],
        rtol=2 * BF16_ULP if dtype == "bfloat16" else 1e-4, atol=0.05 if dtype == "bfloat16" else 1e-4,
    )
    got = torch.autograd.grad(y, targs + ([bt] if bias else []), torch.from_numpy(c).to(tdt))
    for name, a, w in zip(("dH0", "dW", "db"), got, want):
        a, w = a.float().numpy(), np.asarray(w, np.float32)
        if a.shape[0] == tb.E.shape[0]:
            a, w = a[real], w[real]
        if dtype == "float32":
            np.testing.assert_allclose(a, w, rtol=1e-3, atol=1e-4 * np.abs(w).max(), err_msg=name)
        else:
            _close_to_scale(a, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "opts", [KernelOptions(fused_bwd=True), KernelOptions(grad_w=True),
             KernelOptions(fused_bwd=True, grad_w=True)],
    ids=["fused_bwd", "grad_w", "fused_bwd+grad_w"],
)
def test_each_option_on_against_off(batches, dtype, opts):
    """Inside the port an option changes the summation order of ``dH`` and
    ``dW`` at most: the forward and the ``H0`` cotangent of the last iteration
    stay bit-equal, the rest stays within the rounding of its dtype."""
    _, tb = batches
    _, H0, W, b, c = _iter_inputs(tb, dtype, True)
    tdt = DTYPES[dtype][1]

    def run(options):
        leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (H0, W, b)]
        y = first_iter(*leaves, *_graph(tb), options)
        y = message_iter(y, *leaves, *_graph(tb), options)
        return y, torch.autograd.grad(y, leaves, torch.from_numpy(c).to(tdt))

    LAUNCHES.clear()
    y_off, off = run(KernelOptions())
    y_on, on = run(opts)
    assert sum(LAUNCHES.values()) == 0  # CPU tensors: the plain versions
    assert torch.equal(y_on, y_off)
    for a, w in zip(on, off):
        if dtype == "float32":  # the options are for bfloat16: nothing changes
            assert torch.equal(a, w)
        else:
            _close_to_scale(a.float().numpy(), w.float().numpy(), 0.02, 5e-4)
