"""The rest of the port's message passing against the JAX package's, on the
CPU (the plain versions of the kernels; JAX's Pallas kernels in interpret
mode for the depth loop op, its plain CPU reference for whole models): the
whole depth loop as one op (``ops.depth_loop`` against
``fused_depth_loop``) and its dispatch, the window-gather route of W_i's
input, activations with arguments, and the activation taps. Small sizes: six
molecules, widths of 128."""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu.data import MoleculeDatapoint
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.nn.utils import get_activation_function as jax_activation
from chemprop_tpu.ops.fused_message import fused_depth_loop
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.models import MPNN, from_jax_params
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.nn.message_passing import base
from chemprop_tpu_torch.nn.utils import get_activation_function
from chemprop_tpu_torch.ops import UNSERVED, KernelOptions, depth_loop

SMIS = ["CCO", "c1ccccc1", "CC(=O)Nc1ccc(O)cc1", "CNC(C)Cc1ccccc1", "C",
        "O=[N+]([O-])c1ccc(Cl)cc1"]
PAD = (128, 512, len(SMIS))
D = 128
D_H = 64
BF16_ULP = 2.0**-7
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def mgs():
    feat = SimpleMoleculeMolGraphFeaturizer()
    return [feat(MoleculeDatapoint.from_smi(s).mol) for s in SMIS]


@pytest.fixture(scope="module")
def batches(mgs):
    return jax_batch(mgs, JaxPadSpec(*PAD), sort_edges=True), batch_mol_graphs(mgs, PadSpec(*PAD))


def _rand(shape, seed, scale=1.0, bf16=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    if bf16:  # bf16-representable values, handed to both packages
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depth_loop_matches_jax(batches, monkeypatch, dtype, bias, depth):
    """The last H and the gradients of H0, W and b from a cotangent of H."""
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")
    jb, tb = batches
    jdt, tdt = DTYPES[dtype]
    bf16 = dtype == "bfloat16"
    real = tb.edge_mask.numpy()
    H0 = _rand((tb.E.shape[0], D), 1, bf16=bf16)
    H0[~real] = 0  # as W_i without a bias leaves the padding rows
    W = _rand((D, D), 2, D**-0.5, bf16)
    b = _rand((D,), 3, 0.1, bf16) if bias else None
    c = _rand((tb.E.shape[0], D), 4, bf16=bf16)
    c[~real] = 0  # only the sacrificial node reads the padding rows

    def f(*args):
        H = fused_depth_loop(*args[:2], args[2] if bias else None, jb.src, jb.dst, jb.rev,
                             jb.V.shape[0], jb.fused_window, depth)
        return (H.astype(jnp.float32) * c).sum(), H

    inputs = (H0, W) + ((b,) if bias else ())
    (_, want_H), want = jax.value_and_grad(f, argnums=tuple(range(len(inputs))), has_aux=True)(
        *(jnp.asarray(x, jdt) for x in inputs))
    xs = [torch.from_numpy(x).to(tdt).requires_grad_() for x in inputs]
    got_H = depth_loop(xs[0], xs[1], xs[2] if bias else None, tb.src, tb.dst, tb.rev,
                       tb.edge_ptr, depth)
    got = torch.autograd.grad(got_H, xs, torch.from_numpy(c).to(tdt))
    assert got_H.dtype == tdt and all(g.dtype == tdt for g in got)
    pairs = [(got_H.detach(), want_H, True)] + [(g, w, i == 0) for i, (g, w) in
                                                 enumerate(zip(got, want))]
    for g, w, by_row in pairs:
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if by_row:  # the edge tables: the real rows; the port's padding rows are zeros
            g, w = g[real], w[real]
        scale = np.abs(w).max()
        if bf16:
            # the same kernels' roundings on both sides: within one bf16 ulp of
            # the table's largest value (equal bit for bit on this machine)
            assert np.abs(g - w).max() <= BF16_ULP * scale
        else:
            # f32 sums in another order, through up to two products with W; the
            # JAX f32 message keeps ~16 significant bits (bf16 hi + lo)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale)
    assert not got[0][~tb.edge_mask].any()  # dH0's padding rows: exact zeros


def test_depth_loop_rejects_depth_1(batches):
    _, tb = batches
    with pytest.raises(ValueError):
        depth_loop(torch.zeros(tb.E.shape[0], D), torch.zeros(D, D), None, tb.src, tb.dst,
                   tb.rev, tb.edge_ptr, 1)


def _spy(monkeypatch, name, calls):
    real = getattr(base, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(base, name, spy)


@pytest.mark.parametrize("case", ["depth_loop", "dropout", "option_off", "taps"])
def test_depth_loop_dispatch_follows_jax(batches, monkeypatch, case):
    """With the option on, the ReLU path directed and no dropout drawn, the
    depth loop is taken before ``loop_readout``, even at depth 3 with
    ``fused_readout`` on (and with taps, which turn only ``loop_readout``
    off); dropout drawn, or the option off, gives today's dispatch."""
    _, tb = batches
    calls: list = []
    for name in ("depth_loop", "loop_readout", "first_iter", "message_iter"):
        _spy(monkeypatch, name, calls)
    opts = KernelOptions(depth_loop=case != "option_off", fused_readout=True)
    mp = BondMessagePassing(d_h=D_H, depth=3, dropout=0.1 if case == "dropout" else 0.0,
                            kernel_options=opts)
    taps = {} if case == "taps" else None
    mp(tb, is_training=True, generator=torch.Generator().manual_seed(0), taps=taps)
    want = {"depth_loop": ["depth_loop"], "taps": ["depth_loop"], "option_off": ["loop_readout"],
            "dropout": ["first_iter", "message_iter"]}[case]
    assert calls == want
    if case == "taps":  # the depth loop taps its final H only
        assert set(taps) == {"H_0", "H", "M_v"} and len(taps["H"]) == 1


def test_depth_loop_option_reads_jax_environment(monkeypatch):
    monkeypatch.setenv("CHEMPROP_TPU_DEPTH_LOOP", "1")
    monkeypatch.setenv("CHEMPROP_TPU_WINDOW_GATHER", "1")
    opts = KernelOptions.from_env()
    assert opts.depth_loop and opts.window_gather
    assert not KernelOptions().depth_loop and not KernelOptions().window_gather


def _models(mgs, dtype, activation="relu", depth=3, **jax_kwargs):
    """A JAX MPNN with numpy-drawn weights and the port's with the same."""
    jdt, tdt = DTYPES[dtype]
    jmodel = JaxMPNN(
        message_passing=JaxBondMP(d_h=D_H, depth=depth, compute_dtype=jdt, activation=activation),
        agg=JaxMean(), predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H),
        batch_norm=True)
    jb = jax_batch(mgs, JaxPadSpec(*PAD), sort_edges=True)
    variables = jmodel.init(jax.random.PRNGKey(0), jb, None, None, False)
    rng = np.random.default_rng(5)
    variables = jax.tree_util.tree_map(
        lambda x: jnp.asarray((rng.standard_normal(np.shape(x)) / np.sqrt(np.shape(x)[0])
                               if np.ndim(x) == 2 else 0.1 * rng.standard_normal(np.shape(x))
                               ).astype(np.float32)), variables)
    variables["batch_stats"]["bn"]["var"] = jnp.ones_like(variables["batch_stats"]["bn"]["var"])
    model = MPNN(BondMessagePassing(d_h=D_H, depth=depth, compute_dtype=tdt, activation=activation,
                                    kernel_options=KernelOptions(**jax_kwargs)),
                 MeanAggregation(), RegressionFFN(input_dim=D_H, hidden_dim=D_H,
                                                  output_transform=False), batch_norm=True)
    model.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]))
    return jmodel, variables, jb, model


@pytest.mark.parametrize("activation", ["leakyrelu:0.1", "prelu:0.2", "elu:0.5", "relu:0.3",
                                        "tanh:2"])
def test_activation_arguments_match_jax(activation):
    """The argument after the colon is the slope or alpha of leakyrelu, prelu
    and elu; the others ignore theirs, as in JAX."""
    x = np.linspace(-3, 3, 61).astype(np.float32)
    want = np.asarray(jax_activation(activation)(jnp.asarray(x)))
    got = get_activation_function(activation)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)  # elementwise f32


def test_leakyrelu_argument_model_matches_jax(mgs):
    """A model with ``activation="leakyrelu:0.1"`` composes the message kernel
    and the products, as any name but relu; f32 against JAX."""
    jmodel, variables, jb, model = _models(mgs, "float32", "leakyrelu:0.1")
    assert model.message_passing.activation == "leakyrelu:0.1"
    want = np.asarray(jmodel.apply(variables, jb, None, None, is_training=False))
    with torch.inference_mode():
        got = model(batch_mol_graphs(mgs, PadSpec(*PAD))).numpy()
    # f32; the JAX f32 message keeps ~16 significant bits (bf16 hi + lo)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("depth_loop_on", [False, True], ids=["per_iteration", "depth_loop"])
def test_taps_match_jax_intermediates(mgs, monkeypatch, depth_loop_on):
    """H_0, each iteration's H (the depth loop's final one only) and M_v, as
    the JAX package's ``intermediates`` collection has them, in f32."""
    monkeypatch.setenv("CHEMPROP_TPU_DEPTH_LOOP", "1" if depth_loop_on else "0")
    jmodel, variables, jb, model = _models(mgs, "float32", depth_loop=depth_loop_on)
    _, inter = jmodel.apply(variables, jb, is_training=False, method="fingerprint",
                            mutable=["intermediates"])
    want = inter["intermediates"]["message_passing"]
    taps: dict = {}
    tb = batch_mol_graphs(mgs, PadSpec(*PAD))
    with torch.inference_mode():
        model.fingerprint(tb, taps=taps)
    assert set(taps) == set(want) == {"H_0", "H", "M_v"}
    assert len(taps["H"]) == len(want["H"]) == (1 if depth_loop_on else 2)
    for name in taps:
        rows = tb.node_mask.numpy() if name == "M_v" else tb.edge_mask.numpy()
        for g, w in zip(taps[name], want[name]):
            w = np.asarray(w)
            assert g.shape == w.shape
            # f32; the JAX f32 message keeps ~16 significant bits
            np.testing.assert_allclose(g.numpy()[rows], w[rows], rtol=1e-4, atol=1e-4)


def test_window_gather_forward_is_bit_equal(mgs):
    """bfloat16: W_i's input gather through the row gather kernel's plain
    version gives the forward of the library gather, bit for bit; nothing is
    refused on a collated batch."""
    tb = batch_mol_graphs(mgs, PadSpec(*PAD))
    outs = []
    for on in (False, True):
        torch.manual_seed(0)
        mp = BondMessagePassing(d_h=D_H, compute_dtype=torch.bfloat16,
                                kernel_options=KernelOptions(window_gather=on))
        UNSERVED.clear()
        with torch.inference_mode():
            outs.append(mp(tb))
        assert UNSERVED["row_gather"] == 0
    assert torch.equal(outs[0], outs[1])


def test_window_gather_on_an_exactly_full_batch(mgs):
    """A batch whose real nodes fill every row but the last: the collate
    still keeps that padding node (every padding edge names it, no real edge
    does), so the route is served and equal to the library gather."""
    n_real = sum(mg.V.shape[0] for mg in mgs)
    tb = batch_mol_graphs(mgs, PadSpec(n_real + 1, PAD[1], PAD[2]))
    assert tb.last_node_is_padding() and not tb.node_mask[-1] and tb.node_mask[:-1].all()
    assert not tb.V[-1].any()
    mp = BondMessagePassing(d_h=D_H, compute_dtype=torch.bfloat16,
                            kernel_options=KernelOptions(window_gather=True))
    V = tb.V.to(torch.bfloat16)
    UNSERVED.clear()
    assert torch.equal(mp._v_src(V, tb), V[tb.src.long()])
    assert UNSERVED["row_gather"] == 0
    with pytest.raises(ValueError):  # no padding node at all: the collate refuses
        batch_mol_graphs(mgs, PadSpec(n_real, PAD[1], PAD[2]))


def test_window_gather_refuses_a_batch_without_its_padding_node(mgs):
    """A hand-built batch whose last node is real would lose that node's row
    to the zero rule: the route refuses it, counts it, and gathers by the
    library."""
    tb = batch_mol_graphs(mgs, PadSpec(*PAD))
    mask = tb.node_mask.clone()
    mask[-1] = True
    V = tb.V.clone()
    V[-1] = 1.0
    hand = replace(tb, node_mask=mask, V=V, last_node_padding=None)
    mp = BondMessagePassing(d_h=D_H, compute_dtype=torch.bfloat16,
                            kernel_options=KernelOptions(window_gather=True))
    Vb = hand.V.to(torch.bfloat16)
    UNSERVED.clear()
    assert torch.equal(mp._v_src(Vb, hand), Vb[hand.src.long()])  # the last row kept
    assert UNSERVED["row_gather"] == 1


def test_window_gather_serves_every_node_width(mgs):
    """A node table of 75 columns (150-byte rows, as with three extra atom
    features) is padded to the kernel's 16-byte chunks and cut back: the
    route serves it, and the bf16 forward with it on equals the library
    gather's bit for bit."""
    tb = batch_mol_graphs(mgs, PadSpec(*PAD))
    extra = torch.from_numpy(_rand((tb.V.shape[0], 3), 7)) * tb.node_mask[:, None]
    wide = replace(tb, V=torch.cat([tb.V, extra], dim=1))
    assert not wide.V[-1].any()
    outs = []
    for on in (False, True):
        torch.manual_seed(0)
        mp = BondMessagePassing(d_v=wide.V.shape[1], d_h=D_H, compute_dtype=torch.bfloat16,
                                kernel_options=KernelOptions(window_gather=on))
        UNSERVED.clear()
        with torch.inference_mode():
            outs.append(mp(wide))
        assert UNSERVED["row_gather"] == 0
    assert torch.equal(outs[0], outs[1])
    V = wide.V.to(torch.bfloat16)
    assert torch.equal(mp._v_src(V, wide), V[wide.src.long()])
