"""Atom message passing and the attentive readout of the port against the
JAX package on the CPU: ``AtomMessagePassing`` forward in float32 and
bfloat16 (with a bias, undirected messages, tanh and atom descriptors, and
its ``H_0`` / ``H`` / ``M_v`` taps) with the JAX module's weights carried
across, three Adam steps of whole models in float32 (with dropout, JAX's
masks carried across, and with the attentive readout),
``AttentiveAggregation`` with padding graphs and a one-node molecule, kernel
C's plain version at the unpadded atom-message widths, ``CPTPU001`` files
both ways, a reference-format v2 ``.pt`` and a v1 ``.pt`` with
``atom_messages`` made here from the files under tests/data, and one epoch of
``train --atom-messages --aggregation attentive`` in both command lines from
one warm start. Small size: d_h = 64 (lane-padded to 128 in the port), the
100 molecules of tests/data/regression/mol/mol.csv in batches of 32."""

from __future__ import annotations

import argparse
import csv
import json
import sys
import types
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu import data as jdata
from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.models import serialize as jserialize
from chemprop_tpu.nn import AtomMessagePassing as JaxAtomMP
from chemprop_tpu.nn import AttentiveAggregation as JaxAttentive
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.ops.sorted_segments import sorted_segment_sum as jax_segment_sum
from chemprop_tpu.train import Trainer as JaxTrainer
from chemprop_tpu.train.schedulers import noam_lr_host
from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.cli.main import construct_parser
from chemprop_tpu_torch.cli.main import main as port_main
from chemprop_tpu_torch.cli.parsing import build_datasets, make_datapoints, parse_csv
from chemprop_tpu_torch.cli.train import build_model
from chemprop_tpu_torch.data import DataLoader
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.models import MPNN, from_jax_params, load_model, serialize
from chemprop_tpu_torch.models.load import load_checkpoint
from chemprop_tpu_torch.nn import AtomMessagePassing, AttentiveAggregation, RegressionFFN
from chemprop_tpu_torch.nn import MeanAggregation
from chemprop_tpu_torch.nn.init import init_parameters
from chemprop_tpu_torch.ops import LAUNCHES
from chemprop_tpu_torch.ops.segment import sorted_segment_sum_plain
from chemprop_tpu_torch.train import Trainer
from test_torch_per_iteration import (  # noqa: F401  (fixtures)
    D_H,
    DTYPES,
    THREE_LRS,
    _Masks,
    datasets,
    one_torch_thread,
)

BF16_ULP = 2.0**-7
D_VD = 5
# message-passing arguments, dtype and atom-descriptor width of the forward
FORWARD = {
    "plain_f32": (dict(), "float32", None),
    "plain_bf16": (dict(), "bfloat16", None),
    "bias_undirected_tanh_vd_f32": (dict(bias=True, undirected=True, activation="tanh"),
                                    "float32", D_VD),
    "bias_undirected_tanh_vd_bf16": (dict(bias=True, undirected=True, activation="tanh"),
                                     "bfloat16", D_VD),
    "dropout_f32": (dict(dropout=0.2), "float32", None),
}


def _first_batches(datasets, size=32):
    jds, tds = datasets
    jb = next(iter(jdata.DataLoader(jds, batch_size=size, shuffle=False, prefetch=0)))
    tb = next(iter(DataLoader(tds, batch_size=size, shuffle=False)))
    return jb, tb


def _load_mp(mp: torch.nn.Module, params) -> None:
    sd = from_jax_params({"message_passing": params, "predictor": {"ffn": {}}})
    mp.load_state_dict({k.removeprefix("message_passing."): v for k, v in sd.items()})


@pytest.mark.parametrize("variant", FORWARD)
def test_atom_message_passing_forward_matches_jax(datasets, monkeypatch, variant):
    """The module alone in training mode (dropout drawn where it has one),
    its node table and its taps, against JAX's with the same weights."""
    mp_kwargs, dtype, d_vd = FORWARD[variant]
    jdt, tdt = DTYPES[dtype]
    jb, tb = _first_batches(datasets)
    V_d = None
    if d_vd:
        rng = np.random.default_rng(4)
        V_d = (rng.standard_normal((tb.bmg.V.shape[0], d_vd)).astype(np.float32)
               * tb.bmg.node_mask.numpy()[:, None])
    jmp = JaxAtomMP(d_h=D_H, compute_dtype=jdt, d_vd=d_vd, **mp_kwargs)
    jV_d = None if V_d is None else jnp.asarray(V_d)
    variables = jmp.init(jax.random.PRNGKey(0), jb.bmg, jV_d, False)
    if mp_kwargs.get("bias"):  # flax starts the biases at zero; make them count
        variables = jax.tree_util.tree_map(lambda x: x + 0.05 if x.ndim == 1 else x, variables)
    masks = _Masks(monkeypatch) if "dropout" in mp_kwargs else None
    want, state = jmp.apply(variables, jb.bmg, jV_d, True, rngs={"dropout": jax.random.PRNGKey(1)},
                            mutable=["intermediates"])
    mp = AtomMessagePassing(d_h=D_H, compute_dtype=tdt, d_vd=d_vd, **mp_kwargs)
    _load_mp(mp, variables["params"])
    taps: dict = {}
    LAUNCHES.clear()
    got = mp(tb.bmg, None if V_d is None else torch.from_numpy(V_d), is_training=True,
             generator=torch.Generator().manual_seed(0), taps=taps)
    assert sum(LAUNCHES.values()) == 0  # the CPU takes the plain versions
    assert masks is None or not masks.masks  # every recorded mask was used
    assert got.dtype == tdt and got.shape[1] % 128 == 0
    width = D_H + (d_vd or 0)
    got = got.detach().float().numpy()[:, :width]
    real = tb.bmg.node_mask.numpy()
    inter = state["intermediates"]
    tapped = {name: (taps[name], inter[name]) for name in ("H_0", "H", "M_v")}
    assert len(taps["H"]) == len(inter["H"]) == 2  # depth 3: two iterations
    if dtype == "float32":
        np.testing.assert_allclose(got[real], np.asarray(want)[real], rtol=1e-5, atol=1e-6)
        for name, (port, jax_) in tapped.items():
            for p, j in zip(port, jax_):
                np.testing.assert_allclose(p.detach().numpy()[:, :D_H], np.asarray(j),
                                           rtol=1e-5, atol=1e-6, err_msg=name)
    else:
        # the JAX package's bf16 parity envelope; its CPU segment sums add in
        # bf16 where the port's add in f32 and round once
        np.testing.assert_allclose(got[real], np.asarray(want, np.float32)[real], rtol=0.05,
                                   atol=0.1)
        for name, (port, jax_) in tapped.items():
            for p, j in zip(port, jax_):
                np.testing.assert_allclose(p.detach().float().numpy()[:, :D_H],
                                           np.asarray(j, np.float32), rtol=0.05, atol=0.1,
                                           err_msg=name)


def test_padding_columns_and_message_width():
    """The lane padding of the port's own: W_h's kernel takes zero rows at
    the hidden width's pad and past the bond features, so the message table
    is [H ; E ; 0] at a multiple of 8 columns."""
    mp = AtomMessagePassing(d_v=72, d_e=14, d_h=300)
    assert (mp.d_pad, mp.d_message) == (384, 400)
    assert tuple(mp.W_i.weight.shape) == (300, 72) and tuple(mp.W_h.weight.shape) == (300, 314)
    assert AtomMessagePassing(d_v=72, d_e=14, d_h=64).d_message == 144


# ---------------------------------------------------------- three Adam steps
def _jax_model(agg: str, rate: float):
    return JaxMPNN(
        message_passing=JaxAtomMP(d_h=D_H, dropout=rate),
        agg=JaxAttentive(output_size=D_H) if agg == "attentive" else JaxMean(),
        predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H, dropout=rate),
        batch_norm=True,
    )


def _port_model(agg: str, rate: float, dtype=torch.float32):
    return MPNN(
        AtomMessagePassing(d_h=D_H, dropout=rate, compute_dtype=dtype),
        AttentiveAggregation(D_H) if agg == "attentive" else MeanAggregation(),
        RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False, dropout=rate),
        batch_norm=True,
    )


@pytest.mark.parametrize("agg,rate", [("mean", 0.2)], ids=["dropout_mean"])
def test_three_adam_steps_match_jax(datasets, monkeypatch, agg, rate):
    """Three f32 steps from JAX's initial parameters on the same unshuffled
    batches, JAX's dropout masks carried across; test_torch_train.py's
    limits. (The attentive readout's training is held to JAX's by
    test_train_epoch_matches_jax, its gradients by
    test_attentive_aggregation_matches_jax.)"""
    jds, tds = datasets
    jmodel, model = _jax_model(agg, rate), _port_model(agg, rate)
    masks = _Masks(monkeypatch) if rate else None
    jloader = jdata.DataLoader(jds, batch_size=32, shuffle=False, prefetch=0)
    tloader = DataLoader(tds, batch_size=32, shuffle=False)
    jbatches, tbatches = list(jloader)[:3], list(tloader)[:3]
    jtrainer = JaxTrainer(jmodel, max_epochs=50, warmup_epochs=2, seed=12)
    state = jtrainer.init_state(jbatches[0], len(jloader))
    trainer = Trainer(model, max_epochs=50, warmup_epochs=2, seed=12, device="cpu")
    trainer.init_state(tbatches[0], len(tloader))
    model.load_state_dict(from_jax_params(state.params, state.batch_stats))
    # with dropout the JAX steps run eagerly, so that their masks are concrete
    jstep = jtrainer._train_body() if masks else jax.jit(jtrainer._train_body())
    jlosses, tlosses = [], []
    for jb, tb in zip(jbatches, tbatches):
        state, loss = jstep(state, jb)
        jlosses.append(float(loss))
        if masks is not None:
            assert len(masks.masks) == 4  # two iterations, the node table, the head
        tlosses.append(float(trainer.train_step(tb)))
        assert masks is None or not masks.masks
    want = from_jax_params(state.params, state.batch_stats)
    got = {k: v.detach() for k, v in model.state_dict().items()}
    assert set(got) == set(want)
    if agg == "attentive":
        assert {"agg.W.weight", "agg.W.bias"} <= set(got)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    n_bad = n_all = 0
    for name in want:
        err = (got[name] - want[name]).abs()
        # Adam steps by the rate times the gradient's sign: an element whose
        # gradient is at f32 rounding level may step the other way
        assert float(err.max()) <= 2 * THREE_LRS, name
        n_bad += int((err > 1e-6 + 1e-4 * want[name].abs()).sum())
        n_all += err.numel()
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)


# ------------------------------------------------------- attentive readout
ATTENTIVE_SMILES = ["CCO", "C", "c1ccccc1", "CC(=O)O", "O"]  # "C", "O": one node each


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attentive_aggregation_matches_jax(dtype):
    """Padding graphs (empty segments), one-node molecules and the sacrificial
    graph of the padding nodes; the port's node table arrives lane-padded,
    its padding columns hold junk that W must not read. The logits, weights
    and sums are float32 in both packages whatever H's dtype, as flax's
    ``nn.Dense(1)`` promotes a bf16 H with f32 parameters; the gradients of
    H and W in float32."""
    jdt, tdt = DTYPES[dtype]
    feat = SimpleMoleculeMolGraphFeaturizer()
    bmg = batch_mol_graphs([feat(make_mol(s)) for s in ATTENTIVE_SMILES],
                           PadSpec(128, 512, len(ATTENTIVE_SMILES) + 2))
    n = bmg.V.shape[0]
    rng = np.random.default_rng(9)
    H = torch.from_numpy(rng.standard_normal((n, 128)).astype(np.float32)).to(tdt)
    jbmg = SimpleNamespace(batch=jnp.asarray(bmg.batch.numpy()), n_graphs=bmg.n_graphs)
    jagg = JaxAttentive(output_size=D_H)
    jH = jnp.asarray(H[:, :D_H].float().numpy()).astype(jdt)
    variables = jagg.init(jax.random.PRNGKey(3), jH, jbmg)
    variables = jax.tree_util.tree_map(lambda x: x + 0.3 if x.ndim == 1 else 3 * x, variables)
    want = jagg.apply(variables, jH, jbmg)
    agg = AttentiveAggregation(D_H)
    with torch.no_grad():
        agg.W.weight.copy_(torch.tensor(np.asarray(variables["params"]["W"]["kernel"]).T))
        agg.W.bias.copy_(torch.tensor(np.asarray(variables["params"]["W"]["bias"])))
    H.requires_grad_(dtype == "float32")
    got = agg(H, bmg)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.shape == (bmg.n_graphs, 128) and want.shape == (bmg.n_graphs, D_H)
    np.testing.assert_allclose(got.detach().numpy()[:, :D_H], np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # empty graphs sum to zero; a one-node graph's weight is 1
    np.testing.assert_array_equal(got.detach().numpy()[len(ATTENTIVE_SMILES):], 0.0)
    one = bmg.node_ptr[1].item()  # "C": the first node of the second graph
    np.testing.assert_allclose(got.detach()[1, :D_H].numpy(), H.detach()[one, :D_H].float().numpy(),
                               rtol=1e-6)
    if dtype == "float32":
        c = rng.standard_normal((bmg.n_graphs, D_H)).astype(np.float32)

        def loss(params, x):
            return jnp.sum(jagg.apply(params, x, jbmg) * c)

        jg_params, jg_H = jax.grad(loss, argnums=(0, 1))(variables, jH)
        tg = torch.autograd.grad((got[:, :D_H] * torch.from_numpy(c)).sum(),
                                 [H, agg.W.weight, agg.W.bias])
        np.testing.assert_allclose(tg[0].numpy()[:, :D_H], np.asarray(jg_H), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tg[1].numpy().T, np.asarray(jg_params["params"]["W"]["kernel"]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tg[2].numpy(), np.asarray(jg_params["params"]["W"]["bias"]),
                                   rtol=1e-4, atol=1e-5)


# -------------------------------------------- kernel C at the message widths
@pytest.mark.parametrize("width", [314, 318])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_plain_at_atom_message_widths(datasets, monkeypatch, width, dtype):
    """C's plain version at the JAX package's unpadded message widths (d_h +
    d_e = 300 + 14, and 304 + 14) over a batch's edges, against JAX's sorted
    segment sum run as its own tests run it on the CPU. JAX is handed the f32
    values (bf16-representable where the port gets bf16), so that both sum
    in f32 and cast once."""
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")
    _, tb = _first_batches(datasets)
    jdt, tdt = DTYPES[dtype]
    dst, ptr = tb.bmg.dst, tb.bmg.edge_ptr
    x = np.random.default_rng(width).standard_normal((dst.shape[0], width)).astype(np.float32)
    x = torch.from_numpy(x).to(tdt).float().numpy()
    got, _ = sorted_segment_sum_plain(torch.from_numpy(x).to(tdt), dst, ptr, tdt)
    want = np.asarray(jax_segment_sum(jnp.asarray(x), jnp.asarray(dst.numpy()), ptr.numel() - 1,
                                      jdt), np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape == (ptr.numel() - 1, width)
    if dtype == "float32":
        scale = sorted_segment_sum_plain(torch.from_numpy(np.abs(x)), dst, ptr,
                                         torch.float32)[0].numpy()
        assert (np.abs(got - want) <= 1e-6 + 1e-6 * scale).all()
    else:  # f32 sums in another order, rounded once: equal or one bf16 ulp apart
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-6)


# ------------------------------------------------------------------ CPTPU001
def _predict_both(jmodel, jvars, model, datasets):
    jb, tb = _first_batches(datasets)
    want = np.asarray(jmodel.apply(jvars, jb.bmg, None, None, is_training=False))
    with torch.no_grad():
        got = model.eval()(tb.bmg).numpy()
    real = tb.w.numpy()[:, 0] > 0
    return got[real], want[real]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_cptpu001_both_ways(datasets, tmp_path, direction):
    """A model with atom message passing (bias, undirected), the attentive
    readout and batch norm: the port's file read by JAX's ``load_model``, and
    JAX's file read by the port's, each predicting as its writer does."""
    path = tmp_path / "atom_attentive.ckpt"
    jb, _ = _first_batches(datasets)
    if direction == "port_to_jax":
        model = MPNN(AtomMessagePassing(d_h=D_H, bias=True, undirected=True),
                     AttentiveAggregation(D_H),
                     RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False),
                     batch_norm=True)
        init_parameters(model, "torch", torch.Generator().manual_seed(21))
        with torch.no_grad():
            model.bn.running_mean.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(2))
        serialize.save_model(path, model, ["lipo"])
        jmodel, jvars, extra = jserialize.load_model(path)
        assert type(jmodel.message_passing).__name__ == "AtomMessagePassing"
        assert type(jmodel.agg).__name__ == "AttentiveAggregation"
        assert jmodel.agg.output_size == D_H and extra == {"output_columns": ["lipo"]}
    else:
        jmodel = JaxMPNN(message_passing=JaxAtomMP(d_h=D_H, bias=True, undirected=True),
                         agg=JaxAttentive(output_size=D_H),
                         predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H),
                         batch_norm=True)
        jvars = jmodel.init(jax.random.PRNGKey(5), jb.bmg, None, None, False)
        jvars = jax.tree_util.tree_map(lambda x: x + 0.02 if x.ndim == 1 else x, jvars)
        jserialize.save_model(path, jmodel, jax.device_get(jvars), ["lipo"])
        model, cols = load_model(path, "cpu")
        assert isinstance(model.message_passing, AtomMessagePassing) and cols == ["lipo"]
        assert isinstance(model.agg, AttentiveAggregation) and model.agg.output_size == D_H
        assert model.message_passing.undirected and model.message_passing.W_h.bias is not None
    got, want = _predict_both(jmodel, jvars, model, datasets)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------- reference .pt files
def _fake_reference_classes(monkeypatch) -> dict[str, type]:
    """Classes named as chemprop's, in modules that exist only while the
    file is written, so that the pickle names them as a reference file does;
    both packages read them back as stubs that remember the name."""
    classes = {}
    for module, names in (("chemprop.nn.message_passing.base", ["AtomMessagePassing"]),
                          ("chemprop.nn.agg", ["AttentiveAggregation"]),
                          ("chemprop.nn.predictors", ["RegressionFFN"])):
        parts = module.split(".")
        for i in range(1, len(parts) + 1):
            name = ".".join(parts[:i])
            if name not in sys.modules:
                monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        for cls_name in names:
            cls = type(cls_name, (), {"__module__": module})
            setattr(sys.modules[module], cls_name, cls)
            classes[cls_name] = cls
    return classes


def _write_v2(path, data_dir) -> None:
    """A reference-format v2 ``.pt`` of atom message passing (a bias), the
    attentive readout, batch norm and the reference file's output scaling;
    its weights drawn from a seed at the widths of the v2 featurizer."""
    ref = load_checkpoint(data_dir / "example_model_v2_regression_mol.pt")
    model = MPNN(AtomMessagePassing(d_h=D_H, bias=True), AttentiveAggregation(D_H),
                 RegressionFFN(input_dim=D_H, hidden_dim=D_H), batch_norm=True)
    init_parameters(model, "torch", torch.Generator().manual_seed(8))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for key in ("mean", "scale"):
        sd[f"predictor.output_transform.{key}"] = ref["state_dict"][
            f"predictor.output_transform.{key}"].clone()
    sd["bn.num_batches_tracked"] = torch.tensor(4)
    mp_hp = {k: v for k, v in dict(ref["hyper_parameters"]["message_passing"]).items()
             if k not in ("cls", "graph_transform")}
    p_hp = {k: v for k, v in dict(ref["hyper_parameters"]["predictor"]).items()
            if k not in ("cls", "criterion", "output_transform")}
    with pytest.MonkeyPatch.context() as m:
        cls = _fake_reference_classes(m)
        hp = {
            "batch_norm": True, "metrics": None, "warmup_epochs": 2, "init_lr": 1e-4,
            "max_lr": 1e-3, "final_lr": 1e-4, "X_d_transform": None,
            "message_passing": {**mp_hp, "d_h": D_H, "bias": True, "graph_transform": None,
                                "cls": cls["AtomMessagePassing"]},
            "agg": {"dim": 0, "output_size": D_H, "cls": cls["AttentiveAggregation"]},
            "predictor": {**p_hp, "input_dim": D_H, "hidden_dim": D_H,
                          "cls": cls["RegressionFFN"], "output_transform": {"_buffers": {
                              k: sd[f"predictor.output_transform.{k}"] for k in ("mean", "scale")}}},
        }
        torch.save({"hyper_parameters": hp, "state_dict": sd}, path)


def _write_v1(path, data_dir) -> None:
    """The reference v1 file with ``atom_messages`` on, W_i (133 atom
    features) and W_h (hidden width and 14 bond features) drawn from a seed
    at their new widths."""
    d = load_checkpoint(data_dir / "example_model_v1_regression_mol.pt")
    d["args"] = argparse.Namespace(**{**vars(d["args"]), "atom_messages": True})
    g = torch.Generator().manual_seed(13)
    sd = d["state_dict"]
    for name, shape in (("W_i", (300, 133)), ("W_h", (300, 314))):
        sd[f"encoder.encoder.0.{name}.weight"] = torch.randn(shape, generator=g) / shape[1] ** 0.5
    torch.save(d, path)


def _read_preds(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.array([[float(x) for x in r[1:]] for r in rows[1:]])


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_reference_files_with_atom_messages(data_dir, tmp_path, version):
    """The port's ``predict`` of the file within 1e-5 of the JAX command
    line's ``convert`` then ``predict`` (its ``predict`` reads ``CPTPU001``
    files); the port's own ``convert`` serves the same predictions."""
    path = tmp_path / f"atom_{version}.pt"
    (_write_v2 if version == "v2" else _write_v1)(path, data_dir)
    model, _ = load_model(path, "cpu")
    assert isinstance(model.message_passing, AtomMessagePassing)
    assert isinstance(model.agg, AttentiveAggregation if version == "v2" else MeanAggregation)
    with open(data_dir / "regression/mol/mol.csv") as f:
        head = f.read().splitlines()[:41]
    inputs = tmp_path / "in.csv"
    inputs.write_text("\n".join(head) + "\n")
    flags = ["predict", "--model-path", str(path), "-i", str(inputs)]
    assert jax_main(["convert", "-i", str(path), "-o", str(tmp_path / "j.ckpt")]) == 0
    assert jax_main(["predict", "--model-path", str(tmp_path / "j.ckpt"), "-i", str(inputs),
                     "-o", str(tmp_path / "jax.csv")]) == 0
    assert port_main(flags + ["-o", str(tmp_path / "port.csv"), "--device", "cpu"]) == 0
    (jh, jp), (th, tp) = _read_preds(tmp_path / "jax.csv"), _read_preds(tmp_path / "port.csv")
    assert th == jh and tp.shape == jp.shape == (40, 1)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    assert np.ptp(tp) > 0.01  # the rows differ: the model reads its inputs
    assert port_main(["convert", "-i", str(path), "-o", str(tmp_path / "c.ckpt")]) == 0
    conv = flags[:2] + [str(tmp_path / "c.ckpt")] + flags[3:]
    assert port_main(conv + ["-o", str(tmp_path / "conv.csv"), "--device", "cpu"]) == 0
    assert (tmp_path / "conv.csv").read_text() == (tmp_path / "port.csv").read_text()


# ---------------------------------------------------------------- train CLI
# no batch norm: under it the fingerprint's columns lose their offsets, so the
# gradients of W_o's bias (and of W_o's rows of atom features that are alike
# in every atom) are rounding noise, whose sign Adam's first steps follow in
# each package; the validation loss then moves by 1e-4 of itself (the
# attentive readout's bias has no gradient at all, but moves no output)
FLAGS = ["--atom-messages", "--aggregation", "attentive", "--message-hidden-dim", str(D_H),
         "--ffn-hidden-dim", str(D_H)]
COMMON = ["--epochs", "1", "--split", "scaffold_balanced", "--data-seed", "2", "--seed", "5"]
# one epoch: two Adam steps (80 training rows in batches of 64) of the warm-up
TWO_LRS = sum(noam_lr_host(k, 4, 1, 1e-4, 1e-3, 1e-4) for k in range(2))


def test_train_epoch_matches_jax(data_dir, tmp_path):
    """One epoch of ``train --atom-messages --aggregation attentive`` in both
    command lines from one ``CPTPU001`` warm start: splits, losses,
    parameters and test predictions."""
    mol_csv = data_dir / "regression/mol/mol.csv"
    args = construct_parser().parse_args(["train", "-i", str(mol_csv), *FLAGS, "--device", "cpu"])
    model = build_model(args, build_datasets(make_datapoints(*parse_csv(mol_csv, None, None,
                                                                        None)[:6])))
    assert isinstance(model.message_passing, AtomMessagePassing)
    assert isinstance(model.agg, AttentiveAggregation) and model.agg.output_size == D_H
    init_parameters(model, "lecun", torch.Generator().manual_seed(11))
    serialize.save_model(tmp_path / "warm.ckpt", model)
    argv = ["train", "-i", str(mol_csv), "--checkpoint", str(tmp_path / "warm.ckpt"), *FLAGS,
            *COMMON]
    assert jax_main(argv + ["-o", str(tmp_path / "jax")]) == 0
    assert port_main(argv + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    jdir, pdir = tmp_path / "jax", tmp_path / "port"

    def read(path):
        return json.loads(path.read_text())

    assert read(pdir / "splits.json") == read(jdir / "splits.json")
    want, got = read(jdir / "history.json"), read(pdir / "history.json")
    manifest, variables = serialize.read_checkpoint(pdir / "best.ckpt")
    assert manifest["model"]["message_passing"]["cls"] == "AtomMessagePassing"
    assert manifest["model"]["agg"] == {"cls": "AttentiveAggregation", "output_size": D_H}
    jvars = serialize.read_checkpoint(jdir / "best.ckpt")[1]
    flat_p = dict(_flat(variables["params"]))
    flat_j = dict(_flat(jvars["params"]))
    assert set(flat_p) == set(flat_j) and "agg/W/kernel" in flat_p
    n_bad = n_all = 0
    for name, w in flat_j.items():
        err = np.abs(flat_p[name] - w)
        assert err.max() <= 2 * TWO_LRS, name
        n_bad += int((err > 1e-6 + 1e-4 * np.abs(w)).sum())
        n_all += err.size
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want], rtol=1e-5,
                                   err_msg=key)
    (jh, jp), (th, tp) = (_read_preds(d / "test_predictions.csv") for d in (jdir, pdir))
    assert th == jh
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, np.asarray(tree, np.float64)
