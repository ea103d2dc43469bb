"""Six faults of the port against the JAX package, each held to it:

* the FFN's activation: ``MLP`` and ``RegressionFFN`` build the activation
  they are given, ``build_model`` reads the head's from the checkpoint's
  hyperparameters, and a head loaded through ``from_jax_params`` computes
  what the JAX ``MLP`` computes with the same activation;
* the best epoch: ``Trainer.fit`` keeps the parameters of the epoch that the
  JAX trainer's rule picks (its ``monitor``, ``mode``, ``min_delta`` and
  ``patience``), and ``predict`` computes with them;
* ``grad_w`` on the composed path (another activation, or undirected
  messages): W_h's weight gradient goes through ``ops.grad_weight`` as the
  JAX package's ``gw_matmul`` routes it, and equals the gradient without it;
* the sum and norm readouts: in bfloat16 they round the f32 segment sum once
  to bfloat16 and divide in bfloat16, as the JAX package's kernel path does
  (``segment_sum`` with ``out_dtype = data.dtype``);
* a second ``Trainer.fit`` trains ``max_epochs`` more epochs from the state
  the first one left, as the JAX trainer's loop from ``start_epoch`` does;
* each epoch record of ``fit`` has the JAX trainer's keys, ``edges_per_s``
  among them: the real edges of the epoch's host batches over ``time_s``.

Small sizes throughout: widths of 16-64, the 100 molecules of
tests/data/regression/mol/mol.csv."""

from __future__ import annotations

import csv
import importlib

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
from chemprop_tpu.nn import NormAggregation as JaxNorm
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.nn import SumAggregation as JaxSum
from chemprop_tpu.nn.ffn import MLP as JaxMLP
from chemprop_tpu.nn.metrics import MAE as JaxMAE
from chemprop_tpu.train import Trainer as JaxTrainer
from chemprop_tpu_torch.data import DataLoader, MoleculeDatapoint, MoleculeDataset
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.models import MPNN, from_jax_params
from chemprop_tpu_torch.models.load import build_model, load_checkpoint
from chemprop_tpu_torch.nn import (
    BondMessagePassing,
    MeanAggregation,
    NormAggregation,
    RegressionFFN,
    SumAggregation,
)
from chemprop_tpu_torch.nn.metrics import MAE
from chemprop_tpu_torch.ops import KernelOptions
from chemprop_tpu_torch.train import Trainer

ACTIVATIONS = ["relu", "leakyrelu", "prelu", "tanh", "elu", "gelu", "silu", "softplus"]
BF16_ULP = 2.0**-7
gw_module = importlib.import_module("chemprop_tpu_torch.ops.grad_weight")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def datasets(data_dir):
    """The 100 molecules, their first 70 and their last 30, each with
    normalised targets."""
    with open(data_dir / "regression" / "mol" / "mol.csv") as f:
        rows = [(smi, float(y)) for smi, y in list(csv.reader(f))[1:]]
    out = {}
    for name, part in (("all", rows), ("train", rows[:70]), ("val", rows[70:])):
        ds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=np.array([y])) for s, y in part])
        ds.normalize_targets()
        ds.cache = True
        out[name] = ds
    return out


# ---------------------------------------------------------------- (a) the head


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_head_matches_jax_mlp(activation):
    """The head with each activation, its weights from a JAX MLP's tree
    through ``from_jax_params``, against that MLP on the same inputs (f32)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((37, 16)).astype(np.float32)
    jmlp = JaxMLP(16, 3, hidden_dim=[24, 20], dropout=0.0, activation=activation)
    params = jmlp.init(jax.random.PRNGKey(1), jnp.asarray(X), False)["params"]
    want = np.asarray(jmlp.apply({"params": params}, jnp.asarray(X), False))

    head = RegressionFFN(n_tasks=3, input_dim=16, hidden_dim=[24, 20], output_transform=False,
                         activation=activation)
    sd = from_jax_params({"message_passing": {}, "predictor": {"ffn": params}})
    head.load_state_dict({k.removeprefix("predictor."): v for k, v in sd.items()})
    got = head(torch.from_numpy(X)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_build_model_carries_the_head_activation(data_dir):
    """A checkpoint whose head says TANH builds a tanh head, whose output
    is the tanh head's and not the ReLU one's; a name the port cannot build
    raises."""
    ckpt = load_checkpoint(data_dir / "example_model_v2_regression_mol.pt")
    hp = ckpt["hyper_parameters"]
    skip = ("num_batches_tracked", "criterion", "metrics")
    sd = {k: v.float() for k, v in ckpt["state_dict"].items()
          if not any(part in skip for part in k.split("."))}
    relu = build_model(hp, sd)
    tanh_hp = dict(hp, predictor=dict(hp["predictor"], activation="TANH"))
    tanh = build_model(tanh_hp, sd)
    assert tanh.message_passing.activation == relu.message_passing.activation == "relu"
    assert [m.name for m in tanh.predictor.ffn.modules() if hasattr(m, "fn")] == ["tanh"]
    tanh.load_state_dict(sd)
    relu.load_state_dict(sd)
    Z = torch.from_numpy(np.random.default_rng(2).standard_normal((5, 300)).astype(np.float32))
    want = RegressionFFN(output_transform=True, activation="tanh")
    want.load_state_dict({k.removeprefix("predictor."): v for k, v in sd.items()
                          if k.startswith("predictor.")})
    with torch.no_grad():
        torch.testing.assert_close(tanh.predictor(Z), want(Z), rtol=0, atol=0)
        assert not torch.allclose(tanh.predictor(Z), relu.predictor(Z))
    with pytest.raises(ValueError, match="unknown activation"):
        build_model(dict(hp, predictor=dict(hp["predictor"], activation="swish")), sd)


# ------------------------------------------------------------ (b) best epoch


def _model():
    return MPNN(
        BondMessagePassing(d_h=32, depth=2),
        MeanAggregation(),
        RegressionFFN(input_dim=32, hidden_dim=32, output_transform=False),
        batch_norm=True,
    )


def _jax_rule(scores, mode="min", min_delta=0.0, patience=None):
    """``chemprop_tpu/train/trainer.py``'s best-epoch and early-stopping rule
    over a history of scores: (best epoch, epochs run)."""
    best, best_epoch, since = (np.inf if mode == "min" else -np.inf), -1, 0
    for epoch, score in enumerate(scores):
        improved = score < best - min_delta if mode == "min" else score > best + min_delta
        if improved:
            best, best_epoch, since = score, epoch, 0
        else:
            since += 1
        if patience is not None and since > patience:
            return best_epoch, epoch + 1
    return best_epoch, len(scores)


CASES = {
    # a validation loader: the score is val_loss
    "val_loss": dict(val=True),
    # no validation loader: the score is the epoch's train loss
    "train_loss": dict(val=False),
    "min_delta": dict(val=False, min_delta=0.05),
    "patience": dict(val=True, patience=1),
    "max_mode": dict(val=True, mode="max"),
}


@pytest.mark.parametrize("case", CASES)
def test_fit_keeps_the_best_epoch_by_the_jax_rule(datasets, case):
    kw = dict(CASES[case])
    val = kw.pop("val")
    trainer = Trainer(_model(), max_epochs=10, warmup_epochs=1, max_lr=5e-2, seed=3,
                      device="cpu", **kw)
    train_loader = DataLoader(datasets["train" if val else "all"], batch_size=25, shuffle=True,
                              seed=1)
    val_loader = DataLoader(datasets["val"], batch_size=50) if val else None
    snapshots = []
    step, per_epoch = trainer.train_step, len(train_loader)

    def recording_step(batch):  # the state after each epoch's last step
        loss = step(batch)
        if trainer.state.step % per_epoch == 0:
            snapshots.append({k: v.detach().clone() for k, v in trainer.model.state_dict().items()})
        return loss

    trainer.train_step = recording_step
    trainer.fit(train_loader, val_loader)
    history = trainer.history
    key = "val_loss" if val else "train_loss"
    best, ran = _jax_rule([h[key] for h in history], kw.get("mode", "min"),
                          kw.get("min_delta", 0.0), kw.get("patience"))
    assert ran == len(history) == len(snapshots)
    assert trainer.best_epoch == best
    if case in ("val_loss", "train_loss"):  # the case this repair is for
        assert best != len(history) - 1, "the fit's last epoch is its best: no test"
    if case == "patience":
        assert len(history) < trainer.max_epochs, "the fit did not stop early: no test"

    eval_loader = DataLoader(datasets["all"], batch_size=50)
    got = trainer.predict(eval_loader)
    # the same model loaded with the chosen epoch's parameters and statistics
    again = Trainer(_model(), seed=3, device="cpu")
    again.init_state(None, per_epoch)
    again.model.load_state_dict(snapshots[best])
    np.testing.assert_array_equal(got, again.predict(eval_loader))
    # the trainer's own state is the last epoch's, untouched by predict
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, snapshots[-1][k]), k


def test_predict_mc_dropout_uses_the_best_epoch(datasets):
    model = MPNN(BondMessagePassing(d_h=32, depth=2, dropout=0.2), MeanAggregation(),
                 RegressionFFN(input_dim=32, hidden_dim=32, output_transform=False, dropout=0.2),
                 batch_norm=True)
    trainer = Trainer(model, max_epochs=6, warmup_epochs=1, max_lr=5e-2, seed=3, device="cpu")
    trainer.fit(DataLoader(datasets["train"], batch_size=25, shuffle=True, seed=1),
                DataLoader(datasets["val"], batch_size=50))
    assert trainer.best_epoch != len(trainer.history) - 1, "the last epoch is the best: no test"
    loader = DataLoader(datasets["val"], batch_size=30)
    got = trainer.predict_mc_dropout(loader, sampling_size=3, seed=5)
    live = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    trainer.model.load_state_dict(trainer.best_variables)
    trainer.best_variables = None
    np.testing.assert_array_equal(got, trainer.predict_mc_dropout(loader, sampling_size=3, seed=5))
    trainer.model.load_state_dict(live)


def test_no_improving_epoch_keeps_the_last_state(datasets):
    trainer = Trainer(_model(), max_epochs=2, warmup_epochs=1, seed=3, device="cpu")
    # a NaN score never improves
    trainer._validate = lambda loader, metrics: {"val_loss": float("nan")}
    loader = DataLoader(datasets["val"], batch_size=30)
    trainer.fit(loader, loader)
    assert trainer.best_epoch == -1
    for k, v in trainer.model.state_dict().items():
        if k in trainer.best_variables:
            assert torch.equal(trainer.best_variables[k], v), k


# ------------------------------------------------------- (c) grad_w, composed


@pytest.mark.parametrize("variant", [dict(activation="tanh"), dict(undirected=True)],
                         ids=["tanh", "undirected"])
def test_composed_w_h_gradient_with_grad_w_equals_the_one_without(datasets, monkeypatch, variant):
    bmg = next(iter(DataLoader(datasets["all"], batch_size=32))).bmg
    routed = []
    plain = gw_module.grad_weight

    def spy(X, G, use_kernel=False):
        routed.append((X.shape[1], use_kernel))
        return plain(X, G, use_kernel)

    monkeypatch.setattr(gw_module, "grad_weight", spy)
    c = torch.from_numpy(np.random.default_rng(0).standard_normal((bmg.V.shape[0], 128)))
    grads, outs = [], []
    for grad_w in (False, True):
        mp = BondMessagePassing(d_h=64, compute_dtype=torch.bfloat16,
                                kernel_options=KernelOptions(grad_w=grad_w), **variant)
        torch.manual_seed(0)
        for p in mp.parameters():
            torch.nn.init.normal_(p, std=0.1)
        out = mp(bmg, is_training=True)
        outs.append(out)
        grads.append(torch.autograd.grad((out.float() * c.float()).sum(),
                                         [mp.W_h.weight, mp.W_i.weight]))
    # W_i's product, then W_h's in each of the two iterations, as gw_matmul
    assert routed == [(128, True), (128, True), (128, True)]
    assert torch.equal(outs[0], outs[1])
    # the same exact bf16 products summed in f32 in another order, rounded
    # once to bf16
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=BF16_ULP, atol=1e-6)


# ------------------------------------------------- (d) sum and norm readouts

SMIS = ["CCO", "c1ccccc1", "CC(=O)Nc1ccc(O)cc1", "CNC(C)Cc1ccccc1",
        "CC(C)CC1=CC=C(C=C1)C(C)C(=O)O", "c1ccc2ccccc2c1", "C", "O=[N+]([O-])c1ccc(Cl)cc1"]
READOUTS = {"sum": (JaxSum, SumAggregation, None), "norm": (JaxNorm, NormAggregation, 100.0)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _kernel_readout(H_v: np.ndarray, batch: np.ndarray, n_graphs: int, norm, dtype):
    """The JAX package's sum / norm readout as its segment-sum kernel computes
    it (``chemprop_tpu/ops/sorted_segments.py``: the sum accumulated in f32,
    rounded once to the data's dtype), then the norm's division in that dtype,
    in JAX's own ops; as f32. XLA's CPU ``segment_sum`` of a bfloat16 table
    accumulates in bfloat16, so the JAX model on the CPU is not the target."""
    sums = jax.ops.segment_sum(jnp.asarray(H_v, jnp.float32), jnp.asarray(batch), n_graphs + 1,
                               indices_are_sorted=True).astype(dtype)[:n_graphs]
    if norm is not None:
        sums = sums / norm
    return np.asarray(sums.astype(jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("readout", READOUTS)
def test_sum_and_norm_readouts_match_the_jax_kernel(monkeypatch, readout, dtype):
    """Both readouts through ``MPNN.fingerprint``, the weights handed over
    from a JAX model: the port's fingerprint is the JAX kernel's readout of
    the port's own node states (an f32 sum rounded once to bf16, divided in
    bf16: at most one bf16 ulp apart, where the two f32 sums round to
    neighbours, and equal almost everywhere), and it stays within the bf16
    envelope of the JAX model's own node states read out the same way. In
    float32 the fingerprints agree to the f32 message kernels' tolerance."""
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")
    jdt, tdt = DTYPES[dtype]
    jagg, tagg, norm = READOUTS[readout]
    feat = JaxFeaturizer()
    mgs = [feat(jdata.MoleculeDatapoint.from_smi(s).mol) for s in SMIS]
    pad = (256, 768, len(SMIS))
    jb = jax_batch(mgs, JaxPadSpec(*pad), sort_edges=True)
    jmodel = JaxMPNN(message_passing=JaxBondMP(d_h=64, depth=3, compute_dtype=jdt), agg=jagg(),
                     predictor=JaxRegressionFFN(input_dim=64, hidden_dim=64), batch_norm=False)
    variables = jmodel.init(jax.random.PRNGKey(0), jb, None, None, False)
    model = MPNN(BondMessagePassing(d_v=mgs[0].V.shape[1], d_e=mgs[0].E.shape[1], d_h=64,
                                    depth=3, compute_dtype=tdt),
                 tagg(), RegressionFFN(input_dim=64, hidden_dim=64, output_transform=False),
                 batch_norm=False)
    model.load_state_dict(from_jax_params(variables["params"], {}))
    tb = batch_mol_graphs(mgs, PadSpec(*pad))
    with torch.inference_mode():
        got = model.fingerprint(tb).numpy()
        H_v = model.message_passing(tb)
    batch, n_graphs = tb.batch.numpy(), tb.n_graphs
    assert got.dtype == np.float32 and got.shape == (n_graphs, 64)

    def mp(module, bmg):
        return module.message_passing(bmg, None, False, False, keep_padded=True, out_dtype=None)

    jH_v = jmodel.apply(variables, jb, method=mp)
    want = _kernel_readout(np.asarray(jH_v.astype(jnp.float32)), batch, n_graphs, norm, jdt)
    if dtype == "float32":
        np.testing.assert_allclose(got, want[:, :64], rtol=1e-4, atol=1e-4)
        return
    own = _kernel_readout(H_v.float().numpy(), batch, n_graphs, norm, jdt)[:, :64]
    assert np.array_equal(got, got.astype(jnp.bfloat16).astype(np.float32))
    ulps = np.abs(got - own) / (2.0**-8 * np.maximum(np.abs(own), 1e-30))
    assert ulps.max() <= 2.0 and np.mean(got == own) >= 0.99
    # the two models' node states round at other places: the JAX package's
    # own bf16 parity envelope
    np.testing.assert_allclose(got, want[:, :64], rtol=0.05, atol=0.05)


# ------------------------------------------------------ (e) a second fit


def test_a_second_fit_trains_max_epochs_more_as_jax_does(data_dir):
    """Two ``fit`` calls in a row on one trainer of each package, from the
    same initial parameters: each fit runs ``max_epochs`` epochs numbered
    from ``start_epoch`` (0), the history grows by that many records, and the
    second fit continues the optimiser's state (its step count, and the
    parameters it reaches) as the JAX trainer's does."""
    with open(data_dir / "regression" / "mol" / "mol.csv") as f:
        part = [(smi, float(y)) for smi, y in list(csv.reader(f))[1:17]]
    jds = jdata.MoleculeDataset([jdata.MoleculeDatapoint.from_smi(s, y=np.array([y]))
                                 for s, y in part])
    tds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=np.array([y])) for s, y in part])
    for ds in (jds, tds):
        ds.normalize_targets()
        ds.cache = True
    jmodel = JaxMPNN(message_passing=JaxBondMP(d_h=16, depth=2), agg=JaxMean(),
                     predictor=JaxRegressionFFN(input_dim=16, hidden_dim=16), batch_norm=False)
    model = MPNN(BondMessagePassing(d_h=16, depth=2), MeanAggregation(),
                 RegressionFFN(input_dim=16, hidden_dim=16, output_transform=False),
                 batch_norm=False)
    jloader = jdata.DataLoader(jds, batch_size=8, shuffle=False, prefetch=0)
    tloader = DataLoader(tds, batch_size=8, shuffle=False)
    kw = dict(max_epochs=2, warmup_epochs=1, seed=5)
    jtrainer = JaxTrainer(jmodel, steps_per_dispatch=1, **kw)
    jtrainer.state = jtrainer.init_state(next(iter(jloader)), len(jloader))
    trainer = Trainer(model, device="cpu", **kw)
    assert trainer.start_epoch == jtrainer.start_epoch == 0
    trainer.init_state(next(iter(tloader)), len(tloader))
    model.load_state_dict(from_jax_params(jtrainer.state.params, {}))
    for fit in (1, 2):
        jtrainer.fit(jloader)
        trainer.fit(tloader)
        assert len(trainer.history) == len(jtrainer.history) == 2 * fit
        assert [h["epoch"] for h in trainer.history] == [h["epoch"] for h in jtrainer.history]
        assert trainer.state.step == int(jtrainer.state.step) == 2 * fit * len(tloader)
        np.testing.assert_allclose([h["train_loss"] for h in trainer.history],
                                   [h["train_loss"] for h in jtrainer.history], rtol=1e-4)
    assert [h["epoch"] for h in trainer.history] == [0, 1, 0, 1]
    want = from_jax_params(jtrainer.state.params, {})
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=1e-3, atol=1e-5)


# ------------------------------------------------ (f) the epoch's edge rate


def test_fit_records_have_jax_keys_and_the_edge_rate(datasets):
    """Each record has the JAX trainer's keys (with a validation loader and a
    metric), and ``edges_per_s * time_s`` is the sum of ``edge_mask`` over
    the epoch's batches."""
    train, val = datasets["train"], datasets["val"]
    jds = jdata.MoleculeDataset([jdata.MoleculeDatapoint.from_smi(d.name, y=d.y)
                                 for d in train.data[:8]])
    jmodel = JaxMPNN(message_passing=JaxBondMP(d_h=16, depth=2), agg=JaxMean(),
                     predictor=JaxRegressionFFN(input_dim=16, hidden_dim=16), batch_norm=False)
    jtrainer = JaxTrainer(jmodel, max_epochs=1, seed=5, val_metrics={"mae": JaxMAE()})
    jloader = jdata.DataLoader(jds, batch_size=8, prefetch=0)
    jtrainer.fit(jloader, jloader)

    loader = DataLoader(train, batch_size=16, shuffle=True, seed=2)
    edges = sum(int(b.bmg.edge_mask.sum()) for b in loader)
    assert edges == sum(d.mol.num_bonds for d in train.data) * 2
    model = MPNN(BondMessagePassing(d_h=16, depth=2), MeanAggregation(),
                 RegressionFFN(input_dim=16, hidden_dim=16, output_transform=False))
    trainer = Trainer(model, max_epochs=2, seed=5, device="cpu", val_metrics={"mae": MAE()})
    trainer.fit(loader, DataLoader(val, batch_size=30))
    assert len(trainer.history) == 2
    for rec in trainer.history:
        assert list(rec) == list(jtrainer.history[0])
        assert rec["edges_per_s"] > 0
        assert rec["edges_per_s"] * rec["time_s"] == pytest.approx(edges, rel=1e-9)
