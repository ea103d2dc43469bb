"""The port's training runtime against the JAX package's: the same initial
parameters (JAX's initialisation carried across by ``from_jax_params``), the
same unshuffled batches, three Adam steps; and the pieces on their own: the
schedule, the masked batch norm, the masked weighted loss, the target scaler,
the loader. Small size: d_h = 64 (padded to 128), the 100 molecules of
tests/data/regression/mol/mol.csv in batches of 32; only the overfit bar
itself also runs at the default width."""

from __future__ import annotations

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.preprocessing import StandardScaler as SklearnScaler

from chemprop_tpu import data as jdata
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.nn.batchnorm import MaskedBatchNorm
from chemprop_tpu.nn.metrics import MSE as JaxMSE
from chemprop_tpu.train import Trainer as JaxTrainer
from chemprop_tpu.train.schedulers import noam_lr_host
from chemprop_tpu_torch.data import (
    DataLoader,
    MoleculeDatapoint,
    MoleculeDataset,
    SeededSampler,
    StandardScaler,
)
from chemprop_tpu_torch.models import MPNN, from_jax_params
from chemprop_tpu_torch.nn import BatchNorm, BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.nn.metrics import MSE
from chemprop_tpu_torch.train import Trainer, noam_lr

D_H = 64
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def rows(data_dir):
    with open(data_dir / "regression" / "mol" / "mol.csv") as f:
        return [(smi, float(y)) for smi, y in list(csv.reader(f))[1:]]


@pytest.fixture(scope="module")
def datasets(rows):
    """The lipophilicity rows as a dataset of each package, targets normalised."""
    jds = jdata.MoleculeDataset(
        [jdata.MoleculeDatapoint.from_smi(s, y=np.array([y])) for s, y in rows]
    )
    tds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=np.array([y])) for s, y in rows])
    for ds in (jds, tds):
        ds.normalize_targets()
        ds.cache = True
    return jds, tds


def _models(dtype, depth=3, batch_norm=True):
    jdt, tdt = DTYPES[dtype]
    jmodel = JaxMPNN(
        message_passing=JaxBondMP(d_h=D_H, depth=depth, compute_dtype=jdt),
        agg=JaxMean(),
        predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H),
        batch_norm=batch_norm,
    )
    model = MPNN(
        BondMessagePassing(d_h=D_H, depth=depth, compute_dtype=tdt),
        MeanAggregation(),
        RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False),
        batch_norm=batch_norm,
    )
    return jmodel, model


def _three_steps(datasets, dtype, depth):
    """Three training steps of both packages from JAX's initial parameters;
    returns the losses and the final states, the JAX one mapped into the
    port's names."""
    jds, tds = datasets
    jmodel, model = _models(dtype, depth)
    jloader = jdata.DataLoader(jds, batch_size=32, shuffle=False, prefetch=0)
    tloader = DataLoader(tds, batch_size=32, shuffle=False)
    jbatches, tbatches = list(jloader)[:3], list(tloader)[:3]

    jtrainer = JaxTrainer(jmodel, max_epochs=50, warmup_epochs=2, seed=12)
    state = jtrainer.init_state(jbatches[0], len(jloader))
    trainer = Trainer(model, max_epochs=50, warmup_epochs=2, seed=12, device="cpu")
    trainer.init_state(tbatches[0], len(tloader))
    model.load_state_dict(from_jax_params(state.params, state.batch_stats))

    jstep = jax.jit(jtrainer._train_body())
    jlosses, tlosses = [], []
    for jb, tb in zip(jbatches, tbatches):
        state, loss = jstep(state, jb)
        jlosses.append(float(loss))
        tlosses.append(float(trainer.train_step(tb)))
    want = from_jax_params(state.params, state.batch_stats)
    got = {k: v.detach() for k, v in model.state_dict().items()}
    assert trainer.state.step == int(state.step) == 3
    return jlosses, tlosses, want, got


# Adam moves a weight by about the learning rate in the direction of its
# gradient's sign, whatever the gradient's size. Where a gradient is at the
# level of f32 rounding (a hidden unit that is all but dead), summation order
# decides that sign, and the two packages step in opposite directions: such an
# element can differ by twice the three steps' learning rates and no more.
THREE_LRS = sum(noam_lr_host(k, 8, 192, 1e-4, 1e-3, 1e-4) for k in range(3))


@pytest.mark.parametrize("depth", [3, 2, 4])
def test_three_adam_steps_match_jax_f32(datasets, depth):
    jlosses, tlosses, want, got = _three_steps(datasets, "float32", depth)
    # the same arithmetic in f32; only summation orders differ
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert set(got) == set(want)
    n_bad = n_all = 0
    for name in want:  # every parameter and both batch-norm statistics
        err = (got[name] - want[name]).abs()
        assert float(err.max()) <= 2 * THREE_LRS, name
        n_bad += int((err > 1e-6 + 1e-4 * want[name].abs()).sum())
        n_all += err.numel()
    # rtol 1e-4 / atol 1e-6 for every element but the ill-conditioned ones
    # described above: fewer than one in a thousand
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)


def test_three_adam_steps_match_jax_bf16(datasets, monkeypatch):
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")
    jlosses, tlosses, want, got = _three_steps(datasets, "bfloat16", 3)
    # bf16 tables round at other places in the two frameworks
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-2)
    # a bf16 rounding flips the sign of many a small gradient, and with it
    # the direction of Adam's step: twice the steps' learning rates at most
    for name in want:
        if name.startswith("bn.running"):  # not stepped: moments of the fingerprints
            torch.testing.assert_close(got[name], want[name], rtol=0.05, atol=0.01, msg=name)
        else:
            assert float((got[name] - want[name]).abs().max()) <= 2 * THREE_LRS, name


@pytest.mark.parametrize(
    "step", [0, 1, 7, 8, 9, 100, 199, 200, 5000], ids=lambda s: f"step{s}"
)
def test_schedule_matches_noam_lr_host(step):
    """At 0, in the warm-up, at its end, in the cool-down, at and past the end."""
    args = (8, 192, 1e-4, 1e-3, 1e-4)
    assert noam_lr(step, *args) == noam_lr_host(step, *args)
    assert noam_lr(step, 0, 0, 1e-4, 1e-3, 1e-4) == noam_lr_host(step, 0, 0, 1e-4, 1e-3, 1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_masked_batch_norm_matches_jax(masked):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 16)).astype(np.float32) * 3 + 1
    mask = np.ones(12, bool)
    if masked:
        mask[9:] = False
        x[9:] = 0  # padding graphs
    jbn = MaskedBatchNorm()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), False)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": variables["batch_stats"]}
    bn = BatchNorm(16)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
                       strict=False)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    for _ in range(2):  # two training steps: the running statistics move twice
        want, updates = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask), True,
                                  mutable=["batch_stats"])
        variables = {**variables, **updates}
        got = bn(xt, mt, is_training=True)
        # f32 on both sides
        np.testing.assert_allclose(got.detach().numpy()[mask], np.asarray(want)[mask],
                                   rtol=1e-5, atol=1e-5)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
    # evaluation: the running statistics, for every row
    want = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask), False)
    np.testing.assert_allclose(bn(xt, mt).detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # a prediction with batch statistics leaves the running ones alone
    before = bn.running_mean.clone()
    with torch.inference_mode():
        bn(xt, mt, is_training=True)
    assert torch.equal(bn.running_mean, before)


@pytest.mark.parametrize("case", ["plain", "nan_targets", "weights", "task_weights"])
def test_masked_weighted_mse_matches_jax(case):
    rng = np.random.default_rng(1)
    preds = rng.standard_normal((8, 3)).astype(np.float32)
    Y = rng.standard_normal((8, 3)).astype(np.float32)
    w = np.ones(8, np.float32)
    tw = [1.0, 1.0, 1.0]
    if case != "plain":
        Y[5:] = np.nan  # padding rows
        Y[1, 2] = np.nan  # a missing task
        w[5:] = 0
    if case == "weights":
        w[:5] = rng.uniform(0.5, 2.0, 5)
    if case == "task_weights":
        tw = [0.5, 1.0, 2.0]
    mask = np.isfinite(Y)
    want = JaxMSE(task_weights=tw)(jnp.asarray(preds), jnp.nan_to_num(jnp.asarray(Y)),
                                   jnp.asarray(mask), jnp.asarray(w))
    Yt = torch.from_numpy(Y)
    got = MSE(task_weights=tw)(torch.from_numpy(preds), torch.nan_to_num(Yt),
                               torch.isfinite(Yt), torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("case", ["columns", "constant_column", "nan"])
def test_standard_scaler_matches_sklearn(case):
    rng = np.random.default_rng(2)
    X = rng.standard_normal((50, 3)) * [1.0, 10.0, 0.1] + [0.0, 5.0, -3.0]
    if case == "constant_column":
        X[:, 1] = 7.25
    if case == "nan":
        X[3, 0] = np.nan
    want, got = SklearnScaler().fit(X), StandardScaler().fit(X)
    np.testing.assert_allclose(got.mean_, want.mean_, rtol=1e-12)
    np.testing.assert_allclose(got.scale_, want.scale_, rtol=1e-12)
    np.testing.assert_allclose(got.transform(X), want.transform(X), rtol=1e-10, atol=1e-12)
    Z = got.transform(X)
    np.testing.assert_allclose(got.inverse_transform(Z), X, rtol=1e-10, atol=1e-12)


def test_dataset_and_loader_match_jax(datasets):
    jds, tds = datasets
    np.testing.assert_allclose(tds.Y, jds.Y, rtol=1e-12)
    jloader = jdata.DataLoader(jds, batch_size=32, shuffle=True, seed=3, prefetch=0)
    tloader = DataLoader(tds, batch_size=32, shuffle=True, seed=3)
    assert len(tloader) == len(jloader) == 4 and tloader.emitted_order() is None
    for _ in range(2):  # two epochs: the reshuffles agree too
        for jb, tb in zip(jloader, tloader):
            for f in ("V", "E", "src", "dst", "rev", "batch"):
                np.testing.assert_array_equal(getattr(tb.bmg, f).numpy(), np.asarray(getattr(jb.bmg, f)))
            np.testing.assert_array_equal(tb.Y.numpy(), jb.Y)
            np.testing.assert_array_equal(tb.w.numpy(), jb.w)
            np.testing.assert_array_equal(tb.pad_mask, jb.pad_mask)
    last = list(DataLoader(tds, batch_size=32))[-1]
    assert last.bmg.n_graphs == 32 and last.pad_mask.sum() == 4
    assert np.isnan(last.Y.numpy()[4:]).all() and not last.w.numpy()[4:].any()
    assert len(DataLoader(tds, batch_size=32, drop_last=True)) == 3
    np.testing.assert_array_equal(DataLoader(tds, batch_size=32).emitted_order(), np.arange(100))
    tds.reset()
    assert not tds.cache and np.allclose(tds.Y, tds._Y)
    tds.normalize_targets()
    tds.cache = True


def test_seeded_sampler_matches_jax():
    a, b = SeededSampler(17, 5), jdata.samplers.SeededSampler(17, 5)
    assert [list(a), list(a)] == [list(b), list(b)] and len(a) == 17
    with pytest.raises(ValueError):
        SeededSampler(3, None)


def test_quick_train_smoke(datasets):
    """One epoch end to end: the loss is finite, predictions have the right shape."""
    _, tds = datasets
    loader = DataLoader(tds, batch_size=32, shuffle=True, seed=0)
    _, model = _models("float32", depth=2, batch_norm=False)
    trainer = Trainer(model, max_epochs=1, seed=0, device="cpu")
    trainer.fit(loader, val_loader=DataLoader(tds, batch_size=50))
    rec = trainer.history[-1]
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["val_loss"]) and rec["lr"] > 1e-4
    preds = trainer.predict(DataLoader(tds, batch_size=32))
    assert preds.shape == (100, 1) and np.isfinite(preds).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_overfit_small(datasets, dtype):
    """The overfit bar of tests/integration/test_regression_mol.py at d_h = 64
    and 30 epochs, to a looser bar (the full-width run is the card's)."""
    _, tds = datasets
    loader = DataLoader(tds, batch_size=32, shuffle=False)
    _, model = _models(dtype)
    trainer = Trainer(model, max_epochs=30, warmup_epochs=2, seed=12, device="cpu")
    trainer.fit(loader)
    losses = [h["train_loss"] for h in trainer.history]
    assert losses[-1] < 0.25 * losses[0]
    preds = trainer.predict(loader, use_batch_statistics=True)
    assert float(np.mean((preds[:, 0] - tds.Y[:, 0]) ** 2)) <= 0.2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_overfit_full_width(datasets, dtype):
    """The bar of tests/integration/test_regression_mol.py::test_overfit
    itself, at the default width (d_h = 300 padded to 384, depth 3): train
    MSE <= 0.05 with batch statistics after 50 epochs, <= 0.10 with the
    running ones."""
    _, tds = datasets
    model = MPNN(
        BondMessagePassing(compute_dtype=DTYPES[dtype][1]),
        MeanAggregation(),
        RegressionFFN(output_transform=False),
        batch_norm=True,
    )
    trainer = Trainer(model, max_epochs=50, warmup_epochs=2, seed=12, device="cpu")
    trainer.fit(DataLoader(tds, batch_size=32, shuffle=False))
    eval_loader = DataLoader(tds, batch_size=32)
    preds = trainer.predict(eval_loader, use_batch_statistics=True)
    assert float(np.mean((preds[:, 0] - tds.Y[:, 0]) ** 2)) <= 0.05
    preds = trainer.predict(eval_loader)
    assert float(np.mean((preds[:, 0] - tds.Y[:, 0]) ** 2)) <= 0.10


def test_fits_from_one_seed_are_identical(datasets):
    _, tds = datasets
    histories = []
    for _ in range(2):
        _, model = _models("bfloat16")
        trainer = Trainer(model, max_epochs=2, seed=7, grad_clip=1.0, device="cpu")
        trainer.fit(DataLoader(tds, batch_size=32, shuffle=True, seed=1))
        histories.append([h["train_loss"] for h in trainer.history])
    assert histories[0] == histories[1]


def test_grad_clip_is_optax_form(datasets):
    """``g * max_norm / |g|`` only when ``|g| > max_norm``: a huge limit
    changes nothing, a small one shrinks the first step's moments."""
    _, tds = datasets
    batch = next(iter(DataLoader(tds, batch_size=32)))
    mus = {}
    for clip in (None, 1e9, 1e-3):
        _, model = _models("float32")
        trainer = Trainer(model, seed=3, grad_clip=clip, device="cpu")
        trainer.init_state(batch, 4)
        trainer.train_step(batch)
        mus[clip] = torch.cat([m.flatten() for m in trainer.state.mu])
    assert torch.equal(mus[None], mus[1e9])
    norm = float(mus[None].norm()) / 0.1  # mu = (1 - b1) g after one step
    assert norm > 1e-3
    torch.testing.assert_close(mus[1e-3], mus[None] * (1e-3 / norm), rtol=1e-5, atol=1e-12)


def test_trainer_without_a_device_raises_here():
    _, model = _models("float32")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model)


def test_dropout_is_not_ported():
    with pytest.raises(NotImplementedError):
        BondMessagePassing(dropout=0.1)
