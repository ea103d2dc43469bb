"""Dropout in the port: the per-iteration path with dropout 0.2 against the
JAX package, forward and three Adam steps (the comparisons of
test_torch_per_iteration.py, whose helpers this file shares), and the port's
own rules for its dropout.

Dropout draws from other generators in the two packages, so the JAX module's
masks are carried across: ``jax.random.bernoulli`` is recorded while the JAX
step runs eagerly, and the port's ``dropout_mask`` hands the same masks out
in the same order."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu import data as jdata
from chemprop_tpu_torch.data import DataLoader
from chemprop_tpu_torch.models import MPNN, from_jax_params
from chemprop_tpu_torch.models.load import build_model, load_checkpoint
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.nn.utils import Dropout, get_activation_function
from chemprop_tpu_torch.ops import KernelOptions, message, sorted_segment_sum
from chemprop_tpu_torch.train import Trainer
from test_torch_per_iteration import (  # noqa: F401  (fixtures)
    D_H,
    DROPOUT_VARIANTS,
    _models,
    check_message_passing_forward,
    check_three_adam_steps,
    datasets,
    one_torch_thread,
    per_iteration_jax,
)


@pytest.mark.parametrize("variant", DROPOUT_VARIANTS)
def test_three_adam_steps_match_jax(datasets, per_iteration_jax, monkeypatch, variant):
    check_three_adam_steps(datasets, monkeypatch, *DROPOUT_VARIANTS[variant])


@pytest.mark.parametrize("variant", DROPOUT_VARIANTS)
def test_message_passing_forward_matches_jax(datasets, per_iteration_jax, monkeypatch, variant):
    check_message_passing_forward(datasets, monkeypatch, *DROPOUT_VARIANTS[variant])


# ------------------------------------------------- the port's dropout, alone
@pytest.fixture(scope="module")
def batch(datasets):
    return next(iter(DataLoader(datasets[1], batch_size=32, shuffle=False)))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _mp(dtype=torch.float32, **kwargs):
    mp = BondMessagePassing(d_h=D_H, compute_dtype=dtype, **kwargs)
    g = _gen(3)
    with torch.no_grad():
        for p in mp.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return mp


def test_dropout_keeps_its_share_and_scales():
    x = torch.ones(400, 500)
    y = Dropout(0.2)(x, True, _gen())
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 5e-3  # 4 sigma of 2e5 draws is 3.6e-3
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.8))
    assert torch.equal(Dropout(0.2)(x, False, None), x)  # off: the input itself
    assert torch.equal(Dropout(0.0)(x, True, None), x)  # rate 0 draws nothing
    with pytest.raises(ValueError):
        Dropout(0.2)(x, True, None)  # no generator: the global one is never used
    with pytest.raises(ValueError):
        Dropout(1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_path_equals_composed_path_under_one_generator(batch, dtype):
    """The per-iteration ops with their hand-written backwards against the
    same model composed from ``message`` and library products through
    autograd, drawing the same masks."""
    tb = batch.bmg
    mp = _mp(dtype, dropout=0.2, bias=True)
    params = list(mp.parameters())
    out = mp(tb, is_training=True, generator=_gen(5))
    c = torch.randn(out.shape, generator=_gen(6)).to(dtype) * tb.node_mask[:, None]
    got = torch.autograd.grad(out, params, c)

    def composed(gen):
        dp = mp.d_pad
        W_i, b_i = mp._padded(mp.W_i, mp.d_v + mp.d_e, dp)
        W_h, b_h = mp._padded(mp.W_h, dp, dp)
        W_o, b_o = mp._padded(mp.W_o, mp.d_v + dp, dp)
        H0 = torch.cat([tb.V.to(dtype)[tb.src.long()], tb.E.to(dtype)], 1) @ W_i + b_i
        H = torch.relu(H0)
        for _ in range(1, mp.depth):
            z = message(H, tb.src, tb.dst, tb.rev, tb.edge_ptr) @ W_h + b_h
            H = mp.drop(torch.relu(H0 + z), True, gen)
        M_v = sorted_segment_sum(H, tb.dst, tb.edge_ptr)
        return mp.drop(torch.relu(torch.cat([tb.V.to(dtype), M_v], 1) @ W_o + b_o), True, gen)

    ref = composed(_gen(5))
    want = torch.autograd.grad(ref, params, c)
    real = tb.node_mask
    if dtype == torch.float32:
        torch.testing.assert_close(out[real], ref[real], rtol=1e-5, atol=1e-5)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5 * float(w.abs().max()))
    else:
        # the fused iteration rounds the message and y once each, the composed
        # path after every op, and a value one ulp apart near zero flips a
        # ReLU mask downstream: errors are held against each table's scale
        torch.testing.assert_close(out[real].float(), ref[real].float(), rtol=0.05, atol=0.05)
        for a, w in zip(got, want):
            err, scale = (a - w).abs(), float(w.abs().max())
            assert float(err.max()) <= 0.15 * scale and float(err.mean()) <= 0.02 * scale


def test_rate_zero_equals_no_dropout_and_takes_the_fused_readout(batch):
    tb = batch.bmg
    mp0, mp = _mp(dropout=0.0), _mp()
    a = mp0(tb, is_training=True, generator=None)
    assert torch.equal(a, mp(tb, is_training=True)) and torch.equal(a, mp(tb))
    # with a rate, evaluation draws nothing and equals the model without
    mpd = _mp(dropout=0.3)
    assert torch.equal(mpd(tb), a) and torch.equal(mpd(tb, generator=_gen(9)), a)
    assert not torch.equal(mpd(tb, is_training=True, generator=_gen(9)), a)
    # Monte-Carlo dropout turns the same layers on as training does
    assert torch.equal(mpd(tb, mc_dropout=True, generator=_gen(9)),
                       mpd(tb, is_training=True, generator=_gen(9)))


def _trainer(dropout, seed=12, **options):
    model = MPNN(
        BondMessagePassing(d_h=D_H, dropout=dropout, kernel_options=KernelOptions(**options)),
        MeanAggregation(),
        RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False, dropout=dropout),
        batch_norm=True,
    )
    return Trainer(model, max_epochs=3, warmup_epochs=1, seed=seed, device="cpu")


def test_same_seed_same_fit_and_evaluation_ignores_the_generator(datasets):
    tds = datasets[1]
    fits = []
    for seed in (12, 12, 13):
        trainer = _trainer(0.2, seed)
        trainer.fit(DataLoader(tds, batch_size=32, shuffle=True, seed=3))
        fits.append((trainer, [h["train_loss"] for h in trainer.history]))
    assert fits[0][1] == fits[1][1] and fits[0][1] != fits[2][1]
    trainer = fits[0][0]
    loader = DataLoader(tds, batch_size=32)
    preds, val = trainer.predict(loader), trainer.evaluate(loader)
    trainer.state.rng.manual_seed(99)  # the training generator is not evaluation's business
    assert np.array_equal(preds, trainer.predict(loader)) and val == trainer.evaluate(loader)
    # batch statistics turn dropout on too, with masks from a fixed seed
    a = trainer.predict(loader, use_batch_statistics=True)
    assert np.array_equal(a, trainer.predict(loader, use_batch_statistics=True))
    assert not np.array_equal(a, preds)


def test_predict_mc_dropout_mean_and_spread(datasets):
    tds = datasets[1]
    trainer = _trainer(0.2)
    trainer.max_epochs = 10
    trainer.fit(DataLoader(tds, batch_size=32, shuffle=True, seed=3))
    loader = DataLoader(tds, batch_size=32)
    mc = trainer.predict_mc_dropout(loader, sampling_size=16, seed=4)
    preds = trainer.predict(loader)
    assert mc.shape == (16, len(tds), 1) and np.isfinite(mc).all()
    assert np.array_equal(mc, trainer.predict_mc_dropout(loader, sampling_size=16, seed=4))
    assert not np.array_equal(mc, trainer.predict_mc_dropout(loader, sampling_size=16, seed=5))
    spread = mc.std(axis=0)
    assert (spread > 0).all() and spread.mean() < 1.0  # targets have unit spread
    # the samples scatter around the deterministic prediction
    assert np.sqrt(np.mean((mc.mean(axis=0) - preds) ** 2)) < 3 * spread.mean()
    # without dropout every sample is the prediction
    plain = _trainer(0.0)
    plain.fit(DataLoader(tds, batch_size=32))
    mc0 = plain.predict_mc_dropout(loader, sampling_size=2)
    assert np.array_equal(mc0[0], plain.predict(loader)) and np.array_equal(mc0[0], mc0[1])


@pytest.mark.parametrize("options", [dict(fused_bwd=True), dict(grad_w=True), dict(iter2=True),
                                     dict(fused_readout=False)], ids=lambda o: next(iter(o)))
def test_options_leave_the_float32_fit_unchanged(datasets, options):
    """The opt-in kernels are bfloat16's; ``fused_readout`` off takes the
    per-iteration ops, whose float32 chain is the same arithmetic."""
    tds = datasets[1]
    losses = []
    for opts in ({}, options):
        trainer = _trainer(0.0, **opts)
        trainer.fit(DataLoader(tds, batch_size=32))
        losses.append([h["train_loss"] for h in trainer.history])
    if "fused_readout" in options:  # the running dH0 is added in another place
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    else:
        assert losses[0] == losses[1]


def test_kernel_options_read_the_jax_package_s_variables(monkeypatch):
    for name in ("ITER2", "FUSED_BWD", "GRAD_W", "FUSED_READOUT"):
        monkeypatch.delenv(f"CHEMPROP_TPU_{name}", raising=False)
    assert KernelOptions.from_env() == KernelOptions() == KernelOptions(False, False, False, True)
    monkeypatch.setenv("CHEMPROP_TPU_ITER2", "1")
    monkeypatch.setenv("CHEMPROP_TPU_GRAD_W", "1")
    monkeypatch.setenv("CHEMPROP_TPU_FUSED_READOUT", "0")
    want = KernelOptions(iter2=True, grad_w=True, fused_readout=False)
    assert KernelOptions.from_env() == want
    assert BondMessagePassing().kernel_options == want  # read once, at construction
    monkeypatch.setenv("CHEMPROP_TPU_FUSED_BWD", "1")
    assert BondMessagePassing(kernel_options=KernelOptions()).kernel_options == KernelOptions()


@pytest.mark.parametrize("name", ["relu", "leakyrelu", "prelu", "tanh", "elu", "gelu", "silu",
                                  "softplus"])
def test_activations_match_jax(name):
    from chemprop_tpu.nn.utils import get_activation_function as jax_activation

    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jax_activation(name)(jnp.asarray(x)))
    got = get_activation_function(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("hp", [dict(dropout=0.25), dict(undirected=True), dict(bias=False)],
                         ids=lambda h: next(iter(h)))
def test_reference_checkpoint_hyperparameters_load(data_dir, batch, hp):
    d = load_checkpoint(data_dir / "example_model_v2_regression_mol.pt")
    hyper = dict(d["hyper_parameters"])
    hyper["message_passing"] = {**hyper["message_passing"], **hp}
    hyper["predictor"] = {**hyper["predictor"], **{k: v for k, v in hp.items() if k == "dropout"}}
    skip = ("num_batches_tracked", "criterion", "metrics")
    sd = {k: v.float() for k, v in d["state_dict"].items()
          if not any(part in skip for part in k.split("."))}
    model = build_model(hyper, sd)
    model.load_state_dict(sd)
    mp = model.message_passing
    assert mp.dropout == hp.get("dropout", 0.0) and mp.undirected == hp.get("undirected", False)
    assert model.predictor.ffn[1][1].rate == hp.get("dropout", 0.0)
    out = model.eval()(batch.bmg)
    assert out.shape == (batch.bmg.n_graphs, 1) and torch.isfinite(out).all()
    # what the port does not run is refused (atom descriptors and atom message
    # passing load since they were ported: tests/test_torch_extra_features.py,
    # tests/test_torch_atom_messages.py)
    hyper["message_passing"]["cls"] = type("MABBondMessagePassing", (), {})
    with pytest.raises(ValueError):
        build_model(hyper, sd)


def test_from_jax_params_with_bias(datasets):
    jds, tds = datasets
    jmodel, model = _models(dict(bias=True), "float32", KernelOptions())
    jbatch = next(iter(jdata.DataLoader(jds, batch_size=32, shuffle=False, prefetch=0)))
    tbatch = next(iter(DataLoader(tds, batch_size=32, shuffle=False)))
    variables = jmodel.init(jax.random.PRNGKey(2), jbatch.bmg, None, None, False)
    variables = jax.tree_util.tree_map(lambda x: x + 0.05 if x.ndim == 1 else x, variables)
    sd = from_jax_params(variables["params"], variables["batch_stats"])
    assert {"message_passing.W_i.bias", "message_passing.W_h.bias"} <= set(sd)
    model.load_state_dict(sd)
    want = np.asarray(jmodel.apply(variables, jbatch.bmg, None, None, False))
    got = model.eval()(tbatch.bmg).detach().numpy()
    real = tbatch.pad_mask
    np.testing.assert_allclose(got[real], want[real], rtol=1e-4, atol=1e-5)
