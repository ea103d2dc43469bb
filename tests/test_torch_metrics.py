"""The port's loss and metric zoo (``chemprop_tpu_torch/nn/metrics.py``)
against the JAX package's (``chemprop_tpu/nn/metrics.py``) on the CPU: the
registries and every class's arguments and defaults; every loss's and
streaming metric's value, and every loss's gradient against ``jax.grad``,
with masks, sample weights, task weights and ``lt`` / ``gt`` bounds, at the
clamps of the MVE and evidential losses; a validation streamed over two
batches; and the collected metrics (AUROC, AUPRC, F1, accuracy) against
the scikit-learn values JAX computes, with heavy ties and with one class.
Inputs are made with numpy from a seed; float32 on both sides, held to
rtol 1e-5 (atol 1e-6)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu.nn import metrics as jm
from chemprop_tpu_torch.nn import metrics as tm

B, T, C = 12, 3, 4
RTOL, ATOL = 1e-5, 1e-6

# the arguments each case builds the class with (both packages)
KWARGS = {
    "evidential": [{}, {"v_kl": 0.5, "eps": 1e-6}],
    "quantile": [{}, {"alpha": 0.2}],
    "quantile-point": [{}, {"alpha": 0.3}],
    "dirichlet": [{}, {"v_kl": 0.1}],
    "sid": [{}, {"threshold": 0.05}],
    "wasserstein": [{}, {"threshold": 0.05}],
    "binary-mcc": [{}, {"assume_logits": False}],
    "multiclass-mcc": [{"n_classes": C}, {"n_classes": C, "assume_logits": False}],
    "nlogprob_enrichment": [{}, {"method": "score", "n2": 2}, {"method": "wald", "zscale": 2.0}],
    "binned-roc": [{"n_bins": 64}],
    "binned-prc": [{"n_bins": 64}],
}
# every class once (an alias of a class named before is left out)
ALIASES = ("pinball", "pinball-point", "earthmovers")
LOSSES = sorted(a for a in jm.LossFunctionRegistry if a not in ALIASES)
METRICS = sorted(a for a, c in jm.MetricRegistry.items()
                 if not c.needs_collection and a not in ALIASES)


def _cls(pkg, kind, alias):
    return (pkg.LossFunctionRegistry if kind == "loss" else pkg.MetricRegistry)[alias]


def _inputs(alias: str, kwargs: dict, masked: bool, seed: int = 0):
    """(preds, targets, mask, weights, lt, gt, task weights) as float32 / bool
    numpy arrays for the metric ``alias``."""
    rng = np.random.default_rng(seed)
    t, shape = T, (B, T)
    targets = rng.standard_normal(shape)
    if alias in ("mve", "quantile"):
        preds = np.stack([rng.standard_normal(shape), rng.uniform(0.2, 2.0, shape)], -1)
        if alias == "mve":  # variances at and below the 1e-8 clamp
            preds[0, 0, 1], preds[1, 1, 1], preds[2, 2, 1] = 1e-8, 1e-9, -0.5
    elif alias == "evidential":
        preds = np.stack([rng.standard_normal(shape), rng.uniform(0.1, 2.0, shape),
                          rng.uniform(1.1, 3.0, shape), rng.uniform(0.1, 2.0, shape)], -1)
        preds[0, 0, 1], preds[1, 1, 1], preds[2, 2, 1] = 1e-8, 1e-9, -0.5  # v at the clamp
    elif alias in ("ce", "multiclass-mcc", "dirichlet"):
        n = kwargs.get("n_classes", C) if alias != "dirichlet" else C
        preds = rng.standard_normal((*shape, n)) * 2
        if alias == "dirichlet":
            preds = np.log1p(np.exp(preds)) + 1  # Dirichlet alphas
        elif not kwargs.get("assume_logits", True):
            preds = np.exp(preds) / np.exp(preds).sum(-1, keepdims=True)
        targets = rng.integers(0, n, shape).astype(float)
    elif alias in ("bce", "binary-mcc", "binned-roc", "binned-prc"):
        preds = rng.standard_normal(shape) * 2
        if alias.startswith("binned") or not kwargs.get("assume_logits", True):
            preds = 1 / (1 + np.exp(-preds))
        preds[0, 0] = 0.0  # a tie in BCE's max(x, 0)
        targets = (rng.uniform(size=shape) > 0.5).astype(float)
    elif alias in ("sid", "wasserstein", "earthmovers"):
        t, shape = 6, (B, 6)
        preds = rng.uniform(0.01, 1.0, shape)
        targets = rng.uniform(0.01, 1.0, shape)
        targets /= targets.sum(1, keepdims=True)
    elif alias == "nlogprob_enrichment":
        # counts whose ratio the rate R / (n2 / n1) nearly matches: the z
        # statistic stays below ~2.5, where 1 - erf(z / sqrt 2) does not
        # cancel in f32 (further out both packages' values carry the last-bit
        # error of their erf, divided by a tail probability of 1e-6)
        t, shape = 2, (B, 2)
        targets = rng.integers(5, 20, shape).astype(float)
        d = kwargs.get("n2", 1) / kwargs.get("n1", 1)
        preds = d * targets[:, :1] / targets[:, 1:] * rng.uniform(0.8, 1.25, (B, 1))
    else:
        preds = rng.standard_normal(shape)
    mask = np.ones(shape, bool)
    weights = np.ones(B)
    lt = gt = np.zeros(shape, bool)
    tw = np.ones(t)
    if masked:
        mask = rng.uniform(size=shape) > 0.25
        mask[-2:] = False  # padding rows
        weights = rng.uniform(0.5, 2.0, B)
        weights[-2:] = 0
        tw = rng.uniform(0.5, 2.0, t)
        bound = rng.uniform(size=shape)
        lt, gt = bound < 0.3, bound > 0.7
        if alias != "nlogprob_enrichment":  # its z statistic is kept moderate
            targets = np.where(mask, targets, 0.0)  # nan_to_num of the missing ones
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f32(preds), f32(targets), mask, f32(weights), lt, gt, f32(tw)


def _cases(kind, aliases):
    """Every alias with each of its arguments, masked (random masks, sample
    and task weights, bounds; no mask at all is the case of all ones)."""
    return [(kind, a, i, True) for a in aliases for i in range(len(KWARGS.get(a, [{}])))]


def _ids(case):
    _, a, i, masked = case
    return f"{a}-{i}-{'masked' if masked else 'plain'}"


def _both(kind, alias, i, masked):
    kwargs = KWARGS.get(alias, [{}])[i]
    preds, targets, mask, w, lt, gt, tw = _inputs(alias, kwargs, masked)
    if "n_bins" not in kwargs and alias != "r2":
        kwargs = {**kwargs, "task_weights": tw.tolist()}
    jmetric, tmetric = _cls(jm, kind, alias)(**kwargs), _cls(tm, kind, alias)(**kwargs)
    jargs = tuple(map(jnp.asarray, (targets, mask, w, lt, gt)))
    targs = tuple(map(torch.from_numpy, (targets, mask, w, lt, gt)))
    return jmetric, tmetric, preds, jargs, targs


def test_registries_and_defaults_match_jax():
    for pkg_reg, port_reg in ((jm.LossFunctionRegistry, tm.LossFunctionRegistry),
                              (jm.MetricRegistry, tm.MetricRegistry)):
        assert set(port_reg) == set(pkg_reg)
        for alias, jcls in pkg_reg.items():
            tcls = port_reg[alias]
            assert tcls.__name__ == jcls.__name__ and tcls.alias == jcls.alias, alias
            jf = {f.name: (f.default, f.init) for f in dataclasses.fields(jcls)}
            tf = {f.name: (f.default, f.init) for f in dataclasses.fields(tcls)}
            assert tf == jf, alias
            for attr in ("higher_is_better", "needs_collection"):
                assert getattr(tcls(), attr) == getattr(jcls(), attr), (alias, attr)


@pytest.mark.parametrize("case", _cases("loss", LOSSES), ids=_ids)
def test_loss_and_gradient_match_jax(case):
    jmetric, tmetric, preds, jargs, targs = _both(*case)
    value, grad = jax.jit(jax.value_and_grad(lambda p, a: jmetric(p, *a)))(jnp.asarray(preds),
                                                                           jargs)
    x = torch.from_numpy(preds).requires_grad_()
    got = tmetric(x, *targs)
    got.backward()
    assert got.dtype == torch.float32 and np.isfinite(np.asarray(grad)).all()
    np.testing.assert_allclose(float(got.detach()), float(value), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", _cases("metric", METRICS), ids=_ids)
def test_metric_value_matches_jax(case):
    jmetric, tmetric, preds, jargs, targs = _both(*case)
    want = float(jax.jit(lambda p, a: jmetric(p, *a))(jnp.asarray(preds), jargs))
    got = tmetric(torch.from_numpy(preds), *targs)
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind,alias", [("loss", a) for a in LOSSES] + [
    ("metric", a) for a in METRICS])
def test_streamed_over_two_batches_matches_jax(kind, alias):
    """A validation over two batches: the states add up as JAX's do (the MCC
    variants per task)."""
    kwargs = KWARGS.get(alias, [{}])[0]
    jmetric, tmetric = _cls(jm, kind, alias)(**kwargs), _cls(tm, kind, alias)(**kwargs)
    jstate, tstate = jmetric.init_state(), tmetric.init_state()
    for seed in (1, 2):
        p, y, m, w, lt, gt, _ = _inputs(alias, kwargs, True, seed)
        jstate = jmetric.update_state(jstate, *map(jnp.asarray, (p, y, m, w, lt, gt)))
        tstate = tmetric.update_state(tstate, *map(torch.from_numpy, (p, y, m, w, lt, gt)))
    for key in jstate:
        np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]), rtol=RTOL,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(tmetric.compute(tstate)), float(jmetric.compute(jstate)),
                               rtol=RTOL, atol=ATOL)


def test_multiclass_mcc_keeps_per_task_counts():
    p, y, m, w, lt, gt, _ = _inputs("multiclass-mcc", {"n_classes": C}, True)
    state = tm.MulticlassMCCMetric(n_classes=C).update_state(
        tm.MulticlassMCCMetric(n_classes=C).init_state(), *map(torch.from_numpy, (p, y, m, w, lt, gt)))
    assert state["p"].shape == state["t"].shape == (T, C)
    assert state["c"].shape == state["s"].shape == (T,)


def test_bounded_losses_clamp_satisfied_bounds():
    preds = torch.tensor([[0.0, 2.0, 5.0]])
    targets = torch.tensor([[1.0, 1.0, 1.0]])
    lt = torch.tensor([[True, True, False]])  # "<1": 0 satisfies it, 2 does not
    gt = torch.tensor([[False, False, True]])  # ">1": 5 satisfies it
    got = tm.BoundedMSE()(preds, targets, lt_mask=lt, gt_mask=gt)
    assert float(got) == pytest.approx(1.0 / 3)  # only the 2 counts: (2 - 1)^2 / 3


# ------------------------------------------------------- collected metrics
COLLECTED = ["roc", "prc", "f1", "accuracy"]


def _scores(seed: int, n: int = 300, ties: bool = True):
    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=(n, 2)) > 0.6).astype(np.float32)
    s = np.clip(0.3 * y + rng.uniform(size=(n, 2)) * 0.8, 0, 1).astype(np.float32)
    if ties:  # a few distinct scores: many ties across both classes
        s = np.round(s * 8) / 8
    Y = np.where(rng.uniform(size=(n, 2)) < 0.15, np.nan, y)
    return s, Y, np.isfinite(Y)


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "distinct"])
@pytest.mark.parametrize("alias", COLLECTED)
def test_collected_metric_matches_sklearn(alias, ties):
    for seed in range(3):
        s, Y, mask = _scores(seed, ties=ties)
        want = jm.MetricRegistry[alias]().compute_from_arrays(s, Y, mask)
        got = tm.MetricRegistry[alias]().compute_from_arrays(s, Y, mask)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_curves_of_all_tied_and_perfect_scores():
    y = np.array([0, 1, 0, 1, 1], np.float32)
    mask = np.ones(5, bool)
    for s in (np.full(5, 0.5, np.float32), y.copy(), 1 - y):
        for alias in ("roc", "prc"):
            want = jm.MetricRegistry[alias]().compute_from_arrays(s, y, mask)
            got = tm.MetricRegistry[alias]().compute_from_arrays(s, y, mask)
            np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("cls", [0.0, 1.0])
def test_one_class(cls):
    """AUROC of one class raises (scikit-learn's error; since 1.8 it warns and
    gives NaN, which a fit records for the failed metric all the same).
    Average precision, F1 and accuracy have scikit-learn's values."""
    s = np.array([0.2, 0.7, 0.7, 0.9], np.float32)
    y = np.full(4, cls, np.float32)
    mask = np.ones(4, bool)
    with pytest.raises(ValueError, match="one class"):
        tm.BinaryAUROC().compute_from_arrays(s, y, mask)
    try:
        want = jm.BinaryAUROC().compute_from_arrays(s, y, mask)
    except ValueError:
        want = float("nan")
    assert np.isnan(want)
    for alias in ("prc", "f1", "accuracy"):
        want = jm.MetricRegistry[alias]().compute_from_arrays(s, y, mask)
        got = tm.MetricRegistry[alias]().compute_from_arrays(s, y, mask)
        assert got == pytest.approx(want, abs=1e-12), alias


def test_binned_curves_approach_the_exact_ones():
    s, Y, mask = _scores(4, ties=False)
    targets = np.nan_to_num(Y)
    for binned, exact in (("binned-roc", "roc"), ("binned-prc", "prc")):
        metric = tm.MetricRegistry[binned]()
        state = metric.update_state(metric.init_state(), torch.from_numpy(s),
                                    torch.from_numpy(targets), torch.from_numpy(mask),
                                    torch.ones(len(s)), None, None)
        want = tm.MetricRegistry[exact]().compute_from_arrays(s, Y, mask)
        assert float(metric.compute(state)) == pytest.approx(want, abs=2e-3)
