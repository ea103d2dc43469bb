"""The port's uncertainty package (``chemprop_tpu_torch.uncertainty``) against
the JAX package's, module by module: the goldens of
tests/unit/uncertainty/test_calibrator_parity.py and
test_evaluator_parity.py repeated against the port's classes with their
values and tolerances; every estimator, calibrator and evaluator against
the JAX class on the same seeded arrays (masked entries and ties
included) at rtol 1e-6 / atol 1e-7; the port's isotonic fit against
scikit-learn's at atol 1e-12."""

from __future__ import annotations

import numpy as np
import numpy.testing as npt
import pytest
from sklearn.isotonic import IsotonicRegression as SkIsotonic

import chemprop_tpu.uncertainty as ju
import chemprop_tpu_torch.uncertainty as tu

# ------------------------------------------------------------------ goldens
N = np.arange(1, 101, dtype=np.float64)[:, None]
ONES_MASK = np.ones((100, 1), dtype=bool)
ZEROS = np.zeros((100, 1))
CLS_UNCS = np.array([[0.1, 0.2, 0.3], [0.4, 0.5, 0.6], [0.7, 0.8, 0.9],
                     [0.1, 0.2, 0.3], [0.4, 0.5, 0.6], [0.7, 0.8, 0.9]])
CLS_TARGETS = np.array([[0, 1, 0], [0, 0, 1], [0, 1, 1], [1, 1, 0], [1, 0, 0], [1, 1, 0]])
CLS_MASK = np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1], [1, 1, 1], [0, 1, 1], [1, 1, 1]],
                    dtype=bool)
CLS_TEST = np.array([[0.1, 0.2, 0.3], [0.4, 0.5, 0.6]])
MC_CAL_UNCS = np.array([[[0.2, 0.3, 0.5], [0.1, 0.6, 0.3]],
                        [[0.1, 0.6, 0.3], [0.4, 0.4, 0.2]],
                        [[0.4, 0.4, 0.2], [0.2, 0.3, 0.5]]])
MC_TEST_UNCS = np.array([[[0.3, 0.4, 0.3], [0.5, 0.2, 0.3]],
                         [[0.5, 0.2, 0.3], [0.6, 0.3, 0.1]],
                         [[0.6, 0.3, 0.1], [0.3, 0.4, 0.3]]])


def test_isotonic_golden():
    out = tu.IsotonicCalibrator().fit(CLS_UNCS, CLS_UNCS, CLS_TARGETS, CLS_MASK).apply(CLS_TEST)
    npt.assert_allclose(out, [[1 / 3, 2 / 3, 0.0], [1 / 3, 2 / 3, 0.5]], atol=1e-7)


@pytest.mark.parametrize("training_targets,want", [
    (None, [[0.4182101, 0.8000248, 0.1312900], [0.3973791, 0.7999378, 0.2770228]]),
    (np.array([[0, 0, 0], [1, 1, 1], [1, 1, 0], [1, 0, 1]]),
     [[0.5285367, 0.6499191, 0.3089508], [0.5188822, 0.6499544, 0.3998689]]),
], ids=["plain", "bayes_correction"])
def test_platt_golden(training_targets, want):
    cal = tu.PlattCalibrator().fit(CLS_UNCS, CLS_UNCS, CLS_TARGETS, CLS_MASK,
                                   training_targets=training_targets)
    npt.assert_allclose(cal.apply(CLS_TEST), want, rtol=1e-3, atol=1e-4)


def test_platt_rejects_non_binary_targets():
    with pytest.raises(ValueError, match="0/1"):
        tu.PlattCalibrator().fit(CLS_UNCS, CLS_UNCS, CLS_TARGETS + 0.5, CLS_MASK)


@pytest.mark.parametrize("cal_uncs,expected_scale", [(N**2, 1.0), ((2 * N) ** 2, 0.25)])
def test_zscaling_golden(cal_uncs, expected_scale):
    out = tu.ZScalingCalibrator().fit(ZEROS, cal_uncs, N, ONES_MASK).apply(N)
    npt.assert_allclose(out, N * expected_scale, rtol=1e-4)


@pytest.mark.parametrize("cal_uncs,expected", [(N**2, N), (np.ones((100, 1)), N * 8100.0)])
def test_zelikman_golden(cal_uncs, expected):
    out = tu.ZelikmanCalibrator(p=0.9).fit(ZEROS, cal_uncs, N, ONES_MASK).apply(N)
    npt.assert_allclose(out, expected, rtol=1e-6)


@pytest.mark.parametrize("cls", [tu.ZelikmanCalibrator, tu.ConformalRegressionCalibrator,
                                 tu.ConformalMultilabelCalibrator,
                                 tu.MulticlassConformalCalibrator])
def test_bad_rates_are_refused(cls):
    with pytest.raises(ValueError):
        cls(1.5)


def test_mve_weighting_golden():
    uncs5 = np.broadcast_to(N, (5, 100, 1)).copy()
    cal = tu.MVEWeightingCalibrator().fit(ZEROS, uncs5, N, ONES_MASK)
    npt.assert_allclose(cal.apply(uncs5), N, rtol=1e-6)
    npt.assert_allclose(cal.weights.sum(axis=0), 1.0, rtol=1e-9)


@pytest.mark.parametrize("cal_uncs,test_uncs,expected", [
    (np.arange(100, dtype=np.float64)[:, None] / 20,
     np.arange(100, 200, dtype=np.float64)[:, None] / 20, np.arange(14.6, 19.55, 0.05)[:, None]),
    (np.zeros((100, 1)), np.zeros((100, 1)), np.full((100, 1), 10.0)),
], ids=["intervals", "points"])
def test_conformal_regression_golden(cal_uncs, test_uncs, expected):
    preds = np.arange(100, dtype=np.float64)[:, None]
    targets = np.arange(10, 110, dtype=np.float64)[:, None]
    cal = tu.ConformalRegressionCalibrator(alpha=0.1).fit(preds, cal_uncs, targets, ONES_MASK)
    npt.assert_allclose(cal.apply(test_uncs), expected, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("cls,targets,want", [
    (tu.MulticlassConformalCalibrator, [[2, 2], [1, 0], [0, 2]],
     [[[0, 1, 0], [1, 0, 1]], [[1, 0, 0], [1, 1, 0]], [[1, 0, 0], [1, 1, 1]]]),
    (tu.AdaptiveMulticlassConformalCalibrator, [[2, 1], [1, 0], [0, 2]],
     [[[0, 1, 0], [1, 0, 0]], [[1, 0, 0], [1, 0, 0]], [[1, 0, 0], [0, 1, 0]]]),
], ids=["multiclass", "adaptive"])
def test_multiclass_conformal_golden(cls, targets, want):
    cal = cls(alpha=0.5).fit(MC_CAL_UNCS, MC_CAL_UNCS, np.array(targets),
                             np.ones((3, 2), dtype=bool))
    npt.assert_array_equal(cal.apply(MC_TEST_UNCS), want)


def test_multilabel_conformal_golden():
    uncs = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 1]], dtype=np.float64)
    cal = tu.ConformalMultilabelCalibrator(alpha=0.1).fit(uncs, uncs, uncs.astype(int),
                                                          np.ones((3, 3), dtype=bool))
    npt.assert_array_equal(cal.apply(np.eye(3)), [[[1, 1], [1, 0], [1, 0]],
                                                  [[1, 0], [1, 1], [1, 0]],
                                                  [[1, 0], [1, 0], [1, 1]]])


def test_isotonic_multiclass_golden():
    cal_uncs = np.array([[[0.2, 0.3, 0.5], [0.1, 0.6, 0.3]], [[0.1, 0.6, 0.3], [0.4, 0.4, 0.2]],
                         [[0.4, 0.4, 0.2], [0.2, 0.3, 0.5]], [[0.0, 0.6, 0.4], [0.8, 0.1, 0.1]],
                         [[0.5, 0.2, 0.3], [0.4, 0.4, 0.2]], [[0.4, 0.3, 0.3], [0.7, 0.3, 0.0]]])
    targets = np.array([[2, 1], [1, 2], [0, 2], [1, 1], [0, 0], [2, 0]])
    test_uncs = np.array([[[0.0, 0.1, 0.9], [0.5, 0.2, 0.3]], [[0.3, 0.4, 0.3], [0.6, 0.3, 0.1]],
                          [[0.9, 0.1, 0.0], [0.3, 0.4, 0.3]]])
    cal = tu.IsotonicMulticlassCalibrator().fit(cal_uncs, cal_uncs, targets,
                                                np.ones((6, 2), dtype=bool))
    npt.assert_allclose(cal.apply(test_uncs), [
        [[0.000000, 0.000000, 1.000000], [0.483871, 0.193548, 0.322581]],
        [[0.500000, 0.000000, 0.500000], [0.714286, 0.285714, 0.000000]],
        [[1.000000, 0.000000, 0.000000], [0.319149, 0.255319, 0.425532]]], atol=1e-5)


@pytest.mark.parametrize("targets,likelihood", [(np.ones((1, 1)), 0.8), (np.zeros((1, 1)), 0.2)])
def test_nll_classification_golden(targets, likelihood):
    uncs = np.array([[0.8]])
    nll = tu.NLLClassEvaluator().evaluate(uncs, uncs, targets, np.ones((1, 1), bool))
    npt.assert_allclose(np.exp(-nll), [likelihood], rtol=1e-6)


@pytest.mark.parametrize("uncs,targets,likelihood", [
    (np.array([[[0.29, 0.22, 0.49]], [[0.35, 0.19, 0.46]], [[0.55, 0.38, 0.07]],
               [[0.15, 0.29, 0.56]], [[0.08, 0.68, 0.24]]]),
     np.array([[0], [2], [2], [0], [1]]), 0.24875443),
    (np.array([[[8.7385e-01, 8.3770e-04, 3.3212e-02, 9.2103e-02]],
               [[7.2274e-03, 1.0541e-01, 8.8703e-01, 3.2886e-04]],
               [[1.7376e-03, 9.9478e-01, 1.4227e-03, 2.0596e-03]],
               [[2.6487e-04, 1.3251e-03, 2.4325e-02, 9.7409e-01]]]),
     np.array([[0], [2], [1], [3]]), 0.93094635),
], ids=["three_classes", "four_classes"])
def test_nll_multiclass_golden(uncs, targets, likelihood):
    nll = tu.NLLMulticlassEvaluator().evaluate(uncs, uncs, targets, np.ones(targets.shape, bool))
    npt.assert_allclose(np.exp(-nll), [likelihood], rtol=1e-5)


def test_nll_regression_golden():
    nll = tu.NLLRegressionEvaluator().evaluate(np.zeros((2, 2)), np.ones((2, 2)),
                                               np.zeros((2, 2)), np.ones((2, 2), bool))
    npt.assert_allclose(np.exp(-nll), [0.39894228, 0.39894228], rtol=1e-6)


@pytest.mark.parametrize("sign,rho", [(1.0, 1.0), (-1.0, -1.0)])
def test_spearman_golden(sign, rho):
    out = tu.SpearmanEvaluator().evaluate(np.zeros((100, 1)), sign * N, N, ONES_MASK)
    npt.assert_allclose(out, [rho], atol=1e-12)


def test_conformal_coverage_goldens():
    uncs = np.array([[[1, 0], [0, 1]], [[0, 1], [1, 0]], [[1, 0], [1, 0]]])
    targets = np.array([[0, 0], [1, 0], [1, 1]])
    out = tu.MulticlassConformalEvaluator().evaluate(None, uncs, targets, np.ones((3, 2), bool))
    npt.assert_allclose(out, [2 / 3, 1 / 3], rtol=1e-4)
    uncs = np.array([[0, 0, 0, 0], [0, 1, 1, 1], [0, 0, 0, 0]]).reshape(3, 2, 2)
    out = tu.MultilabelConformalEvaluator().evaluate(None, uncs, targets, np.ones((3, 2), bool))
    npt.assert_allclose(out, [2 / 3, 1 / 3], rtol=1e-4)


@pytest.mark.parametrize("preds,uncs,targets,coverage", [
    (np.arange(100, dtype=np.float64)[:, None], np.arange(100, dtype=np.float64)[:, None] / 2,
     np.arange(10, 110, dtype=np.float64)[:, None], [0.8]),
    (np.array([[0, 0.3, 1.0]]), np.array([[0.2, 0.3, 0.4]]), np.array([[0.5, 0.5, 0.5]]),
     [0.0, 1.0, 0.0]),
    (np.arange(100, 0, -1, dtype=np.float64)[:, None], np.full((100, 1), 70.0),
     np.arange(1, 101, dtype=np.float64)[:, None], [0.7]),
], ids=["widening", "three_tasks", "constant"])
def test_regression_conformal_coverage_golden(preds, uncs, targets, coverage):
    out = tu.RegressionConformalEvaluator().evaluate(preds, uncs, targets,
                                                     np.ones(preds.shape, bool))
    npt.assert_allclose(out, coverage, rtol=1e-6)


@pytest.mark.parametrize("preds,targets", [(np.zeros((100, 1)), np.zeros((100, 1))),
                                           (np.ones((100, 1)), np.full((100, 1), 100.0))])
def test_miscalibration_area_golden(preds, targets):
    out = tu.CalibrationAreaEvaluator().evaluate(preds, np.ones((100, 1)), targets, ONES_MASK)
    npt.assert_allclose(out, [0.495], rtol=1e-6)


@pytest.mark.parametrize("preds,uncs,targets,ence", [
    (np.zeros((100, 1)), np.ones((100, 1)), np.zeros((100, 1)), 1.0),
    (np.linspace(1, 100, 100)[:, None], np.linspace(1, 10, 100)[:, None],
     np.linspace(1, 100, 100)[:, None] + np.tile([-2, -1, 1, 2], 25)[:, None], 0.392),
], ids=["exact", "singleton_bins"])
def test_ence_golden(preds, uncs, targets, ence):
    out = tu.ExpectedNormalizedErrorEvaluator().evaluate(preds, uncs, targets, ONES_MASK)
    npt.assert_allclose(out, [ence], atol=5e-4)


def test_ence_drops_masked_rows():
    rng = np.random.default_rng(0)
    preds = rng.normal(size=(40, 2))
    targets = preds + rng.normal(scale=0.3, size=(40, 2))
    uncs = np.abs(rng.normal(scale=0.5, size=(40, 2))) + 0.05
    mask = np.ones((40, 2), dtype=bool)
    mask[::3, 1] = False
    ev = tu.UncertaintyEvaluatorRegistry["ence"]()
    got = np.asarray(ev.evaluate(preds, uncs, targets, mask))
    keep = mask[:, 1]
    want = ev.evaluate(preds[keep][:, 1:], uncs[keep][:, 1:], targets[keep][:, 1:],
                       np.ones((keep.sum(), 1), dtype=bool))
    assert np.isfinite(got).all()
    npt.assert_allclose(got[1], want[0], rtol=1e-12)


# ------------------------------------------- the JAX classes on seeded arrays
def _seeded(seed=0, n=60, t=3, c=4, m=3):
    """Regression, binary and multiclass arrays with masked entries and ties
    (repeated values of the predictions, uncertainties and targets)."""
    rng = np.random.default_rng(seed)
    ties = lambda x: np.round(x, 1)  # noqa: E731
    preds = ties(rng.normal(size=(n, t)))
    var = ties(np.abs(rng.normal(size=(n, t)))) + 0.05
    y = preds + rng.normal(scale=0.7, size=(n, t))
    y[:5] = preds[:5]  # exact hits
    mask = rng.random((n, t)) > 0.2
    mask[:, 0] = True
    probs = ties(rng.random((n, t)))
    labels = (rng.random((n, t)) < probs).astype(np.float64)
    labels[0], labels[1] = 0.0, 1.0  # every task sees both labels
    logits = rng.normal(size=(n, t, c))
    mprobs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mprobs[:4] = mprobs[4]  # tied rows
    classes = rng.integers(0, c, size=(n, t)).astype(np.float64)
    members = np.abs(ties(rng.normal(size=(m, n, t)))) + 0.1
    stacked = {
        "plain": rng.normal(size=(m, n, t)),
        "two": np.concatenate([rng.normal(size=(m, n, t, 1)),
                               np.abs(rng.normal(size=(m, n, t, 1))) + 0.1], -1),
        "four": np.concatenate([rng.normal(size=(m, n, t, 1)),
                                np.abs(rng.normal(size=(m, n, t, 3))) + 1.5], -1),
        "probs": rng.random((m, n, t)),
        "multiclass": np.stack([mprobs] * m) + rng.random((m, n, t, c)) * 0.01,
    }
    return dict(preds=preds, var=var, y=y, mask=mask, probs=probs, labels=labels,
                mprobs=mprobs, classes=classes, members=members, stacked=stacked)


ESTIMATOR_INPUTS = {
    "none": "plain", "ensemble": "plain", "dropout": "four", "mve": "two",
    "evidential-total": "four", "evidential-epistemic": "four", "evidential-aleatoric": "four",
    "classification": "multiclass", "classification-dirichlet": "two",
    "multiclass-dirichlet": "multiclass", "quantile-regression": "two",
}


def test_every_estimator_is_ported():
    assert set(tu.UncertaintyEstimatorRegistry) == set(ju.UncertaintyEstimatorRegistry)
    assert set(ESTIMATOR_INPUTS) == set(ju.UncertaintyEstimatorRegistry)


@pytest.mark.parametrize("name", sorted(ESTIMATOR_INPUTS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_estimator_matches_jax(name, dtype):
    stacked = _seeded()["stacked"][ESTIMATOR_INPUTS[name]].astype(dtype)
    want = ju.UncertaintyEstimatorRegistry[name]()(stacked)
    got = tu.UncertaintyEstimatorRegistry[name]()(stacked)
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    npt.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,stacked", [("mve", "plain"), ("evidential-total", "two"),
                                          ("quantile-regression", "four"),
                                          ("multiclass-dirichlet", "plain")])
def test_estimator_refuses_the_wrong_head(name, stacked):
    with pytest.raises(ValueError):
        tu.UncertaintyEstimatorRegistry[name]()(_seeded()["stacked"][stacked])


def _calibration_case(name, s):
    """``(kwargs, fit arguments, apply argument)`` of a calibrator."""
    reg = (s["preds"], s["var"], s["y"], s["mask"])
    binary = (s["probs"], s["probs"], s["labels"], s["mask"])
    multi = (s["mprobs"], s["mprobs"], s["classes"], s["mask"])
    return {
        "zscaling": ({}, reg, s["var"][::-1]),
        "zelikman-interval": ({"p": 0.8}, reg, s["var"][::-1]),
        "mve-weighting": ({}, (s["preds"], s["members"], s["y"], s["mask"]), s["members"]),
        "conformal-regression": ({"alpha": 0.2}, reg, s["var"][::-1]),
        "platt": ({}, binary, s["probs"][::-1]),
        "isotonic": ({}, binary, np.concatenate([s["probs"][::-1], [[-0.5] * 3, [1.5] * 3]])),
        "conformal-multilabel": ({"alpha": 0.2}, binary, s["probs"][::-1]),
        "conformal-multiclass": ({"alpha": 0.2}, multi, s["mprobs"][::-1]),
        "conformal-adaptive": ({"alpha": 0.2}, multi, s["mprobs"][::-1]),
        "isotonic-multiclass": ({}, multi, s["mprobs"][::-1]),
    }[name]


def test_every_calibrator_is_ported():
    assert set(tu.CalibratorRegistry) == set(ju.CalibratorRegistry)
    assert len(tu.CalibratorRegistry) == 10


@pytest.mark.parametrize("name", sorted(ju.CalibratorRegistry))
@pytest.mark.parametrize("seed", [0, 1])
def test_calibrator_matches_jax(name, seed):
    kwargs, fit_args, test = _calibration_case(name, _seeded(seed))
    want = ju.CalibratorRegistry[name](**kwargs).fit(*fit_args).apply(test)
    got = tu.CalibratorRegistry[name](**kwargs).fit(*fit_args).apply(test)
    assert got.shape == want.shape and got.dtype == want.dtype
    npt.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _evaluation_case(name, s):
    reg = (s["preds"], s["var"], s["y"], s["mask"])
    return {
        "nll-regression": reg, "miscalibration_area": reg, "ence": reg, "spearman": reg,
        "conformal-coverage-regression": reg,
        "nll-classification": (s["probs"], s["probs"], s["labels"], s["mask"]),
        "conformal-coverage-classification": (
            None, (s["stacked"]["four"][0, ..., :2] > 0.5).astype(int), s["labels"], s["mask"]),
        "nll-multiclass": (None, s["mprobs"], s["classes"], s["mask"]),
        "conformal-coverage-multiclass": (None, (s["mprobs"] > 0.2).astype(int), s["classes"],
                                          s["mask"]),
    }[name]


def test_every_evaluator_is_ported():
    assert set(tu.UncertaintyEvaluatorRegistry) == set(ju.UncertaintyEvaluatorRegistry)
    assert len(tu.UncertaintyEvaluatorRegistry) == 9


@pytest.mark.parametrize("name", sorted(ju.UncertaintyEvaluatorRegistry))
@pytest.mark.parametrize("seed", [0, 1])
def test_evaluator_matches_jax(name, seed):
    args = _evaluation_case(name, _seeded(seed))
    want = ju.UncertaintyEvaluatorRegistry[name]().evaluate(*args)
    got = tu.UncertaintyEvaluatorRegistry[name]().evaluate(*args)
    npt.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_reference_names():
    for name in ("RegressionConformalCalibrator", "MultilabelConformalCalibrator",
                 "UncertaintyCalibratorRegistry", "RegressionConformalEvaluator",
                 "MultilabelConformalEvaluator", "MulticlassConformalEvaluator",
                 "RegressionCalibrator", "BinaryClassificationCalibrator",
                 "MulticlassClassificationCalibrator", "RegressionEvaluator",
                 "BinaryClassificationEvaluator", "MulticlassClassificationEvaluator"):
        assert hasattr(tu, name), name


# ------------------------------------------------------------ isotonic fit
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(6))
def test_isotonic_fit_matches_sklearn(dtype, seed):
    """Tied x values (drawn from few distinct ones), targets 0/1 or in
    [0, 1), queries inside and outside the fitted range and at its
    thresholds; the fit keeps scikit-learn's dtype."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 60))
    x = rng.choice(rng.random(max(2, n // 3)), n).astype(dtype)
    y = ((rng.random(n) < x) if seed % 2 else rng.random(n)).astype(dtype)
    queries = np.concatenate([rng.random(40) * 1.6 - 0.3, x, [x.min(), x.max()]]).astype(dtype)
    want = SkIsotonic(y_min=0, y_max=1, out_of_bounds="clip").fit(x, y).predict(queries)
    got = tu.IsotonicRegression().fit(x, y).predict(queries)
    assert got.dtype == want.dtype
    npt.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("x,y", [
    ([0.3, 0.3, 0.3], [0.0, 1.0, 1.0]),  # one distinct x: a constant
    ([0.1, 0.2, 0.2, 0.9], [1.0, 0.0, 0.0, 1.0]),  # a violation pooled across a tie
    ([0.5, 0.1, 0.9, 0.1], [2.0, -1.0, 3.0, 0.5]),  # targets outside [0, 1]: clipped
    ([1, 2, 3, 4], [0, 1, 0, 1]),  # integer inputs become float64
])
def test_isotonic_fit_edge_cases_match_sklearn(x, y):
    queries = np.array([-1.0, 0.0, 0.1, 0.2, 0.25, 0.5, 0.9, 2.0, 3.5, 9.0])
    want = SkIsotonic(y_min=0, y_max=1, out_of_bounds="clip").fit(x, y).predict(queries)
    got = tu.IsotonicRegression().fit(x, y).predict(queries)
    assert got.dtype == want.dtype
    npt.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_zscaling_scale_moves_within_the_fits_tolerance():
    """``zscaling``'s scale is a Nelder-Mead fit, which stops within 1e-4 in
    its argument and its objective: inputs moved by 1e-7 of themselves (the
    size of summation-order differences between devices) can end it
    elsewhere, by up to 8e-4 of the scale in these five seeded fits, and
    within the 5e-3 that chip_smoke.py's FITTED_SCALE_RTOL allows."""
    rng = np.random.default_rng(0)
    moved = []
    for _ in range(5):
        preds = rng.normal(2, 1, (50, 1)).astype(np.float32)
        var = (np.abs(rng.normal(0, 0.5, (50, 1))) ** 2 + 0.01).astype(np.float32)
        y = preds + rng.normal(0, 1.5, (50, 1)).astype(np.float32)
        mask = np.ones((50, 1), bool)
        a = tu.ZScalingCalibrator().fit(preds, var, y, mask).scalings
        b = tu.ZScalingCalibrator().fit(
            (preds * (1 + 1e-7 * rng.normal(size=preds.shape))).astype(np.float32),
            (var * (1 + 1e-6 * rng.normal(size=var.shape))).astype(np.float32), y, mask).scalings
        moved.append(float(abs(a - b)[0] / a[0]))
    assert max(moved) < 5e-3
    assert max(moved) > 1e-5  # the fit does move: a tighter limit would fail
