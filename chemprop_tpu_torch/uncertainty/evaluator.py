"""Uncertainty evaluators (cf. ``chemprop_tpu/uncertainty/evaluator.py``):
``evaluate(preds, uncs, targets, mask)`` -> one value per task, over the
task's unmasked rows.

``ence`` bins each task's kept rows by predicted variance in chunks of
``ceil(n / num_bins)`` (``torch.chunk``'s sizes) and drops masked rows
before binning, as the JAX package does (a zero-filled masked row would
make a bin's root mean variance 0)."""

from __future__ import annotations

import numpy as np
from scipy.special import erfinv
from scipy.stats import spearmanr

from chemprop_tpu_torch.utils.registry import ClassRegistry

UncertaintyEvaluatorRegistry = ClassRegistry()


def _per_task(fn, preds, uncs, targets, mask):
    return np.array([fn(preds[mask[:, j], j], uncs[mask[:, j], j], targets[mask[:, j], j])
                     for j in range(preds.shape[1])])


class RegressionEvaluator:
    """Evaluators of regression uncertainties."""


class BinaryClassificationEvaluator:
    """Evaluators of binary-classification uncertainties."""


class MulticlassClassificationEvaluator:
    """Evaluators of multiclass uncertainties."""


@UncertaintyEvaluatorRegistry.register("nll-regression")
class NLLRegressionEvaluator:
    def evaluate(self, preds, uncs, targets, mask):
        def f(p, v, y):
            v = np.maximum(v, 1e-12)
            return float(np.mean(np.log(2 * np.pi * v) / 2 + (p - y) ** 2 / (2 * v)))

        return _per_task(f, preds, uncs, targets, mask)


@UncertaintyEvaluatorRegistry.register("nll-classification")
class NLLClassEvaluator:
    def evaluate(self, preds, uncs, targets, mask):
        def f(p, u, y):
            u = np.clip(u, 1e-7, 1 - 1e-7)
            return float(-np.mean(y * np.log(u) + (1 - y) * np.log(1 - u)))

        return _per_task(f, preds, uncs, targets, mask)


@UncertaintyEvaluatorRegistry.register("miscalibration_area")
class CalibrationAreaEvaluator:
    """The area between the observed and the expected coverage of the
    Gaussian intervals: the sum of ``|observed - expected|`` over the
    ``num_bins - 1`` inner points of the curve over ``num_bins`` (its
    endpoints add nothing)."""

    def evaluate(self, preds, uncs, targets, mask, num_bins: int = 100):
        fractions = np.arange(1, num_bins) / num_bins

        def f(p, v, y):
            z = np.abs(p - y) / np.sqrt(np.maximum(v, 1e-12))
            z_crit = np.sqrt(2) * erfinv(fractions)
            observed = np.mean(z[None, :] <= z_crit[:, None], axis=1)
            return float(np.sum(np.abs(observed - fractions)) / num_bins)

        return _per_task(f, preds, uncs, targets, mask)


@UncertaintyEvaluatorRegistry.register("ence")
class ExpectedNormalizedErrorEvaluator:
    """The mean over bins of ``|RMV - RMSE| / RMV``, the rows binned by
    predicted variance."""

    def evaluate(self, preds, uncs, targets, mask, num_bins: int = 100):
        def f(p, v, y):
            order = np.argsort(v, kind="stable")
            size = -(-len(order) // num_bins)
            vals = []
            for i in range(0, len(order), size):
                b = order[i: i + size]
                rmv = np.sqrt(np.mean(np.maximum(v[b], 1e-12)))
                rmse = np.sqrt(np.mean((p[b] - y[b]) ** 2))
                vals.append(abs(rmv - rmse) / max(rmv, 1e-12))
            return float(np.mean(vals))

        return _per_task(f, preds, uncs, targets, mask)


@UncertaintyEvaluatorRegistry.register("spearman")
class SpearmanEvaluator:
    """The rank correlation of the predicted uncertainty with the absolute
    error."""

    def evaluate(self, preds, uncs, targets, mask):
        def f(p, v, y):
            return float(spearmanr(v, np.abs(p - y)).statistic)

        return _per_task(f, preds, uncs, targets, mask)


@UncertaintyEvaluatorRegistry.register("conformal-coverage-regression")
class RegressionConformalCoverageEvaluator:
    """The share of targets inside ``[pred - unc, pred + unc]``."""

    def evaluate(self, preds, uncs, targets, mask):
        def f(p, half, y):
            return float(np.mean(np.abs(p - y) <= half))

        return _per_task(f, preds, uncs, targets, mask)


@UncertaintyEvaluatorRegistry.register("conformal-coverage-classification")
class MultilabelConformalCoverageEvaluator:
    """The share of samples with ``in_set <= target <= out_set``, ``uncs``
    ``[n, t, 2]`` (the conformal-multilabel calibrator's output)."""

    def evaluate(self, preds, uncs, targets, mask):
        in_set, out_set = uncs[..., 0], uncs[..., 1]
        covered = (in_set <= targets) & (targets <= out_set)
        mask = np.asarray(mask, dtype=bool)
        return (covered & mask).sum(0) / np.maximum(mask.sum(0), 1)


@UncertaintyEvaluatorRegistry.register("nll-multiclass")
class NLLMulticlassEvaluator:
    """The mean negative log probability of the true class, ``uncs``
    ``[n, t, c]``."""

    def evaluate(self, preds, uncs, targets, mask):
        targets = np.asarray(targets).astype(int)
        nlls = []
        for j in range(uncs.shape[1]):
            m = np.asarray(mask[:, j], dtype=bool)
            p_true = np.take_along_axis(uncs[m, j], targets[m, j][:, None], axis=1)[:, 0]
            nlls.append(float(np.mean(-np.log(np.maximum(p_true, 1e-12)))))
        return np.array(nlls)


@UncertaintyEvaluatorRegistry.register("conformal-coverage-multiclass")
class MulticlassConformalCoverageEvaluator:
    """The share of samples whose true class is in the 0/1 set ``uncs``
    ``[n, t, c]``."""

    def evaluate(self, preds, uncs, targets, mask):
        targets = np.asarray(targets).astype(int)
        in_set = np.take_along_axis(uncs, targets[..., None], axis=2)[..., 0] > 0
        mask = np.asarray(mask, dtype=bool)
        return (in_set & mask).sum(0) / np.maximum(mask.sum(0), 1)


# the JAX package's other names
RegressionConformalEvaluator = RegressionConformalCoverageEvaluator
MultilabelConformalEvaluator = MultilabelConformalCoverageEvaluator
MulticlassConformalEvaluator = MulticlassConformalCoverageEvaluator
