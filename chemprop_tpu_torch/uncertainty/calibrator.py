"""Uncertainty calibrators (cf. ``chemprop_tpu/uncertainty/calibrator.py``):
``fit(preds, uncs, targets, mask)`` on a calibration set, then
``apply(uncs)``. Regression calibrators take ``uncs`` as variances (the
conformal one as half-interval widths), classification ones as
probabilities.

The isotonic calibrators fit :class:`IsotonicRegression`, the port's own
pool-adjacent-violators fit with the semantics of scikit-learn's
``IsotonicRegression(y_min=0, y_max=1, out_of_bounds="clip")``, which the
JAX package calls: scikit-learn is not on the card's machine. Platt and
the likelihood fits use scipy."""

from __future__ import annotations

import numpy as np
from scipy.optimize import minimize
from scipy.special import expit, logit

from chemprop_tpu_torch.utils.registry import ClassRegistry

CalibratorRegistry = ClassRegistry()


class IsotonicRegression:
    """A non-decreasing fit of ``y`` on ``x``, bounded to ``[0, 1]``, clipped
    to the fitted range outside it, as scikit-learn's
    ``IsotonicRegression(y_min=0, y_max=1, out_of_bounds="clip")`` computes
    it, in its dtypes: x in float32 stays float32 (y takes x's dtype), any
    other x becomes float64.

    * ``fit``: the pairs sorted by (x, y); the y of x values closer than the
      dtype's resolution averaged into one point, in the dtype (the
      order and arithmetic of scikit-learn's ``_make_unique``); a
      pool-adjacent-violators fit of those means with their counts as
      weights, in float64, cast back; clipped to ``[0, 1]``; points whose y
      equals both neighbours' dropped.
    * ``predict``: the queries in the dtype, clipped to the fitted x range,
      interpolated linearly between the thresholds (float64 as
      ``numpy.interp``, float32 as ``scipy.interpolate.interp1d``'s own
      formula, which scikit-learn reaches for either)."""

    def fit(self, x, y) -> "IsotonicRegression":
        x = np.asarray(x)
        dtype = np.float32 if x.dtype == np.float32 else np.float64
        x = x.astype(dtype).reshape(-1)
        y = np.asarray(y).astype(dtype).reshape(-1)
        order = np.lexsort((y, x))
        ux, uy, uw = _make_unique(x[order], y[order])
        fit = np.asarray(_pool_adjacent_violators(uy, uw), dtype=dtype)
        np.clip(fit, 0, 1, fit)
        self.x_min, self.x_max = np.min(ux), np.max(ux)
        keep = np.ones(len(fit), dtype=bool)
        keep[1:-1] = np.logical_or(np.not_equal(fit[1:-1], fit[:-2]),
                                   np.not_equal(fit[1:-1], fit[2:]))
        self.x_thresholds, self.y_thresholds = ux[keep], fit[keep]
        return self

    def predict(self, t) -> np.ndarray:
        xs, ys = self.x_thresholds, self.y_thresholds
        t = np.asarray(t).astype(xs.dtype)
        shape = t.shape
        t = np.clip(t.reshape(-1), self.x_min, self.x_max)
        if len(ys) == 1:
            out = ys.repeat(t.shape)
        elif xs.dtype == np.float64:
            out = np.interp(t, xs, ys)
        else:
            hi = np.searchsorted(xs, t).clip(1, len(xs) - 1).astype(int)
            lo = hi - 1
            slope = (ys[hi] - ys[lo]) / (xs[hi] - xs[lo])
            out = slope * (t - xs[lo]) + ys[lo]
        return out.astype(t.dtype).reshape(shape)


def _make_unique(x: np.ndarray, y: np.ndarray):
    """Sorted ``x`` -> (unique x, mean y of each, count of each), x values
    closer than the dtype's resolution counted as one, in x's dtype."""
    dt = x.dtype.type
    eps = dt(np.finfo(x.dtype).resolution)
    xs, ys, ws = [], [], []
    cur_x, cur_y, cur_w = x[0], dt(0), dt(0)
    for xi, yi in zip(x, y):
        if xi - cur_x >= eps:
            xs.append(cur_x)
            ws.append(cur_w)
            ys.append(cur_y / cur_w)
            cur_x, cur_w, cur_y = xi, dt(1), yi * dt(1)
        else:
            cur_w = cur_w + dt(1)
            cur_y = cur_y + yi * dt(1)
    xs.append(cur_x)
    ws.append(cur_w)
    ys.append(cur_y / cur_w)
    return np.array(xs, dtype=x.dtype), np.array(ys, dtype=x.dtype), np.array(ws, dtype=x.dtype)


def _pool_adjacent_violators(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The weighted least-squares non-decreasing fit of ``y``, in float64:
    adjacent blocks whose means fall are pooled into their weighted mean."""
    means, weights, counts = [], [], []
    for yi, wi in zip(np.asarray(y, np.float64), np.asarray(w, np.float64)):
        means.append(yi)
        weights.append(wi)
        counts.append(1)
        while len(means) > 1 and means[-2] > means[-1]:
            m, v, c = means.pop(), weights.pop(), counts.pop()
            total = weights[-1] + v
            means[-1] = (weights[-1] * means[-1] + v * m) / total
            weights[-1] = total
            counts[-1] += c
    return np.repeat(means, counts)


class CalibratorBase:
    def fit(self, preds, uncs, targets, mask) -> "CalibratorBase":
        raise NotImplementedError

    def apply(self, uncs: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class RegressionCalibrator(CalibratorBase):
    """Calibrators of regression uncertainties (variances)."""


class BinaryClassificationCalibrator(CalibratorBase):
    """Calibrators of binary class probabilities."""


class MulticlassClassificationCalibrator(CalibratorBase):
    """Calibrators of multiclass probabilities."""


@CalibratorRegistry.register("zscaling")
class ZScalingCalibrator(RegressionCalibrator):
    """Per task, the scale of the variance that maximises the Gaussian
    likelihood of the calibration errors (Nelder-Mead over its square
    root)."""

    def fit(self, preds, uncs, targets, mask):
        t = preds.shape[1]
        self.scalings = np.ones(t)
        for j in range(t):
            m = mask[:, j]
            err = preds[m, j] - targets[m, j]
            var = np.maximum(uncs[m, j], 1e-12)

            def nll(s):
                scaled = var * s[0] ** 2
                return float(np.sum(np.log(2 * np.pi * scaled) / 2 + err**2 / (2 * scaled)))

            res = minimize(nll, x0=[np.sqrt(np.mean(err**2 / var))], method="Nelder-Mead")
            self.scalings[j] = res.x[0] ** 2
        return self

    def apply(self, uncs):
        return uncs * self.scalings[None, :]


@CalibratorRegistry.register("zelikman-interval")
class ZelikmanCalibrator(RegressionCalibrator):
    """CRUDE interval scaling (Zelikman et al. 2020): the variance scales by
    the square of the ``p``-quantile (lower) of the absolute z-scores."""

    def __init__(self, p: float = 0.9):
        if not 0 <= p <= 1:
            raise ValueError(f"p must be in [0, 1], got {p}")
        self.p = p

    def fit(self, preds, uncs, targets, mask):
        t = preds.shape[1]
        self.scalings = np.ones(t)
        for j in range(t):
            m = mask[:, j]
            z = np.abs(preds[m, j] - targets[m, j]) / np.sqrt(np.maximum(uncs[m, j], 1e-12))
            self.scalings[j] = np.quantile(z, self.p, method="lower")
        return self

    def apply(self, uncs):
        return uncs * (self.scalings**2)[None, :]


@CalibratorRegistry.register("mve-weighting")
class MVEWeightingCalibrator(RegressionCalibrator):
    """For ensembles of variance heads: per task, convex weights over the
    members' variances (``uncs`` is ``[m, n, t]``) that maximise the
    calibration likelihood."""

    def fit(self, preds, uncs, targets, mask):
        m_models, _, t = uncs.shape
        self.weights = np.full((m_models, t), 1 / m_models)
        for j in range(t):
            msk = mask[:, j]
            err2 = (preds[msk, j] - targets[msk, j]) ** 2
            V = np.maximum(uncs[:, msk, j], 1e-12)

            def nll(w):
                w = np.exp(w)
                w = w / w.sum()
                var = np.tensordot(w, V, axes=1)
                return float(np.sum(np.log(var) / 2 + err2 / (2 * var)))

            res = minimize(nll, x0=np.zeros(m_models), method="Nelder-Mead")
            w = np.exp(res.x)
            self.weights[:, j] = w / w.sum()
        return self

    def apply(self, uncs):
        return np.einsum("mt,mnt->nt", self.weights, uncs)


def _higher_quantile(x: np.ndarray, q: float) -> float:
    return float(np.quantile(x, min(max(q, 0.0), 1.0), method="higher"))


def _conformal_level(n: int, alpha: float) -> float:
    return np.ceil((n + 1) * (1 - alpha)) / n if alpha >= 1 / (n + 1) else 1.0


def _check_alpha(alpha: float) -> float:
    if not 0 <= alpha <= 1:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    return alpha


@CalibratorRegistry.register("conformal-regression")
class ConformalRegressionCalibrator(RegressionCalibrator):
    """Split-conformal intervals (Angelopoulos & Bates 2021): ``uncs`` are
    half-interval widths, the score ``|err| - half`` and ``apply`` widens
    each half-interval by the scores' conformal quantile."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = _check_alpha(alpha)

    def fit(self, preds, uncs, targets, mask):
        t = preds.shape[1]
        self.qhats = np.zeros(t)
        for j in range(t):
            m = mask[:, j]
            half = np.asarray(uncs[m, j], dtype=np.float64)
            err = (np.asarray(targets[m, j], dtype=np.float64)
                   - np.asarray(preds[m, j], dtype=np.float64))
            scores = np.maximum(-err - half, err - half)
            self.qhats[j] = _higher_quantile(scores, _conformal_level(int(m.sum()), self.alpha))
        return self

    def apply(self, uncs):
        return uncs + self.qhats[None, :]


@CalibratorRegistry.register("platt")
class PlattCalibrator(BinaryClassificationCalibrator):
    """Logistic recalibration of the probabilities' logits. With
    ``training_targets`` (``[n_train, t]`` 0/1) the calibration targets are
    Platt's Bayesian estimates from the training set's class counts."""

    def fit(self, preds, uncs, targets, mask, training_targets=None):
        targets = np.asarray(targets, dtype=np.float64)
        msk = np.asarray(mask, dtype=bool)
        if np.any((targets[msk] != 0) & (targets[msk] != 1)):
            raise ValueError("Platt scaling requires binary 0/1 calibration targets")
        if training_targets is not None:
            training_targets = np.asarray(training_targets)
            n_neg = (training_targets == 0).sum(axis=0)
            n_pos = (training_targets == 1).sum(axis=0)
            neg_map = np.broadcast_to(1 / (n_neg + 2), targets.shape)
            pos_map = np.broadcast_to((n_pos + 1) / (n_pos + 2), targets.shape)
            targets = np.where(targets == 1, pos_map, neg_map)
        t = uncs.shape[1]
        self.ab = np.tile([1.0, 0.0], (t, 1))
        for j in range(t):
            m = msk[:, j]
            x = logit(np.clip(uncs[m, j], 1e-7, 1 - 1e-7))
            y = targets[m, j]

            def loss(ab):
                p = np.clip(expit(ab[0] * x + ab[1]), 1e-7, 1 - 1e-7)
                return float(-np.sum(y * np.log(p) + (1 - y) * np.log(1 - p)))

            self.ab[j] = minimize(loss, x0=[1.0, 0.0], method="Nelder-Mead").x
        return self

    def apply(self, uncs):
        x = logit(np.clip(uncs, 1e-7, 1 - 1e-7))
        return expit(self.ab[:, 0][None, :] * x + self.ab[:, 1][None, :])


@CalibratorRegistry.register("isotonic")
class IsotonicCalibrator(BinaryClassificationCalibrator):
    """Per task, an isotonic fit of the targets on the probabilities."""

    def fit(self, preds, uncs, targets, mask):
        self.models = []
        for j in range(uncs.shape[1]):
            m = mask[:, j]
            self.models.append(IsotonicRegression().fit(uncs[m, j], targets[m, j]))
        return self

    def apply(self, uncs):
        out = np.empty_like(uncs)
        for j, iso in enumerate(self.models):
            out[:, j] = iso.predict(uncs[:, j])
        return out


@CalibratorRegistry.register("conformal-multilabel")
class ConformalMultilabelCalibrator(BinaryClassificationCalibrator):
    """Conformal in and out sets for multilabel classification (Cauchois et
    al. 2020): the score is ``-p``; the in-threshold is the ``alpha / 2``
    quantile of each sample's least score over its negative labels, the
    out-threshold the ``1 - alpha / 2`` quantile of its greatest over its
    positive ones. ``apply`` gives ``[n, t, 2]``, (in, out) memberships."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = _check_alpha(alpha)

    def fit(self, preds, uncs, targets, mask):
        if targets.shape[1] < 2:
            raise ValueError(f"conformal-multilabel needs > 1 task, got {targets.shape[1]}")
        scores = -np.asarray(uncs, dtype=np.float64)
        targets = np.asarray(targets)
        mask = np.asarray(mask, dtype=bool)
        has_zeros = np.any(targets == 0, axis=1)
        s_in = np.where((targets[has_zeros] == 0) & mask[has_zeros], scores[has_zeros], np.inf)
        has_ones = np.any(targets == 1, axis=1)
        s_out = np.where((targets[has_ones] == 1) & mask[has_ones], scores[has_ones], -np.inf)
        self.tin = _higher_quantile(s_in.min(axis=1), self.alpha / 2)
        self.tout = _higher_quantile(s_out.max(axis=1), 1 - self.alpha / 2)
        return self

    def apply(self, uncs):
        scores = -np.asarray(uncs)
        return np.stack(
            [(scores <= self.tin).astype(int), (scores <= self.tout).astype(int)], axis=2)


@CalibratorRegistry.register("conformal-multiclass")
class MulticlassConformalCalibrator(MulticlassClassificationCalibrator):
    """Split-conformal prediction sets: ``uncs`` ``[n, t, c]`` class
    probabilities, ``targets`` ``[n, t]`` class ids, the score of the true
    class ``-p``; ``apply`` gives each class's 0/1 membership,
    ``[n, t, c]``."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = _check_alpha(alpha)

    @staticmethod
    def nonconformity_scores(preds: np.ndarray) -> np.ndarray:
        return -preds

    def fit(self, preds, uncs, targets, mask):
        t = uncs.shape[1]
        self.qhats = np.zeros(t)
        scores = self.nonconformity_scores(np.asarray(uncs, dtype=np.float64))
        targets = np.asarray(targets).astype(int)
        for j in range(t):
            m = np.asarray(mask[:, j], dtype=bool)
            s_true = np.take_along_axis(scores[m, j], targets[m, j][:, None], axis=1)[:, 0]
            self.qhats[j] = _higher_quantile(s_true, _conformal_level(len(s_true), self.alpha))
        return self

    def apply(self, uncs):
        scores = self.nonconformity_scores(np.asarray(uncs))
        return (scores <= self.qhats[None, :, None]).astype(int)


@CalibratorRegistry.register("conformal-adaptive")
class AdaptiveMulticlassConformalCalibrator(MulticlassConformalCalibrator):
    """Adaptive prediction sets: a class's score is the probability mass of
    the classes at least as likely as it."""

    @staticmethod
    def nonconformity_scores(preds: np.ndarray) -> np.ndarray:
        sort_index = np.argsort(-preds, axis=2)
        sorted_scores = np.cumsum(np.take_along_axis(preds, sort_index, axis=2), axis=2)
        unsorted = np.empty_like(sorted_scores)
        np.put_along_axis(unsorted, sort_index, sorted_scores, axis=2)
        return unsorted


@CalibratorRegistry.register("isotonic-multiclass")
class IsotonicMulticlassCalibrator(MulticlassClassificationCalibrator):
    """One-against-all isotonic fits of ``[n, t, c]`` class probabilities,
    normalised over the classes (Guo et al. 2017)."""

    def fit(self, preds, uncs, targets, mask):
        targets = np.asarray(targets).astype(int)
        self.models = []
        for j in range(uncs.shape[1]):
            m = np.asarray(mask[:, j], dtype=bool)
            self.models.append([
                IsotonicRegression().fit(uncs[m, j, k], (targets[m, j] == k).astype(float))
                for k in range(uncs.shape[2])])
        return self

    def apply(self, uncs):
        out = np.zeros_like(uncs)
        for j, per_class in enumerate(self.models):
            for k, iso in enumerate(per_class):
                out[:, j, k] = iso.predict(uncs[:, j, k])
        return out / np.maximum(out.sum(axis=-1, keepdims=True), 1e-12)


# the JAX package's other names
RegressionConformalCalibrator = ConformalRegressionCalibrator
MultilabelConformalCalibrator = ConformalMultilabelCalibrator
UncertaintyCalibratorRegistry = CalibratorRegistry
