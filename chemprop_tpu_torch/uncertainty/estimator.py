"""Uncertainty estimators (cf. ``chemprop_tpu/uncertainty/estimator.py``).

Each maps the stacked outputs of an ensemble's members, ``[m, n, t]``
(regression, classification) or ``[m, n, t, u]`` (MVE u = 2, evidential
u = 4, quantile u = 2, Dirichlet u = 2 or c + 1), to per-sample
uncertainties ``[n, t]`` (``[n, t, c]`` for multiclass probabilities):

* ``ensemble``: the members' variance of the point predictions;
* ``dropout``: the same over Monte-Carlo samples stacked on the first axis;
* ``mve``: the mean predicted variance;
* ``evidential-total`` / ``-epistemic`` / ``-aleatoric``: the mean of
  ``(1 + 1/v) beta / (alpha - 1)``, ``(1/v) beta / (alpha - 1)`` and
  ``beta / (alpha - 1)`` of the normal-inverse-gamma head;
* ``classification``: the mean predicted probabilities;
* ``classification-dirichlet`` / ``multiclass-dirichlet``: the mean
  Dirichlet ``u = K / sum(alpha)`` channel;
* ``quantile-regression``: the mean predicted interval."""

from __future__ import annotations

import numpy as np

from chemprop_tpu_torch.utils.registry import ClassRegistry

UncertaintyEstimatorRegistry = ClassRegistry()


class UncertaintyEstimator:
    """Stacked model outputs -> per-sample uncertainties."""

    def __call__(self, stacked: np.ndarray):
        raise NotImplementedError


@UncertaintyEstimatorRegistry.register("none")
class NoUncertaintyEstimator(UncertaintyEstimator):
    def __call__(self, stacked: np.ndarray) -> None:
        return None


def _point(stacked: np.ndarray) -> np.ndarray:
    return stacked[..., 0] if stacked.ndim == 4 else stacked


@UncertaintyEstimatorRegistry.register("ensemble")
class EnsembleEstimator(UncertaintyEstimator):
    def __call__(self, stacked: np.ndarray) -> np.ndarray:
        if stacked.shape[0] == 1:
            raise ValueError("ensemble uncertainty requires >= 2 models")
        return _point(stacked).var(axis=0)


@UncertaintyEstimatorRegistry.register("dropout")
class DropoutEstimator(EnsembleEstimator):
    """The variance over Monte-Carlo dropout samples stacked on axis 0."""

    def __call__(self, stacked: np.ndarray) -> np.ndarray:
        return _point(stacked).var(axis=0)


def _channel(stacked: np.ndarray, k: int, u: int | None, method: str) -> np.ndarray:
    """The members' mean of output channel ``k`` of ``[m, n, t, u]``."""
    if stacked.ndim != 4 or (u is not None and stacked.shape[-1] != u):
        shape = f"[m, n, t, {u}]" if u is not None else "[m, n, t, c+1]"
        raise ValueError(f"{method} uncertainty requires {shape} outputs")
    return stacked[..., k].mean(axis=0)


@UncertaintyEstimatorRegistry.register("mve")
class MVEEstimator(UncertaintyEstimator):
    def __call__(self, stacked: np.ndarray) -> np.ndarray:
        return _channel(stacked, 1, 2, "mve")


class _EvidentialBase(UncertaintyEstimator):
    def _vab(self, stacked):
        if stacked.ndim != 4 or stacked.shape[-1] != 4:
            raise ValueError("evidential uncertainty requires [m, n, t, 4] outputs")
        return stacked[..., 1], stacked[..., 2], stacked[..., 3]


@UncertaintyEstimatorRegistry.register("evidential-total")
class EvidentialTotalEstimator(_EvidentialBase):
    def __call__(self, stacked: np.ndarray) -> np.ndarray:
        v, alpha, beta = self._vab(stacked)
        return ((1 + 1 / v) * beta / (alpha - 1)).mean(axis=0)


@UncertaintyEstimatorRegistry.register("evidential-epistemic")
class EvidentialEpistemicEstimator(_EvidentialBase):
    def __call__(self, stacked: np.ndarray) -> np.ndarray:
        v, alpha, beta = self._vab(stacked)
        return ((1 / v) * beta / (alpha - 1)).mean(axis=0)


@UncertaintyEstimatorRegistry.register("evidential-aleatoric")
class EvidentialAleatoricEstimator(_EvidentialBase):
    def __call__(self, stacked: np.ndarray) -> np.ndarray:
        v, alpha, beta = self._vab(stacked)
        return (beta / (alpha - 1)).mean(axis=0)


@UncertaintyEstimatorRegistry.register("classification")
class ClassEstimator(UncertaintyEstimator):
    """The predicted probabilities themselves (binary ``[m, n, t]`` ->
    ``[n, t]``; multiclass ``[m, n, t, c]`` -> ``[n, t, c]``)."""

    def __call__(self, stacked: np.ndarray) -> np.ndarray:
        return stacked.mean(axis=0)


@UncertaintyEstimatorRegistry.register("classification-dirichlet")
class ClassificationDirichletEstimator(UncertaintyEstimator):
    """A binary Dirichlet head's ``[m, n, t, 2] = (p, u)``: the mean ``u``."""

    def __call__(self, stacked: np.ndarray) -> np.ndarray:
        return _channel(stacked, 1, 2, "classification-dirichlet")


@UncertaintyEstimatorRegistry.register("multiclass-dirichlet")
class MulticlassDirichletEstimator(UncertaintyEstimator):
    """A multiclass Dirichlet head's ``[m, n, t, c+1] = (p_1..p_c, u)``: the
    mean ``u``."""

    def __call__(self, stacked: np.ndarray) -> np.ndarray:
        return _channel(stacked, -1, None, "multiclass-dirichlet")


@UncertaintyEstimatorRegistry.register("quantile-regression")
class QuantileRegressionEstimator(UncertaintyEstimator):
    def __call__(self, stacked: np.ndarray) -> np.ndarray:
        return _channel(stacked, 1, 2, "quantile")
