"""Losses and metrics (cf. ``chemprop_tpu/nn/metrics.py``), with the JAX
package's streaming protocol: ``init_state`` -> ``update_state`` per batch ->
``compute``. A metric weights its unreduced ``[b, t]`` loss by sample weight,
task weight and mask and accumulates ``(total, n)``; the MCC variants
accumulate confusion counts instead, per task, and ``R2Score`` the sufficient
statistics of the masked targets of all tasks pooled. ``__call__`` is one
batch's value (the training criterion). States are tensors on the inputs'
device; ``init_state`` makes them on the CPU and the first update moves them.

Curve metrics that need every prediction (``needs_collection``) are computed
on the host from gathered arrays by ``compute_from_arrays``. The JAX package
calls scikit-learn there; the port has its own, in numpy, with its semantics:
tied scores form one threshold, the ROC area is the trapezoid over the
distinct thresholds, average precision is the step sum without
interpolation, F1 counts a zero division as 0. One divergence: AUROC of
targets of one class raises ``ValueError``, where scikit-learn 1.8 and later
warns and returns NaN; a fit records NaN for the metric either way.

``LossFunctionRegistry`` and ``MetricRegistry`` (``utils.registry.ClassRegistry``)
map the JAX package's aliases (``"bce"``, ``"roc"``, ``"pinball"``, ...) to the
classes."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from chemprop_tpu_torch.utils.registry import ClassRegistry

LossFunctionRegistry = ClassRegistry()
MetricRegistry = ClassRegistry()


def _register(registry: ClassRegistry, *aliases: str):
    return registry.register(aliases)


def _task_weights(task_weights, like: torch.Tensor) -> torch.Tensor:
    # made on the host and copied without a wait for the device: a blocking
    # copy would synchronise every training step
    return torch.as_tensor(task_weights, dtype=torch.float32).to(
        like.device, non_blocking=True).reshape(1, -1)


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``, its gradient split in half at a tie as JAX's is
    (``clamp_min`` passes all of it)."""
    return torch.maximum(x, x.new_tensor(c))


def _min(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.minimum(x, x.new_tensor(c))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs(x)``, whose gradient at 0 is JAX's 1 (``abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def _acc(total: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A state entry plus one batch's part, on the part's device (a host
    entry copied without a wait for the device, as in ``_task_weights``)."""
    return total.to(x.device, non_blocking=True) + x


@dataclass
class ChempropMetric:
    task_weights: Any = 1.0
    higher_is_better: bool = field(default=False, init=False)
    needs_collection: bool = field(default=False, init=False)

    # ------------------------------------------------------------- protocol
    def init_state(self) -> dict:
        return {"total": torch.zeros(()), "n": torch.zeros(())}

    def update_state(self, state, preds, targets, mask, weights, lt_mask, gt_mask) -> dict:
        L = self.unreduced(preds, targets, mask, weights, lt_mask, gt_mask)
        L = L * weights.reshape(-1, 1) * _task_weights(self.task_weights, L) * mask
        return {"total": _acc(state["total"], L.sum()), "n": _acc(state["n"], mask.sum())}

    def compute(self, state) -> torch.Tensor:
        return state["total"] / state["n"].clamp_min(1)

    def __call__(
        self, preds: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor | None = None,
        weights: torch.Tensor | None = None, lt_mask: torch.Tensor | None = None,
        gt_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """The value over one batch (the training criterion)."""
        mask = torch.ones_like(targets, dtype=torch.bool) if mask is None else mask
        weights = targets.new_ones(targets.shape[0]) if weights is None else weights
        lt_mask = torch.zeros_like(targets, dtype=torch.bool) if lt_mask is None else lt_mask
        gt_mask = torch.zeros_like(targets, dtype=torch.bool) if gt_mask is None else gt_mask
        state = self.update_state(self.init_state(), preds, targets, mask, weights, lt_mask,
                                  gt_mask)
        return self.compute(state)

    def unreduced(self, preds, targets, mask, weights, lt_mask, gt_mask) -> torch.Tensor:
        raise NotImplementedError


# ------------------------------------------------------------------ regression
@_register(LossFunctionRegistry, "mse")
@_register(MetricRegistry, "mse")
@dataclass
class MSE(ChempropMetric):
    def unreduced(self, preds, targets, *args):
        return (preds - targets).square()


@_register(LossFunctionRegistry, "mae")
@_register(MetricRegistry, "mae")
@dataclass
class MAE(ChempropMetric):
    def unreduced(self, preds, targets, *args):
        return _abs(preds - targets)


@_register(LossFunctionRegistry, "rmse")
@_register(MetricRegistry, "rmse")
@dataclass
class RMSE(MSE):
    def compute(self, state):
        return (state["total"] / state["n"].clamp_min(1)).sqrt()


class BoundedMixin:
    """Inequality targets: a prediction that already satisfies its ``<x`` or
    ``>x`` target counts as the target itself."""

    def unreduced(self, preds, targets, mask, weights, lt_mask, gt_mask):
        preds = torch.where((preds < targets) & lt_mask, targets, preds)
        preds = torch.where((preds > targets) & gt_mask, targets, preds)
        return super().unreduced(preds, targets, mask, weights, lt_mask, gt_mask)


@_register(LossFunctionRegistry, "bounded-mse")
@_register(MetricRegistry, "bounded-mse")
@dataclass
class BoundedMSE(BoundedMixin, MSE):
    pass


@_register(LossFunctionRegistry, "bounded-mae")
@_register(MetricRegistry, "bounded-mae")
@dataclass
class BoundedMAE(BoundedMixin, MAE):
    pass


@_register(LossFunctionRegistry, "bounded-rmse")
@_register(MetricRegistry, "bounded-rmse")
@dataclass
class BoundedRMSE(BoundedMixin, RMSE):
    pass


@_register(MetricRegistry, "r2")
@dataclass
class R2Score(ChempropMetric):
    """``1 - SS_res / SS_tot`` over the masked targets of all tasks pooled;
    sample and task weights do not enter, as in the JAX package."""

    higher_is_better: bool = field(default=True, init=False)

    def init_state(self):
        return {k: torch.zeros(()) for k in ("n", "sy", "syy", "se")}

    def update_state(self, state, preds, targets, mask, weights, lt_mask, gt_mask):
        m = mask.to(preds.dtype)
        return {
            "n": _acc(state["n"], m.sum()),
            "sy": _acc(state["sy"], (targets * m).sum()),
            "syy": _acc(state["syy"], (targets.square() * m).sum()),
            "se": _acc(state["se"], ((preds - targets).square() * m).sum()),
        }

    def compute(self, state):
        n = state["n"].clamp_min(1)
        ss_tot = state["syy"] - state["sy"].square() / n
        return 1.0 - state["se"] / ss_tot.clamp_min(1e-12)


# ----------------------------------------------------- probabilistic regression
@_register(LossFunctionRegistry, "mve")
@dataclass
class MVELoss(ChempropMetric):
    """Gaussian NLL over (mean, var) heads (Nix & Weigend 1994 eq. 9)."""

    def unreduced(self, preds, targets, *args):
        mean, var = preds[..., 0], _max(preds[..., 1], 1e-8)
        return (mean - targets).square() / (2 * var) + torch.log(2 * math.pi * var) / 2


@_register(LossFunctionRegistry, "evidential")
@dataclass
class EvidentialLoss(ChempropMetric):
    """Deep evidential regression: the NIG NLL plus its regulariser (Amini
    2020)."""

    v_kl: float = 0.2
    eps: float = 1e-8

    def unreduced(self, preds, targets, *args):
        mean, v, alpha, beta = preds.unbind(-1)
        v = _max(v, 1e-8)
        residuals = targets - mean
        two_b_lambda = 2 * beta * (1 + v)
        L_nll = (
            0.5 * torch.log(math.pi / v)
            - alpha * torch.log(two_b_lambda)
            + (alpha + 0.5) * torch.log(v * residuals.square() + two_b_lambda)
            + torch.lgamma(alpha)
            - torch.lgamma(alpha + 0.5)
        )
        L_reg = (2 * v + alpha) * _abs(residuals)
        return L_nll + self.v_kl * (L_reg - self.eps)


@_register(LossFunctionRegistry, "quantile", "pinball")
@dataclass
class QuantileLoss(ChempropMetric):
    """Interval pinball loss over (mean, interval) heads."""

    alpha: float = 0.1

    def unreduced(self, preds, targets, *args):
        mean, interval = preds[..., 0], preds[..., 1]
        lower, upper = mean - interval / 2, mean + interval / 2
        a = self.alpha
        L_lower = torch.maximum((a / 2) * (targets - lower), (a / 2 - 1) * (targets - lower))
        L_upper = torch.maximum((1 - a / 2) * (targets - upper), (-a / 2) * (targets - upper))
        return L_lower + L_upper


@_register(LossFunctionRegistry, "quantile-point", "pinball-point")
@dataclass
class PointQuantileLoss(ChempropMetric):
    alpha: float = 0.1

    def unreduced(self, preds, targets, *args):
        diff = targets - preds
        return torch.where(diff > 0, self.alpha * diff, (1 - self.alpha) * (-diff))


# -------------------------------------------------------------- classification
@_register(LossFunctionRegistry, "bce")
@dataclass
class BCELoss(ChempropMetric):
    def unreduced(self, preds, targets, *args):
        # the numerically stable BCE with logits
        return _max(preds, 0.0) - preds * targets + torch.log1p(torch.exp(-_abs(preds)))


def _class_ids(targets: torch.Tensor, n_classes: int) -> torch.Tensor:
    return targets.to(torch.int64).clamp(0, n_classes - 1)


@_register(LossFunctionRegistry, "ce")
@dataclass
class CrossEntropyLoss(ChempropMetric):
    def unreduced(self, preds, targets, *args):
        # preds [b, t, c] logits; targets [b, t] class ids
        logp = torch.log_softmax(preds, dim=-1)
        tgt = _class_ids(targets, preds.shape[-1])
        return -torch.gather(logp, -1, tgt[..., None])[..., 0]


@_register(LossFunctionRegistry, "binary-mcc")
@dataclass
class BinaryMCCLoss(ChempropMetric):
    """Soft MCC from probabilistic confusion counts; ``assume_logits``: True
    for train-space logits, False for probabilities."""

    assume_logits: bool = True

    def init_state(self):
        return {k: torch.zeros(1) for k in ("TP", "FP", "TN", "FN")}

    def update_state(self, state, preds, targets, mask, weights, lt_mask, gt_mask):
        p = torch.sigmoid(preds) if self.assume_logits else preds
        w, t = weights.reshape(-1, 1) * mask, targets
        return {
            "TP": _acc(state["TP"], (t * p * w).sum(0)),
            "FP": _acc(state["FP"], ((1 - t) * p * w).sum(0)),
            "TN": _acc(state["TN"], ((1 - t) * (1 - p) * w).sum(0)),
            "FN": _acc(state["FN"], (t * (1 - p) * w).sum(0)),
        }

    def compute(self, state):
        TP, FP, TN, FN = state["TP"], state["FP"], state["TN"], state["FN"]
        mcc = (TP * TN - FP * FN) / torch.sqrt((TP + FP) * (TP + FN) * (TN + FP) * (TN + FN) + 1e-8)
        mcc = mcc * _task_weights(self.task_weights, mcc)
        return 1 - mcc.mean()


@_register(MetricRegistry, "binary-mcc")
@dataclass
class BinaryMCCMetric(BinaryMCCLoss):
    higher_is_better: bool = field(default=True, init=False)

    def compute(self, state):
        return 1 - super().compute(state)


@_register(LossFunctionRegistry, "multiclass-mcc")
@dataclass
class MulticlassMCCLoss(ChempropMetric):
    """Soft multiclass MCC per task (scikit-learn's formulation over weighted
    counts); ``assume_logits``: True for train-space logits, False for
    probabilities."""

    n_classes: int = 3
    assume_logits: bool = True

    def init_state(self):
        # per-task statistics; the zeros broadcast up on the first update
        return {"p": torch.zeros(1, self.n_classes), "t": torch.zeros(1, self.n_classes),
                "c": torch.zeros(1), "s": torch.zeros(1)}

    def update_state(self, state, preds, targets, mask, weights, lt_mask, gt_mask):
        probs = torch.softmax(preds, dim=-1) if self.assume_logits else preds
        C = probs.shape[-1]
        bin_targets = F.one_hot(_class_ids(targets, C), C).to(probs.dtype)  # [b, t, C]
        bin_preds = F.one_hot(probs.argmax(-1), C).to(probs.dtype)
        mdw = (weights.reshape(-1, 1) * mask)[..., None]  # [b, t, 1]
        return {
            "p": _acc(state["p"], (bin_preds * mdw).sum(0)),  # [t, C]
            "t": _acc(state["t"], (bin_targets * mdw).sum(0)),
            "c": _acc(state["c"], (bin_preds * bin_targets * mdw).sum(-1).sum(0)),  # [t]
            "s": _acc(state["s"], (probs * mdw).sum(-1).sum(0)),
        }

    def compute(self, state):
        p, t, c, s = state["p"], state["t"], state["c"], state["s"]
        s2 = s.square()
        cov_ytyp = c * s - (p * t).sum(-1)
        cov_ypyp = s2 - (p * p).sum(-1)
        cov_ytyt = s2 - (t * t).sum(-1)
        x = cov_ypyp * cov_ytyt
        mcc = torch.where(x == 0, torch.zeros_like(x), cov_ytyp / x.clamp_min(1e-12).sqrt())
        mcc = mcc * _task_weights(self.task_weights, mcc)[0]
        return 1 - mcc.mean()


@_register(MetricRegistry, "multiclass-mcc")
@dataclass
class MulticlassMCCMetric(MulticlassMCCLoss):
    higher_is_better: bool = field(default=True, init=False)

    def compute(self, state):
        return 1 - super().compute(state)


@_register(LossFunctionRegistry, "dirichlet")
@dataclass
class DirichletLoss(ChempropMetric):
    """Evidential classification loss (Sensoy 2018)."""

    v_kl: float = 0.2

    def unreduced(self, preds, targets, *args):
        C = preds.shape[-1]
        tgt = F.one_hot(_class_ids(targets, C), C).to(preds.dtype)
        S = preds.sum(-1, keepdim=True)
        p = preds / S
        A = (tgt - p).square().sum(-1, keepdim=True)
        B = (p * (1 - p) / (S + 1)).sum(-1, keepdim=True)
        L_mse = A + B
        alpha = tgt + (1 - tgt) * preds
        beta = torch.ones_like(alpha)
        S_alpha = alpha.sum(-1, keepdim=True)
        S_beta = beta.sum(-1, keepdim=True)
        ln_alpha = torch.lgamma(S_alpha) - torch.lgamma(alpha).sum(-1, keepdim=True)
        ln_beta = torch.lgamma(beta).sum(-1, keepdim=True) - torch.lgamma(S_beta)
        dg0, dg1 = torch.digamma(alpha), torch.digamma(S_alpha)
        L_kl = ln_alpha + ln_beta + ((alpha - beta) * (dg0 - dg1)).sum(-1, keepdim=True)
        return (L_mse + self.v_kl * L_kl).mean(-1)


# ------------------------------------------------------------------- spectral
def _spectral_norm(preds, mask, threshold):
    if threshold is not None:
        preds = _max(preds, threshold)
    return preds / _max((preds * mask).sum(1, keepdim=True), 1e-12)


@_register(LossFunctionRegistry, "sid")
@_register(MetricRegistry, "sid")
@dataclass
class SID(ChempropMetric):
    threshold: float | None = None

    def unreduced(self, preds, targets, mask, *args):
        preds_norm = _spectral_norm(preds, mask, self.threshold)
        one = torch.ones((), dtype=preds.dtype, device=preds.device)
        targets = torch.where(mask, targets, one)
        preds_norm = torch.where(mask, preds_norm, one)
        return (torch.log(preds_norm / targets) * preds_norm
                + torch.log(targets / preds_norm) * targets)


@_register(LossFunctionRegistry, "earthmovers", "wasserstein")
@_register(MetricRegistry, "earthmovers", "wasserstein")
@dataclass
class Wasserstein(ChempropMetric):
    threshold: float | None = None

    def unreduced(self, preds, targets, mask, *args):
        preds_norm = _spectral_norm(preds, mask, self.threshold)
        return _abs(targets.cumsum(1) - preds_norm.cumsum(1))


@_register(LossFunctionRegistry, "nlogprob_enrichment")
@dataclass
class NLogProbEnrichment(ChempropMetric):
    """Poisson-enrichment NLL for count data (Lim 2022)."""

    n1: int = 1
    n2: int = 1
    method: str = "sqrt"
    zscale: float = 1.0
    zinterval: float = 5.0

    def unreduced(self, preds, targets, mask, weights, *args):
        R = preds.reshape(preds.shape[0], -1)[:, 0]
        k1, k2 = targets[:, 0], targets[:, 1]
        R_d = R / (self.n2 / self.n1)
        if self.method == "score":
            zstat = (k1 - k2 * R_d) / _max((k1 + k2) * R_d, 1e-12).sqrt()
        elif self.method == "wald":
            zstat = (k1 - k2 * R_d) / _max(k1 + k2 * R_d**2, 1e-12).sqrt()
        elif self.method == "sqrt":
            zstat = 2 * (torch.sqrt(k1 + 3 / 8.0) - torch.sqrt((k2 + 3 / 8.0) * R_d))
            zstat = zstat / torch.sqrt(1 + R_d)
        else:
            raise ValueError(f"unsupported method {self.method!r}")
        zstat = _abs(_min(_max(zstat / self.zscale, -self.zinterval), self.zinterval))
        sf = _max(1 - torch.erf(zstat / math.sqrt(2)), 1e-12)
        return -torch.log(sf)[:, None]


# --------------------------------------------- host-side (collection) metrics
@dataclass
class _CollectedMetric(ChempropMetric):
    """Computed on the host from the whole gathered (preds, targets, mask)."""

    needs_collection: bool = field(default=True, init=False)
    higher_is_better: bool = field(default=True, init=False)

    def compute_from_arrays(self, preds: np.ndarray, targets: np.ndarray, mask: np.ndarray):
        raise NotImplementedError


def _binary_curve(y_true: np.ndarray, y_score: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Cumulative true and false positives at each distinct score, highest
    first (scikit-learn's ``_binary_clf_curve``: tied scores form one
    threshold). Targets of more than two values raise."""
    if np.unique(y_true).size > 2:
        raise ValueError("targets of more than two classes: not a binary problem")
    y_true = np.asarray(y_true) == 1
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = np.asarray(y_score)[order], y_true[order]
    last = np.r_[np.where(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[last]
    return tps, 1 + last - tps


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """The area under the ROC curve: the trapezoid over the distinct
    thresholds, from (0, 0). Targets of one class raise ``ValueError``."""
    if np.unique(y_true).size != 2:
        raise ValueError("only one class present in the targets: the ROC AUC is not defined")
    tps, fps = _binary_curve(y_true, y_score)
    tpr, fpr = np.r_[0, tps] / tps[-1], np.r_[0, fps] / fps[-1]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Average precision: the step sum of precision over the recall
    increments, no interpolation. Without a positive, recall is 1 at every
    threshold (0 results), as in scikit-learn."""
    tps, fps = _binary_curve(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision, recall = np.r_[precision[::-1], 1], np.r_[recall[::-1], 0]
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Binary F1 of the positive class; 0 where it has no true or predicted
    positive."""
    y_true, y_pred = np.asarray(y_true, bool), np.asarray(y_pred, bool)
    tp = np.sum(y_true & y_pred)
    denom = 2 * tp + np.sum(~y_true & y_pred) + np.sum(y_true & ~y_pred)
    return float(2 * tp / denom) if denom else 0.0


@_register(MetricRegistry, "roc")
@dataclass
class BinaryAUROC(_CollectedMetric):
    def compute_from_arrays(self, preds, targets, mask):
        return roc_auc(targets[mask], preds[mask])


@_register(MetricRegistry, "prc")
@dataclass
class BinaryAUPRC(_CollectedMetric):
    def compute_from_arrays(self, preds, targets, mask):
        return average_precision(targets[mask], preds[mask])


@_register(MetricRegistry, "accuracy")
@dataclass
class BinaryAccuracy(_CollectedMetric):
    threshold: float = 0.5

    def compute_from_arrays(self, preds, targets, mask):
        return float(((preds[mask] > self.threshold) == (targets[mask] > 0.5)).mean())


@_register(MetricRegistry, "f1")
@dataclass
class BinaryF1Score(_CollectedMetric):
    threshold: float = 0.5

    def compute_from_arrays(self, preds, targets, mask):
        return f1(targets[mask] > 0.5, preds[mask] > self.threshold)


# --------------------------------------------------- binned curve metrics
@dataclass
class _BinnedCurveMetric(ChempropMetric):
    """Streaming AUROC / AUPRC over fixed probability bins: the state is a
    pair of ``[n_bins]`` class-conditional histograms of the predicted
    probabilities (which must lie in [0, 1])."""

    n_bins: int = 8192
    higher_is_better: bool = field(default=True, init=False)

    def init_state(self):
        return {"pos": torch.zeros(self.n_bins), "neg": torch.zeros(self.n_bins)}

    def update_state(self, state, preds, targets, mask, weights, lt_mask, gt_mask):
        w = weights.reshape(-1, 1) * _task_weights(self.task_weights, preds) * mask
        idx = (preds * self.n_bins).to(torch.int32).clamp(0, self.n_bins - 1).reshape(-1)
        is_pos = targets > 0.5
        zero = torch.zeros((), dtype=w.dtype, device=w.device)
        pos_w = torch.where(is_pos, w, zero).reshape(-1).float()
        neg_w = torch.where(is_pos, zero, w).reshape(-1).float()
        return {"pos": state["pos"].to(preds.device).index_add(0, idx, pos_w),
                "neg": state["neg"].to(preds.device).index_add(0, idx, neg_w)}

    @staticmethod
    def _cumulative_from_top(state):
        # TP / FP counts when thresholding at each bin's lower edge, highest
        # score first; the leading 0 is a threshold above every score
        zero = state["pos"].new_zeros(1)
        return (torch.cat([zero, state["pos"].flip(0).cumsum(0)]),
                torch.cat([zero, state["neg"].flip(0).cumsum(0)]))


@_register(MetricRegistry, "binned-roc")
@dataclass
class BinnedBinaryAUROC(_BinnedCurveMetric):
    def compute(self, state):
        tp, fp = self._cumulative_from_top(state)
        tpr, fpr = tp / tp[-1].clamp_min(1e-12), fp / fp[-1].clamp_min(1e-12)
        # the trapezoid over the ROC curve (ties within a bin form one segment)
        return ((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2).sum()


@_register(MetricRegistry, "binned-prc")
@dataclass
class BinnedBinaryAUPRC(_BinnedCurveMetric):
    def compute(self, state):
        tp, fp = self._cumulative_from_top(state)
        precision = tp / (tp + fp).clamp_min(1e-12)
        recall = tp / tp[-1].clamp_min(1e-12)
        # average precision: the sum of precision times the recall increments
        return ((recall[1:] - recall[:-1]) * precision[1:]).sum()
