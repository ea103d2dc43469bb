"""Losses and regression metrics (cf. ``chemprop_tpu/nn/metrics.py``): a
metric weights its unreduced ``[b, t]`` loss by sample weight, task weight and
mask, and divides the sum by the number of unmasked targets; ``RMSE`` takes
the root of that, and ``R2Score`` pools the masked targets of every task.
Only what a regression's validation metrics need is ported."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass
class ChempropMetric:
    task_weights: Any = 1.0
    higher_is_better: bool = field(default=False, init=False)

    def __call__(
        self, preds: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor | None = None,
        weights: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """The value over the batch (the training criterion, or a validation
        metric over all the validation rows at once)."""
        mask = torch.ones_like(targets, dtype=torch.bool) if mask is None else mask
        weights = targets.new_ones(targets.shape[0]) if weights is None else weights
        tw = torch.as_tensor(self.task_weights, dtype=torch.float32, device=preds.device)
        L = self.unreduced(preds, targets) * weights.reshape(-1, 1) * tw.reshape(1, -1) * mask
        return L.sum() / mask.sum().clamp_min(1)

    def unreduced(self, preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclass
class MSE(ChempropMetric):
    def unreduced(self, preds, targets):
        return (preds - targets).square()


@dataclass
class MAE(ChempropMetric):
    def unreduced(self, preds, targets):
        return (preds - targets).abs()


@dataclass
class RMSE(MSE):
    def __call__(self, preds, targets, mask=None, weights=None):
        return super().__call__(preds, targets, mask, weights).sqrt()


@dataclass
class R2Score(ChempropMetric):
    """``1 - SS_res / SS_tot`` over the masked targets of all tasks pooled;
    sample and task weights do not enter, as in the JAX package."""

    higher_is_better: bool = field(default=True, init=False)

    def __call__(self, preds, targets, mask=None, weights=None):
        m = torch.ones_like(targets) if mask is None else mask.to(preds.dtype)
        n = m.sum().clamp_min(1)
        sy, syy = (targets * m).sum(), (targets.square() * m).sum()
        ss_tot = syy - sy.square() / n
        return 1.0 - ((preds - targets).square() * m).sum() / ss_tot.clamp_min(1e-12)

