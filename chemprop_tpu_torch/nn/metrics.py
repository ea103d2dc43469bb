"""Losses (cf. ``chemprop_tpu/nn/metrics.py``): a metric weights its unreduced
``[b, t]`` loss by sample weight, task weight and mask, and divides the sum
by the number of unmasked targets."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class ChempropMetric:
    task_weights: Any = 1.0

    def __call__(
        self, preds: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor | None = None,
        weights: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """The batch value, used as the training criterion."""
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
