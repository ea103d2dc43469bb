"""Padding-aware batch normalisation of the graph fingerprints (cf.
``chemprop_tpu/nn/batchnorm.py``). In training the moments are taken over the
real rows only (``mask``), the biased variance normalises and the unbiased
one goes into the running variance, with ``torch.nn.BatchNorm1d``'s momentum
0.1 (flax's 0.9); in evaluation the running statistics normalise every row.
Buffer and parameter names are ``torch.nn.BatchNorm1d``'s, so a reference
state dict loads as it is."""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor | None = None, is_training: bool = False
    ) -> torch.Tensor:
        if is_training:
            w = x.new_ones((x.shape[0], 1)) if mask is None else mask.reshape(-1, 1).to(x.dtype)
            n = w.sum().clamp_min(1.0)
            mean = (x * w).sum(0) / n
            var = ((x - mean).square() * w).sum(0) / n
            if torch.is_grad_enabled():  # a training step, not a prediction with batch statistics
                with torch.no_grad():
                    m = self.momentum
                    unbiased = var * n / (n - 1).clamp_min(1.0)
                    self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                    self.running_var.mul_(1 - m).add_(unbiased, alpha=m)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias
