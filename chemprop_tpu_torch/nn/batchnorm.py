"""Batch normalisation of the graph fingerprints, inference only (cf.
``chemprop_tpu/nn/batchnorm.py``, eval mode): the running statistics of
training normalise every row. Buffer and parameter names are
``torch.nn.BatchNorm1d``'s, so a reference state dict loads as it is."""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias
