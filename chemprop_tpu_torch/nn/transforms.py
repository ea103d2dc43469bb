"""Output unscaling (cf. ``chemprop_tpu/nn/transforms.py``): predictions in
training units become raw units at inference, ``X * scale + mean``. The
buffers carry the reference's names and ``[1, n_tasks]`` shape."""

from __future__ import annotations

import torch
from torch import nn


class UnscaleTransform(nn.Module):
    def __init__(self, n_tasks: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(1, n_tasks))
        self.register_buffer("scale", torch.ones(1, n_tasks))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return X * self.scale + self.mean
