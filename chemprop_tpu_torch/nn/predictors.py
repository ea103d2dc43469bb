"""The regression head (cf. ``chemprop_tpu/nn/predictors.py``): an MLP whose
inference output is unscaled to raw units."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from chemprop_tpu_torch.nn.ffn import MLP
from chemprop_tpu_torch.nn.transforms import UnscaleTransform


class RegressionFFN(nn.Module):
    def __init__(
        self,
        n_tasks: int = 1,
        input_dim: int = 300,
        hidden_dim: int | Sequence[int] = 300,
        n_layers: int = 1,
        output_transform: bool = True,
    ):
        super().__init__()
        self.n_tasks = n_tasks
        self.ffn = MLP(input_dim, n_tasks, hidden_dim, n_layers)
        self.output_transform = UnscaleTransform(n_tasks) if output_transform else None

    def forward(self, Z: torch.Tensor) -> torch.Tensor:
        Y = self.ffn(Z)
        return Y if self.output_transform is None else self.output_transform(Y)
