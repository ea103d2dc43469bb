"""The regression head (cf. ``chemprop_tpu/nn/predictors.py``): an MLP whose
inference output is unscaled to raw units. ``train_step`` and ``val_step``
give the criterion's and the validation metrics' predictions, both without
the unscaling; ``mc_step`` is inference with the dropout layers on."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from chemprop_tpu_torch.nn.ffn import MLP
from chemprop_tpu_torch.nn.metrics import MSE, ChempropMetric
from chemprop_tpu_torch.nn.transforms import UnscaleTransform


class RegressionFFN(nn.Module):
    def __init__(
        self,
        n_tasks: int = 1,
        input_dim: int = 300,
        hidden_dim: int | Sequence[int] = 300,
        n_layers: int = 1,
        output_transform: bool = True,
        criterion: ChempropMetric | None = None,
        dropout: float = 0.0,
        activation: str = "relu",
    ):
        super().__init__()
        self.n_tasks, self.input_dim, self.n_layers = n_tasks, input_dim, n_layers
        self.hidden_dim = hidden_dim if isinstance(hidden_dim, int) else list(hidden_dim)
        self.dropout, self.activation = dropout, activation
        self.criterion = criterion
        self.ffn = MLP(input_dim, n_tasks, hidden_dim, n_layers, dropout, activation)
        self.output_transform = UnscaleTransform(n_tasks) if output_transform else None

    def get_criterion(self) -> ChempropMetric:
        return self.criterion or MSE(task_weights=[1.0] * self.n_tasks)

    def forward(self, Z: torch.Tensor) -> torch.Tensor:
        Y = self.ffn(Z)
        return Y if self.output_transform is None else self.output_transform(Y)

    def train_step(
        self, Z: torch.Tensor, is_training: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        return self.ffn(Z, is_training, generator)

    def val_step(self, Z: torch.Tensor) -> torch.Tensor:
        return self.ffn(Z)

    def mc_step(self, Z: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        """Monte-Carlo dropout: the dropout layers on, the output unscaled."""
        Y = self.ffn(Z, True, generator)
        return Y if self.output_transform is None else self.output_transform(Y)
