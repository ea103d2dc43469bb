"""The MLP of the predictor heads (cf. ``chemprop_tpu/nn/ffn.py``), with the
reference's block structure: block 0 is ``Sequential(Linear)`` and each later
block ``Sequential(activation, dropout, Linear)``, so the parameter names
(``ffn.0.0.weight``, ``ffn.1.2.weight``, ...) are the reference's. The
activation is any of ``nn.utils``'s, ReLU by default, as in the JAX package."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from chemprop_tpu_torch.nn.utils import Activation, Dropout


class MLP(nn.Sequential):
    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_dim: int | Sequence[int] = 300,
        n_layers: int = 1,
        dropout: float = 0.0,
        activation: str = "relu",
    ):
        hidden = [hidden_dim] * n_layers if isinstance(hidden_dim, int) else list(hidden_dim)
        dims = [input_dim, *hidden, output_dim]
        blocks = [nn.Sequential(nn.Linear(dims[0], dims[1]))]
        for d_in, d_out in zip(dims[1:-1], dims[2:]):
            blocks.append(
                nn.Sequential(Activation(activation), Dropout(dropout), nn.Linear(d_in, d_out))
            )
        super().__init__(*blocks)

    def forward(
        self, X: torch.Tensor, is_training: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """``is_training`` turns the dropout of the later blocks on; its masks
        come from ``generator``."""
        return self.encode(X, len(self), is_training, generator)

    def encode(
        self, X: torch.Tensor, i: int, is_training: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Blocks ``[:i]`` (a slice, so ``i = -1`` applies all but the last:
        the fingerprint hook)."""
        H = X
        for b in range(len(self))[:i]:
            if b == 0:
                H = self[0](H)
            else:
                act, drop, linear = self[b]
                H = linear(drop(act(H), is_training, generator))
        return H
