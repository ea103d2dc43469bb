"""The MLP of the predictor heads (cf. ``chemprop_tpu/nn/ffn.py``), with the
reference's block structure: block 0 is ``Sequential(Linear)`` and each later
block ``Sequential(activation, dropout, Linear)``, so the parameter names
(``ffn.0.0.weight``, ``ffn.1.2.weight``, ...) are the reference's."""

from __future__ import annotations

from typing import Sequence

from torch import nn


class MLP(nn.Sequential):
    """The dropout slot keeps the reference's parameter names for the Linear
    layers; dropout itself is not ported yet, so a rate above 0 raises."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        hidden_dim: int | Sequence[int] = 300,
        n_layers: int = 1,
        dropout: float = 0.0,
    ):
        if dropout > 0:
            raise NotImplementedError("dropout in the predictor is not ported yet")
        hidden = [hidden_dim] * n_layers if isinstance(hidden_dim, int) else list(hidden_dim)
        dims = [input_dim, *hidden, output_dim]
        blocks = [nn.Sequential(nn.Linear(dims[0], dims[1]))]
        for d_in, d_out in zip(dims[1:-1], dims[2:]):
            blocks.append(nn.Sequential(nn.ReLU(), nn.Identity(), nn.Linear(d_in, d_out)))
        super().__init__(*blocks)
