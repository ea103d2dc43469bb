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


class ConstrainerFFN(nn.Module):
    """Moves per-atom (or per-bond) predictions so that each molecule's sum
    meets its constraint (cf. ``ConstrainerFFN`` of ``chemprop_tpu/nn/ffn.py``):
    an MLP ``ffn`` scores each row, ``w = exp(k) / sum_mol exp(k)`` with no
    shift by the maximum, and each row takes ``w`` times its molecule's
    deviation ``constraint - sum_mol preds``. A constraint column that is NaN
    in the batch's first row is not applied, in any row. The molecule sums are
    plain ``index_add_`` over ``batch``, as the JAX package's are an unsorted
    segment sum with no kernel; rows of the padding molecule ``n_mols`` read
    the last molecule's sums, as JAX's gathers clamp their indices."""

    def __init__(
        self,
        n_constraints: int = 1,
        fp_dim: int = 300,
        hidden_dim: int | Sequence[int] = 300,
        n_layers: int = 1,
        dropout: float = 0.0,
        activation: str = "relu",
    ):
        super().__init__()
        self.n_constraints, self.fp_dim, self.n_layers = n_constraints, fp_dim, n_layers
        self.hidden_dim = hidden_dim if isinstance(hidden_dim, int) else list(hidden_dim)
        self.dropout, self.activation = dropout, activation
        self.ffn = MLP(fp_dim, n_constraints, hidden_dim, n_layers, dropout, activation)

    def forward(
        self, fp: torch.Tensor, preds: torch.Tensor, batch: torch.Tensor,
        constraints: torch.Tensor, is_training: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        n_mols = constraints.shape[0]
        expk = torch.exp(self.ffn(fp, is_training, generator))
        rows = batch.long()
        mol = rows.clamp(max=n_mols - 1)

        def per_mol(x):
            return x.new_zeros((n_mols + 1, x.shape[1])).index_add_(0, rows, x)[:n_mols]

        w = expk / per_mol(expk)[mol].clamp_min(1e-12)
        has_constraint = ~torch.isnan(constraints[0])
        deviation = torch.where(has_constraint[None, :],
                                torch.nan_to_num(constraints) - per_mol(preds), 0.0)
        return preds + w * deviation[mol]
