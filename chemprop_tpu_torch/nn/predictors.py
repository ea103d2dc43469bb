"""The task heads (cf. ``chemprop_tpu/nn/predictors.py``): an MLP and what a
task makes of its output. Each head has

* ``forward(Z, is_training)``: the inference output (probabilities, unscaled
  means, ...); with ``is_training`` the dropout layers are on and nothing is
  unscaled, as in the JAX head's ``__call__``;
* ``train_step(Z)``: what the criterion takes (logits, Dirichlet alphas, ...);
* ``val_step(Z)``: the validation metrics' predictions: inference
  activations without the output unscaling;
* ``mc_step(Z, generator)``: inference with the dropout layers on;
* ``encode(Z, i)``: the ``i``-th hidden representation.

``n_targets`` is the outputs per task (2 for MVE, 4 for evidential, ...);
multiclass heads have ``n_classes`` more per target. Only the regression
heads unscale, and only at inference and in ``mc_step``. The dropout masks
come from the explicit ``generator``."""

from __future__ import annotations

from dataclasses import fields
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from chemprop_tpu_torch.nn.ffn import MLP
from chemprop_tpu_torch.nn.metrics import (
    MSE,
    SID,
    BCELoss,
    ChempropMetric,
    CrossEntropyLoss,
    DirichletLoss,
    EvidentialLoss,
    MVELoss,
    QuantileLoss,
)
from chemprop_tpu_torch.nn.transforms import UnscaleTransform
from chemprop_tpu_torch.utils.registry import ClassRegistry

PredictorRegistry = ClassRegistry()


def _register(*aliases: str):
    return PredictorRegistry.register(aliases)


class _FFNPredictorBase(nn.Module):
    """The MLP of ``output_dim`` outputs and the default criterion, built with
    the head's ``task_weights`` and ``threshold`` where the criterion takes
    them. ``output_transform`` makes an identity ``UnscaleTransform`` of
    ``n_tasks`` columns (which a state dict fills); the regression heads make
    one unless told not to, the others none."""

    n_targets = 1
    _unscales = False
    _T_default_criterion: type = MSE

    def __init__(
        self,
        n_tasks: int = 1,
        input_dim: int = 300,
        hidden_dim: int | Sequence[int] = 300,
        n_layers: int = 1,
        output_transform: bool | None = None,
        criterion: ChempropMetric | None = None,
        dropout: float = 0.0,
        activation: str = "relu",
        task_weights: Sequence[float] | None = None,
        threshold: float | None = None,
    ):
        super().__init__()
        self.n_tasks, self.input_dim, self.n_layers = n_tasks, input_dim, n_layers
        self.hidden_dim = hidden_dim if isinstance(hidden_dim, int) else list(hidden_dim)
        self.dropout, self.activation = dropout, activation
        self.criterion = criterion
        self.task_weights = None if task_weights is None else [float(w) for w in task_weights]
        self.threshold = threshold
        self.ffn = MLP(input_dim, self.output_dim, hidden_dim, n_layers, dropout, activation)
        unscale = self._unscales if output_transform is None else output_transform
        self.output_transform = UnscaleTransform(n_tasks) if unscale else None

    @property
    def output_dim(self) -> int:
        return self.n_tasks * self.n_targets

    def get_criterion(self) -> ChempropMetric:
        if self.criterion is not None:
            return self.criterion
        cls = self._T_default_criterion
        kwargs = {"task_weights": self.task_weights or [1.0] * self.n_tasks,
                  "threshold": self.threshold}
        names = {f.name for f in fields(cls) if f.init}
        return cls(**{k: v for k, v in kwargs.items() if k in names})

    def forward(
        self, Z: torch.Tensor, is_training: bool = False, generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        return self.ffn(Z, is_training, generator)

    def train_step(
        self, Z: torch.Tensor, is_training: bool = True, generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        return self.ffn(Z, is_training, generator)

    def val_step(self, Z: torch.Tensor) -> torch.Tensor:
        return self(Z, False)

    def mc_step(self, Z: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        """Monte-Carlo dropout: the dropout layers on, all else as in
        inference."""
        return self(Z, True, generator)

    def encode(
        self, Z: torch.Tensor, i: int, is_training: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        return self.ffn.encode(Z, i, is_training, generator)

    def _ffn_tasks(self, Z, is_training, generator, k: int) -> torch.Tensor:
        """The MLP's output as ``[n, n_tasks, k]``."""
        return self.ffn(Z, is_training, generator).reshape(Z.shape[0], -1, k)


@_register("regression")
class RegressionFFN(_FFNPredictorBase):
    _unscales = True

    def _unscale(self, X: torch.Tensor, active: bool) -> torch.Tensor:
        return X if self.output_transform is None or not active else self.output_transform(X)

    def _forward(self, Z, is_training: bool, unscale: bool, generator) -> torch.Tensor:
        return self._unscale(self.ffn(Z, is_training, generator), unscale)

    def forward(self, Z, is_training: bool = False, generator=None):
        return self._forward(Z, is_training, not is_training, generator)

    def train_step(self, Z, is_training: bool = True, generator=None):
        return self._forward(Z, is_training, False, generator)

    def val_step(self, Z):
        return self._forward(Z, False, False, None)

    def mc_step(self, Z, generator):
        return self._forward(Z, True, True, generator)


@_register("regression-mve")
class MveFFN(RegressionFFN):
    n_targets = 2
    _T_default_criterion = MVELoss

    def _forward(self, Z, is_training, unscale, generator):
        mean, var = self.ffn(Z, is_training, generator).chunk(2, dim=1)
        var = F.softplus(var)
        mean = self._unscale(mean, unscale)
        if self.output_transform is not None and unscale:
            var = self.output_transform.transform_variance(var)
        return torch.stack([mean, var], dim=2)


@_register("regression-evidential")
class EvidentialFFN(RegressionFFN):
    n_targets = 4
    _T_default_criterion = EvidentialLoss

    def _forward(self, Z, is_training, unscale, generator):
        mean, v, alpha, beta = self.ffn(Z, is_training, generator).chunk(4, dim=1)
        v, alpha, beta = F.softplus(v), F.softplus(alpha) + 1, F.softplus(beta)
        mean = self._unscale(mean, unscale)
        if self.output_transform is not None and unscale:
            beta = self.output_transform.transform_variance(beta)
        return torch.stack([mean, v, alpha, beta], dim=2)


@_register("regression-quantile")
class QuantileFFN(RegressionFFN):
    n_targets = 2
    _T_default_criterion = QuantileLoss

    def _forward(self, Z, is_training, unscale, generator):
        lower, upper = self.ffn(Z, is_training, generator).chunk(2, dim=1)
        lower, upper = self._unscale(lower, unscale), self._unscale(upper, unscale)
        return torch.stack([(lower + upper) / 2, upper - lower], dim=2)


class BinaryClassificationFFNBase(_FFNPredictorBase):
    """The base of the binary classification heads (the JAX package's
    ``BinaryClassificationFFNBase``, which it also exports as
    ``ClassificationMixin``)."""


@_register("classification")
class BinaryClassificationFFN(BinaryClassificationFFNBase):
    _T_default_criterion = BCELoss

    def forward(self, Z, is_training: bool = False, generator=None):
        return torch.sigmoid(self.ffn(Z, is_training, generator))


@_register("classification-dirichlet")
class BinaryDirichletFFN(BinaryClassificationFFNBase):
    """``[n, t, 2]``: the positive class's probability and the Dirichlet
    uncertainty ``u = 2 / S``."""

    n_targets = 2
    _T_default_criterion = DirichletLoss

    def forward(self, Z, is_training: bool = False, generator=None):
        alpha = F.softplus(self._ffn_tasks(Z, is_training, generator, 2)) + 1
        S = alpha.sum(-1)
        return torch.stack([alpha[..., 1] / S, 2 / S], dim=2)

    def train_step(self, Z, is_training: bool = True, generator=None):
        return F.softplus(self._ffn_tasks(Z, is_training, generator, 2)) + 1


@_register("multiclass")
class MulticlassClassificationFFN(_FFNPredictorBase):
    _T_default_criterion = CrossEntropyLoss

    def __init__(self, *args, n_classes: int = 3, **kwargs):
        self.n_classes = n_classes
        super().__init__(*args, **kwargs)

    @property
    def output_dim(self) -> int:
        return self.n_tasks * self.n_targets * self.n_classes

    def forward(self, Z, is_training: bool = False, generator=None):
        return torch.softmax(self._ffn_tasks(Z, is_training, generator, self.n_classes), dim=-1)

    def train_step(self, Z, is_training: bool = True, generator=None):
        return self._ffn_tasks(Z, is_training, generator, self.n_classes)


@_register("multiclass-dirichlet")
class MulticlassDirichletFFN(MulticlassClassificationFFN):
    """``[n, t, c + 1]``: the class probabilities and the Dirichlet
    uncertainty ``u = c / S`` last."""

    _T_default_criterion = DirichletLoss

    def forward(self, Z, is_training: bool = False, generator=None):
        alpha = self.train_step(Z, is_training, generator)
        S = alpha.sum(-1, keepdim=True)
        return torch.cat([alpha / S, self.n_classes / S], dim=-1)

    def train_step(self, Z, is_training: bool = True, generator=None):
        return F.softplus(self._ffn_tasks(Z, is_training, generator, self.n_classes)) + 1


@_register("spectral")
class SpectralFFN(_FFNPredictorBase):
    """Spectra normalised to sum 1 over the tasks, after ``exp`` or
    ``softplus``; the criterion takes the same."""

    _T_default_criterion = SID

    def __init__(self, *args, spectral_activation: str | None = "softplus", **kwargs):
        if spectral_activation not in ("exp", "softplus", None):
            raise ValueError(f"unknown spectral activation {spectral_activation!r}")
        self.spectral_activation = spectral_activation
        super().__init__(*args, **kwargs)

    def forward(self, Z, is_training: bool = False, generator=None):
        Y = self.ffn(Z, is_training, generator)
        Y = torch.exp(Y) if self.spectral_activation == "exp" else F.softplus(Y)
        return Y / torch.maximum(Y.sum(1, keepdim=True), Y.new_tensor(1e-12))

    def train_step(self, Z, is_training: bool = True, generator=None):
        return self(Z, is_training, generator)
