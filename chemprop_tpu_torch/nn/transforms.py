"""Scaling transforms that belong to the model (cf.
``chemprop_tpu/nn/transforms.py``). As in the reference, they do nothing while
training, when the dataset has normalised its inputs already, and scale at
evaluation, so that a trained model takes raw inputs and gives raw-unit
predictions; the train/eval asymmetry is an explicit ``is_training``
argument. The buffers carry the reference's names (``mean``, ``scale``) and
``[1, n]`` shape, the leading ``pad`` columns (the featurizer's own width)
left alone: mean 0, scale 1. A reference state dict loads as it is."""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch
from torch import nn


class ScaleTransform(nn.Module):
    """``(X - mean) / scale`` at evaluation, the identity in training."""

    def __init__(self, mean, scale, pad: int = 0):
        super().__init__()
        mean = np.asarray(mean, dtype=np.float32).reshape(-1)
        scale = np.asarray(scale, dtype=np.float32).reshape(-1)
        if mean.shape != scale.shape:
            raise ValueError(f"uneven shapes for mean/scale: {mean.shape} vs {scale.shape}")
        mean = np.concatenate([np.zeros(pad, np.float32), mean])
        scale = np.concatenate([np.ones(pad, np.float32), scale])
        self.register_buffer("mean", torch.from_numpy(mean)[None, :])
        self.register_buffer("scale", torch.from_numpy(scale)[None, :])

    @classmethod
    def from_standard_scaler(cls, scaler, pad: int = 0) -> "ScaleTransform":
        return cls(scaler.mean_, scaler.scale_, pad=pad)

    @classmethod
    def identity(cls, n: int) -> "ScaleTransform":
        """A transform of width ``n`` whose buffers a state dict will fill."""
        return cls(np.zeros(n), np.ones(n))

    def forward(self, X: torch.Tensor, is_training: bool = False) -> torch.Tensor:
        return X if is_training else (X - self.mean) / self.scale


class UnscaleTransform(nn.Module):
    """Output unscaling: predictions in training units become raw units at
    inference, ``X * scale + mean``."""

    def __init__(self, n_tasks: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(1, n_tasks))
        self.register_buffer("scale", torch.ones(1, n_tasks))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return X * self.scale + self.mean

    def transform_variance(self, var: torch.Tensor) -> torch.Tensor:
        """A variance in training units in raw units, ``var * scale**2`` (at
        inference, as ``forward``)."""
        return var * self.scale.square()


class GraphTransform(nn.Module):
    """Scales a batch's atom and bond feature tables at evaluation; the
    extra-feature columns are the ones that move (``pad`` protects the
    featurizer's). The padding rows are scaled too, as in the JAX package: no
    real row reads them."""

    def __init__(self, V_transform: ScaleTransform | None, E_transform: ScaleTransform | None):
        super().__init__()
        self.V_transform = V_transform
        self.E_transform = E_transform

    def forward(self, bmg, is_training: bool = False):
        if is_training:
            return bmg
        V = bmg.V if self.V_transform is None else self.V_transform(bmg.V, False)
        E = bmg.E if self.E_transform is None else self.E_transform(bmg.E, False)
        return replace(bmg, V=V, E=E)
