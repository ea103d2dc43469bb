"""Activations and dropout (cf. ``chemprop_tpu/nn/utils.py`` and flax's
``nn.Dropout``). ReLU is the reference default and is built into the fused
iteration kernels; message passing composes any other activation, and any
name with arguments (``"leakyrelu:0.1"``), from the message kernel and
library products."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    # PReLU with the (fixed) default slope 0.25, as in the JAX package
    "prelu": lambda x: torch.where(x >= 0, x, 0.25 * x),
    "tanh": torch.tanh,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default form
    "silu": F.silu,
    "softplus": F.softplus,
}


# the activations whose first argument after the colon sets their slope or alpha
_WITH_ARGUMENT: dict[str, Callable[[float], Callable[[torch.Tensor], torch.Tensor]]] = {
    "leakyrelu": lambda a: lambda x: F.leaky_relu(x, a),
    "prelu": lambda a: lambda x: torch.where(x >= 0, x, a * x),
    "elu": lambda a: lambda x: F.elu(x, a),
}


def get_activation_function(
    activation: str | Callable[[torch.Tensor], torch.Tensor],
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The activation a name gives; a callable is returned as it is, as in
    the JAX package. A name may carry arguments after a colon
    (``"leakyrelu:0.1"``, ``"prelu:0.2"``, ``"elu:0.5"``): the first sets the
    slope or alpha of these three, and the other activations ignore theirs.
    The string stays the module's configuration, so that a checkpoint
    carries it."""
    if callable(activation):
        return activation
    base, _, argstr = activation.lower().partition(":")
    args = [float(a) for a in argstr.split(",") if a]
    if base not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; supported: {sorted(_ACTIVATIONS)}")
    if args and base in _WITH_ARGUMENT:
        return _WITH_ARGUMENT[base](args[0])
    return _ACTIVATIONS[base]


class Activation(nn.Module):
    """One of the activations above as a module without parameters, for the
    blocks of the FFN; an unknown name raises when the module is built."""

    def __init__(self, name: str = "relu"):
        super().__init__()
        self.name = name.lower()
        self.fn = get_activation_function(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.name


def dropout_mask(
    shape: torch.Size, rate: float, generator: torch.Generator, device: torch.device
) -> torch.Tensor:
    """The boolean keep mask of one dropout layer: each element is kept with
    probability ``1 - rate``, drawn from ``generator`` (which lies on
    ``device``). Every mask of the port is drawn here."""
    return torch.rand(shape, generator=generator, device=device) >= rate


class Dropout(nn.Module):
    """Inverted dropout with an explicit generator: kept elements are scaled
    by ``1 / (1 - rate)``, the others are zero. A library elementwise pass, as
    the JAX package leaves its masks to XLA; the global generator is never
    used, so ``active`` without a generator raises."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = float(rate)

    def forward(
        self, x: torch.Tensor, active: bool = False, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        if not active or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout is on: pass the torch.Generator to draw its masks from")
        keep = dropout_mask(x.shape, self.rate, generator, x.device)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))
