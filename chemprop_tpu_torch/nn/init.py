"""Parameter initialisation (cf. ``chemprop_tpu/nn/init.py``).

``lecun`` is flax's default (truncated-normal kernels with variance 1/fan_in,
zero biases); ``torch`` is ``nn.Linear``'s own (kaiming-uniform weights,
uniform biases, both bounded by 1/sqrt(fan_in)). Both draw from an explicit
``torch.Generator``, so a seed fixes the weights."""

from __future__ import annotations

import math

import torch
from torch import nn

SCHEMES = ("lecun", "torch")


@torch.no_grad()
def init_parameters(
    module: nn.Module, scheme: str = "lecun", generator: torch.Generator | None = None
) -> nn.Module:
    """Re-initialise every ``nn.Linear`` of ``module`` in place."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown init scheme {scheme!r}; expected one of {SCHEMES}")
    for layer in module.modules():
        if not isinstance(layer, nn.Linear):
            continue
        fan_in = layer.weight.shape[1]
        bound = 1.0 / math.sqrt(fan_in)
        if scheme == "torch":
            layer.weight.uniform_(-bound, bound, generator=generator)
            if layer.bias is not None:
                layer.bias.uniform_(-bound, bound, generator=generator)
        else:
            # flax lecun_normal: truncated to two standard deviations, with the
            # standard deviation corrected for the truncation
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            if layer.bias is not None:
                layer.bias.zero_()
    return module
