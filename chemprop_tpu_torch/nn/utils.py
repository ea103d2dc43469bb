"""Activations (cf. ``chemprop_tpu/nn/utils.py``). The port's slice runs the
reference default, ReLU; the fused iteration kernel has it built in."""

from __future__ import annotations

from typing import Callable

import torch

_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {"relu": torch.relu}


def get_activation_function(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(
            f"activation {name!r} is not ported yet; supported: {sorted(_ACTIVATIONS)}"
        ) from None
