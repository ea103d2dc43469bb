"""Device selection: the port runs on the GPU unless told otherwise."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the first CUDA device, and raises when there is none:
    the port never carries on quietly on the CPU. Pass ``"cpu"`` to run the
    plain PyTorch versions of the kernels there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (--device cpu) "
                "to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
