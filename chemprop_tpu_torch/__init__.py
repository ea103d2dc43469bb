"""chemprop_tpu_torch: the PyTorch/CUDA port of chemprop_tpu for an NVIDIA
Hopper GPU. Its D-MPNN training, prediction, fingerprints, uncertainty,
interpretation and command line run through hand-written CUDA kernels in
place of the JAX package's Pallas TPU ones; its subpackages export the JAX
package's names.

The package imports torch and numpy only, each subpackage at its first
use. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version."""

__version__ = "0.1.0"

import importlib

_SUBPACKAGES = ("callbacks", "chem", "cli", "conf", "data", "exceptions", "featurizers",
                "interpret", "models", "nn", "ops", "schedulers", "train", "types",
                "uncertainty", "utils")


def __getattr__(name: str):
    """The subpackages, each imported at its first use, so that importing
    one (``chemprop_tpu_torch.ops`` to load an exported program) does not
    import the others."""
    if name in _SUBPACKAGES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "callbacks",
    "data",
    "exceptions",
    "featurizers",
    "models",
    "nn",
    "schedulers",
    "uncertainty",
    "utils",
    "__version__",
]
