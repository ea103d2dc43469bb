"""chemprop_tpu_torch: the PyTorch/CUDA port of chemprop_tpu for an NVIDIA
Hopper GPU. Its D-MPNN training, prediction, fingerprints, uncertainty,
interpretation and command line run through hand-written CUDA kernels in
place of the JAX package's Pallas TPU ones; its subpackages export the JAX
package's names.

The package imports torch and numpy only. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on the CPU every kernel wrapper
takes its plain PyTorch version."""

__version__ = "0.1.0"

from chemprop_tpu_torch import (  # noqa: E402
    callbacks,
    data,
    exceptions,
    featurizers,
    models,
    nn,
    schedulers,
    uncertainty,
    utils,
)

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
