"""The per-molecule graph record, re-exported (cf.
``chemprop_tpu/data/molgraph.py``); it is defined in
:mod:`chemprop_tpu_torch.types`."""

from chemprop_tpu_torch.types import MolGraph

__all__ = ["MolGraph"]
