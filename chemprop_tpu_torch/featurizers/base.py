"""Featurizer protocols (cf. ``chemprop_tpu/featurizers/base.py``)."""

from __future__ import annotations

from abc import abstractmethod
from typing import Protocol, TypeVar, runtime_checkable

import numpy as np

S = TypeVar("S", contravariant=True)
T = TypeVar("T")


@runtime_checkable
class VectorFeaturizer(Protocol[S]):
    """Maps an input (atom, bond, molecule, ...) to a 1-D feature vector."""

    @abstractmethod
    def __len__(self) -> int: ...

    @abstractmethod
    def __call__(self, x: S) -> np.ndarray: ...


@runtime_checkable
class GraphFeaturizer(Protocol[S]):
    """Maps an input to a :class:`~chemprop_tpu_torch.data.molgraph.MolGraph`."""

    @property
    @abstractmethod
    def shape(self) -> tuple[int, int]: ...

    @abstractmethod
    def __call__(self, x: S, atom_features_extra, bond_features_extra): ...
