"""Datasets (cf. ``chemprop_tpu/data/datasets.py``): index -> featurised
``Datum``, raw and normalised views of the targets, and an optional cache of
the featurised graphs."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from chemprop_tpu_torch.data.datapoints import MoleculeDatapoint
from chemprop_tpu_torch.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.types import MolGraph


class Datum(NamedTuple):
    mg: MolGraph
    y: np.ndarray | None
    weight: float


class StandardScaler:
    """Column-wise standardisation with scikit-learn's numbers (which the JAX
    package uses): the mean and the population standard deviation, ignoring
    NaNs, and the deviation of a constant column replaced by one (a column
    is constant when its variance is within rounding of zero, scikit-learn's
    own test)."""

    def fit(self, X: np.ndarray) -> "StandardScaler":
        X = np.asarray(X, dtype=np.float64)
        self.mean_ = np.nanmean(X, axis=0)
        self.var_ = np.nanvar(X, axis=0)
        n = np.sum(~np.isnan(X), axis=0)
        eps = np.finfo(np.float64).eps
        constant = self.var_ <= n * eps * self.var_ + (n * self.mean_ * eps) ** 2
        self.scale_ = np.where(constant, 1.0, np.sqrt(self.var_))
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (np.asarray(X, dtype=np.float64) - self.mean_) / self.scale_

    def inverse_transform(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, dtype=np.float64) * self.scale_ + self.mean_


@dataclass
class MoleculeDataset:
    data: list[MoleculeDatapoint]
    featurizer: SimpleMoleculeMolGraphFeaturizer = field(
        default_factory=SimpleMoleculeMolGraphFeaturizer
    )

    def __post_init__(self):
        if self.data is None:
            raise ValueError("data cannot be None")
        self.reset()

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Datum:
        d = self.data[idx]
        mg = self._cache[idx] if self._cache is not None else self._featurize(idx)
        return Datum(mg, None if d.y is None else self.Y[idx], d.weight)

    def _featurize(self, idx: int) -> MolGraph:
        return self.featurizer(self.data[idx].mol)

    @property
    def cache(self) -> bool:
        return self._cache is not None

    @cache.setter
    def cache(self, cache: bool) -> None:
        self._cache = [self._featurize(i) for i in range(len(self))] if cache else None

    @property
    def _Y(self) -> np.ndarray:
        return np.array([d.y for d in self.data], dtype=float)

    @property
    def Y(self) -> np.ndarray:
        """The targets as training sees them (normalised after
        :meth:`normalize_targets`)."""
        return self._scaled_Y

    @Y.setter
    def Y(self, Y) -> None:
        Y = np.array(Y, dtype=float)
        if len(Y) != len(self.data):
            raise ValueError(f"{len(self.data)} datapoints but {len(Y)} targets")
        self._scaled_Y = Y

    def normalize_targets(self, scaler: StandardScaler | None = None) -> StandardScaler:
        if scaler is None:
            scaler = StandardScaler().fit(self._Y)
        self.Y = scaler.transform(self._Y)
        return scaler

    def reset(self) -> None:
        """Back to the raw targets, with the cache dropped."""
        self._scaled_Y = self._Y
        self._cache = None
