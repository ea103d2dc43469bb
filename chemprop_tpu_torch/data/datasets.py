"""Datasets (cf. ``chemprop_tpu/data/datasets.py``): index -> featurised
``Datum``, raw and normalised views of the targets and of the extra inputs
(``normalize_inputs``, one scaler per key), and an optional cache of the
featurised graphs."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from chemprop_tpu_torch.data.datapoints import MoleculeDatapoint
from chemprop_tpu_torch.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.types import MolGraph


class Datum(NamedTuple):
    """The JAX package's fields in its order."""

    mg: MolGraph
    V_d: np.ndarray | None
    x_d: np.ndarray | None
    y: np.ndarray | None
    weight: float
    lt_mask: np.ndarray | None = None
    gt_mask: np.ndarray | None = None


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
        return Datum(mg, self.V_ds[idx], self.X_d[idx], None if d.y is None else self.Y[idx],
                     d.weight, d.lt_mask, d.gt_mask)

    def _featurize(self, idx: int) -> MolGraph:
        return self.featurizer(self.data[idx].mol, self.V_fs[idx], self.E_fs[idx])

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

    def _raw(self, key: str) -> list:
        return [getattr(d, "x_d" if key == "X_d" else key) for d in self.data]

    @property
    def X_d(self) -> np.ndarray:
        """The molecule descriptors as the model sees them, ``[n, d_xd]``, or
        a column of None without any."""
        return self._scaled["X_d"]

    @property
    def V_fs(self) -> list:
        return self._scaled["V_f"]

    @property
    def E_fs(self) -> list:
        return self._scaled["E_f"]

    @property
    def V_ds(self) -> list:
        return self._scaled["V_d"]

    def _width(self, key: str) -> int:
        first = self._raw(key)[0] if len(self) else None
        return 0 if first is None else np.shape(first)[-1]

    @property
    def d_xd(self) -> int:
        return self._width("X_d")

    @property
    def d_vf(self) -> int:
        return self._width("V_f")

    @property
    def d_ef(self) -> int:
        return self._width("E_f")

    @property
    def d_vd(self) -> int:
        return self._width("V_d")

    def normalize_inputs(self, key: str = "X_d", scaler: StandardScaler | None = None):
        """Standardise one kind of extra input (``X_d``, ``V_f``, ``E_f`` or
        ``V_d``) column by column, over every molecule's rows (over every atom
        or bond for the per-atom and per-bond ones); returns the scaler, None
        where the dataset has none of that input. Changing ``V_f`` or ``E_f``
        drops the cache of featurised graphs."""
        if key not in ("X_d", "V_f", "E_f", "V_d"):
            raise ValueError(f"invalid feature key {key!r}; expected one of X_d/V_f/E_f/V_d")
        if self._width(key) == 0:
            return scaler
        raw = self._raw(key)
        X = np.array(raw) if key == "X_d" else np.concatenate(raw, axis=0)
        if scaler is None:
            scaler = StandardScaler().fit(X)
        if key == "X_d":
            self._scaled[key] = scaler.transform(X)
        else:
            self._scaled[key] = [scaler.transform(x) if x.size else x for x in raw]
        if key in ("V_f", "E_f"):
            self._cache = None
        return scaler

    def reset(self) -> None:
        """Back to the raw targets and extra inputs, with the cache dropped."""
        self._scaled_Y = self._Y
        self._scaled = {key: self._raw(key) for key in ("V_f", "E_f", "V_d")}
        self._scaled["X_d"] = np.array(self._raw("X_d"))
        self._cache = None
