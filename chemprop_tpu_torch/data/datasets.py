"""Datasets (cf. ``chemprop_tpu/data/datasets.py``): index -> featurised
``Datum``, raw and normalised views of the targets and of the extra inputs
(``normalize_inputs``, one scaler per key), and an optional cache of the
featurised graphs. ``ReactionDataset`` featurises reactions with the
condensed graph of reaction; ``MulticomponentDataset`` holds one dataset per
input component, all of one length, whose rows index as lists of ``Datum``
(the targets, weights and bounds are component 0's). ``MolAtomBondDataset``
holds molecules with atom and bond targets, whose rows index as
``MABDatum``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from chemprop_tpu_torch.data.datapoints import (
    MolAtomBondDatapoint, MoleculeDatapoint, ReactionDatapoint,
)
from chemprop_tpu_torch.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.featurizers.molgraph.reaction import CondensedGraphOfReactionFeaturizer
from chemprop_tpu_torch.types import MolGraph
from chemprop_tpu_torch.utils.utils import parallel_execute


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
    # the processes that featurise the cache when it is filled (0 or 1: this
    # one; utils.parallel_execute forks them, and they touch no CUDA state)
    n_workers: int = 0

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
    def names(self) -> list[str | None]:
        return [d.name for d in self.data]

    @property
    def t(self) -> int | None:
        """The number of tasks (targets per datapoint)."""
        return None if not len(self.data) or self.data[0].y is None else self.data[0].y.size

    @property
    def cache(self) -> bool:
        return self._cache is not None

    @cache.setter
    def cache(self, cache: bool) -> None:
        self._cache = (parallel_execute(self._featurize, range(len(self)), self.n_workers)
                       if cache else None)

    def populate_cache_native(self, smiles: list[str] | None = None, keep_h: bool = False) -> bool:
        """Fill the cache of featurised graphs through the native C++ batch
        featurizer (``featurizers.native``), the same graphs as the Python
        featurizer's. It serves the default featurizer without extra atom or
        bond inputs; otherwise (or without the datapoints' SMILES) it returns
        False and leaves the cache unset. A failed build of the library
        raises."""
        from chemprop_tpu_torch.featurizers.native import (
            featurize_batch_native, molgraphs_from_native,
        )

        f = self.featurizer
        if f.extra_atom_fdim or f.extra_bond_fdim or f.shape != (72, 14):
            return False
        if smiles is None:
            if any(d.name is None for d in self.data):
                return False
            smiles = [d.name for d in self.data]
        self._cache = molgraphs_from_native(featurize_batch_native(smiles, keep_h=keep_h))
        return True

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


@dataclass
class ReactionDataset(MoleculeDataset):
    """Reactions featurised by the condensed graph of reaction (cf.
    ``ReactionDataset`` of ``chemprop_tpu/data/datasets.py``): no extra atom
    or bond inputs, only the molecule descriptors ``X_d``."""

    data: list[ReactionDatapoint]
    featurizer: CondensedGraphOfReactionFeaturizer = field(
        default_factory=CondensedGraphOfReactionFeaturizer
    )

    def _featurize(self, idx: int) -> MolGraph:
        d = self.data[idx]
        return self.featurizer((d.rct, d.pdt))

    def _raw(self, key: str) -> list:
        return [d.x_d if key == "X_d" else None for d in self.data]

    def normalize_inputs(self, key: str = "X_d", scaler: StandardScaler | None = None):
        """As ``MoleculeDataset.normalize_inputs``; a reaction has only ``X_d``."""
        return super().normalize_inputs(key, scaler) if key == "X_d" else scaler

    def populate_cache_native(self, rxns: list[str] | None = None, keep_h: bool = False) -> bool:
        """Fill the cache of condensed graphs of reaction through the native
        C++ batch featurizer (the cuik ``batch_reaction_featurizer``
        equivalent), in the featurizer's mode. It serves the default 72 atom
        and 14 bond features; otherwise (or without the datapoints' reaction
        SMILES) it returns False and leaves the cache unset."""
        from chemprop_tpu_torch.featurizers.native import (
            featurize_rxn_batch_native, molgraphs_from_native,
        )

        f = self.featurizer
        if len(f.atom_featurizer) != 72 or len(f.bond_featurizer) != 14:
            return False
        if rxns is None:
            if any(d.name is None or ">" not in d.name for d in self.data):
                return False
            rxns = [d.name for d in self.data]
        nb = featurize_rxn_batch_native(rxns, keep_h=keep_h, mode=f.mode.name)
        self._cache = molgraphs_from_native(nb)
        return True


class MABDatum(NamedTuple):
    """The JAX package's fields in its order: the targets, bounds' masks and
    constraints per kind, (mol, atom, bond) and (atom, bond)."""

    mg: MolGraph
    V_d: np.ndarray | None
    E_d: np.ndarray | None
    x_d: np.ndarray | None
    ys: tuple
    weight: float
    constraints: tuple | None
    lt_masks: tuple = (None, None, None)
    gt_masks: tuple = (None, None, None)


@dataclass
class MolAtomBondDataset(MoleculeDataset):
    """``MolAtomBondDatapoint``s (cf. ``MolAtomBondDataset`` of
    ``chemprop_tpu/data/datasets.py``): targets normalised per kind
    (``normalize_targets("mol" | "atom" | "bond")``), the bond descriptors
    ``E_d`` as a fifth kind of extra input, and the constraints rescaled with
    their kind's targets: where ``y' = (y - mu) / sigma``, a molecule's sum
    over its ``n`` atoms (bonds) becomes ``C' = (C - n mu) / sigma``."""

    data: list[MolAtomBondDatapoint]

    def __getitem__(self, idx: int) -> MABDatum:
        d = self.data[idx]
        mg = self._cache[idx] if self._cache is not None else self._featurize(idx)
        constraints = None
        if d.atom_constraints is not None or d.bond_constraints is not None:
            constraints = (self._scaled_atom_c[idx], self._scaled_bond_c[idx])
        # a datapoint without molecule targets reads a NaN scalar here
        y = self.Y[idx]
        if not isinstance(y, np.ndarray) or y.ndim == 0:
            y = None
        return MABDatum(mg, self.V_ds[idx], self.E_ds[idx], self.X_d[idx],
                        (y, self.atom_Y[idx], self.bond_Y[idx]), d.weight, constraints,
                        (d.lt_mask, d.atom_lt_mask, d.bond_lt_mask),
                        (d.gt_mask, d.atom_gt_mask, d.bond_gt_mask))

    @property
    def atom_Y(self) -> list:
        return self._scaled_atom_Y

    @property
    def bond_Y(self) -> list:
        return self._scaled_bond_Y

    @property
    def E_ds(self) -> list:
        return self._scaled["E_d"]

    @property
    def d_ed(self) -> int:
        return self._width("E_d")

    def normalize_inputs(self, key: str = "X_d", scaler: StandardScaler | None = None):
        """As ``MoleculeDataset.normalize_inputs``, and ``E_d`` over every
        bond."""
        if key != "E_d":
            return super().normalize_inputs(key, scaler)
        if self.d_ed == 0:
            return scaler
        raw = self._raw(key)
        if scaler is None:
            scaler = StandardScaler().fit(np.concatenate(raw, axis=0))
        self._scaled[key] = [scaler.transform(x) if x.size else x for x in raw]
        return scaler

    def reset(self) -> None:
        super().reset()
        self._scaled["E_d"] = self._raw("E_d")
        self._scaled_atom_Y = [d.atom_y for d in self.data]
        self._scaled_bond_Y = [d.bond_y for d in self.data]
        self._scaled_atom_c = [d.atom_constraints for d in self.data]
        self._scaled_bond_c = [d.bond_constraints for d in self.data]

    def normalize_targets(self, kind: str = "mol", scaler: StandardScaler | None = None):
        """Standardise one kind's targets (over every atom or bond for those)
        and rescale its constraints; returns the scaler, None for an atom or
        bond kind the dataset has no targets of."""
        if kind == "mol":
            return super().normalize_targets(scaler)
        if kind not in ("atom", "bond"):
            raise ValueError(f"invalid kind {kind!r}")
        ys = [getattr(d, f"{kind}_y") for d in self.data]
        if ys[0] is None:
            return scaler
        if scaler is None:
            scaler = StandardScaler().fit(np.concatenate(ys, axis=0))
        setattr(self, f"_scaled_{kind}_Y", [scaler.transform(y) if y.size else y for y in ys])
        cs = getattr(self, f"_scaled_{kind}_c")
        setattr(self, f"_scaled_{kind}_c", [
            None if c is None else (c - len(y) * scaler.mean_) / scaler.scale_
            for c, y in zip(cs, ys)])
        return scaler


class MulticomponentDataset:
    """One dataset per input component, indexed together (cf.
    ``MulticomponentDataset`` of ``chemprop_tpu/data/datasets.py``): row
    ``i`` is the list of every component's ``Datum``; the targets, weights,
    bounds and ``X_d`` are component 0's."""

    def __init__(self, datasets: list):
        sizes = {len(d) for d in datasets}
        if len(sizes) != 1:
            raise ValueError(f"component datasets have mismatched lengths: {sizes}")
        self.datasets = datasets

    def __len__(self) -> int:
        return len(self.datasets[0])

    def __getitem__(self, idx: int) -> list[Datum]:
        return [d[idx] for d in self.datasets]

    @property
    def data(self) -> list:
        return self.datasets[0].data

    @property
    def names(self) -> list[tuple]:
        return list(zip(*[d.names for d in self.datasets]))

    @property
    def t(self) -> int | None:
        return self.datasets[0].t

    @property
    def d_xd(self) -> int:
        return self.datasets[0].d_xd

    @property
    def _Y(self) -> np.ndarray:
        return self.datasets[0]._Y

    @property
    def Y(self) -> np.ndarray:
        return self.datasets[0].Y

    def normalize_targets(self, scaler: StandardScaler | None = None) -> StandardScaler:
        return self.datasets[0].normalize_targets(scaler)

    def normalize_inputs(self, key: str = "X_d", scaler=None) -> list:
        """Each component's scaler of ``key`` (``scaler`` applied to all)."""
        return [d.normalize_inputs(key, scaler) for d in self.datasets]

    def reset(self) -> None:
        for d in self.datasets:
            d.reset()

    @property
    def cache(self) -> bool:
        return all(d.cache for d in self.datasets)

    @cache.setter
    def cache(self, cache: bool) -> None:
        for d in self.datasets:
            d.cache = cache


@dataclass
class CuikmolmakerDataset(MoleculeDataset):
    """A ``MoleculeDataset`` whose graphs the native C++ batch featurizer
    makes at construction (the reference's cuik-backed
    ``CuikmolmakerDataset``, ``data/datasets.py:369-433``); where it does not
    serve the featurizer, the Python featurizer fills the cache."""

    keep_h: bool = False

    def __post_init__(self):
        super().__post_init__()
        if not self.populate_cache_native(keep_h=self.keep_h):
            self.cache = True


@dataclass
class CuikmolmakerReactionDataset(ReactionDataset):
    """A ``ReactionDataset`` whose condensed graphs the native C++ batch
    featurizer makes at construction (the reference's
    ``CuikmolmakerReactionDataset``, ``data/datasets.py:722``)."""

    keep_h: bool = False

    def __post_init__(self):
        super().__post_init__()
        if not self.populate_cache_native(keep_h=self.keep_h):
            self.cache = True
