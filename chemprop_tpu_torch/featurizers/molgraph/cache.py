"""MolGraph cache facades (cf. ``chemprop_tpu/featurizers/molgraph/cache.py``):
a Sequence of featurised graphs, either made up front in memory or made on
each access."""

from __future__ import annotations

from collections.abc import Sequence
from typing import Iterable

import numpy as np

from chemprop_tpu_torch.types import MolGraph
from chemprop_tpu_torch.utils.utils import parallel_execute


class MolGraphCacheFacade(Sequence):
    """Sequence-of-MolGraph interface; subclasses decide whether the graphs
    are kept."""


class MolGraphCache(MolGraphCacheFacade):
    """Makes every MolGraph up front and keeps them (in ``n_workers``
    processes where that is more than one)."""

    def __init__(
        self,
        inputs: Iterable,
        V_fs: Iterable[np.ndarray | None],
        E_fs: Iterable[np.ndarray | None],
        featurizer,
        n_workers: int = 0,
    ):
        items = list(zip(inputs, V_fs, E_fs))
        self._mgs = parallel_execute(
            lambda i: featurizer(items[i][0], items[i][1], items[i][2]),
            range(len(items)),
            n_workers,
        )

    def __len__(self) -> int:
        return len(self._mgs)

    def __getitem__(self, index: int) -> MolGraph:
        return self._mgs[index]


class MolGraphCacheOnTheFly(MolGraphCacheFacade):
    """Featurises on each access."""

    def __init__(
        self,
        inputs: Iterable,
        V_fs: Iterable[np.ndarray | None],
        E_fs: Iterable[np.ndarray | None],
        featurizer,
    ):
        self._inputs = list(inputs)
        self._V_fs = list(V_fs)
        self._E_fs = list(E_fs)
        self._featurizer = featurizer

    def __len__(self) -> int:
        return len(self._inputs)

    def __getitem__(self, index: int) -> MolGraph:
        return self._featurizer(self._inputs[index], self._V_fs[index], self._E_fs[index])
