"""Epoch index streams (cf. ``chemprop_tpu/data/samplers.py``)."""

from __future__ import annotations

from typing import Iterator

import numpy as np


class SeededSampler:
    """A permutation of ``range(n)`` reshuffled every epoch from one seeded
    stream: each epoch shuffles the current permutation in place with the
    same persistent numpy Generator, so epoch k's order depends on the seed
    and on k alone, and equals the JAX package's."""

    def __init__(self, n: int, seed: int):
        if seed is None:
            raise ValueError("SeededSampler requires an explicit seed")
        self._order = np.arange(n)
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[int]:
        self._rng.shuffle(self._order)
        yield from self._order.tolist()

    def __len__(self) -> int:
        return self._order.size


class ClassBalanceSampler:
    """Positive and negative indices in turn, ``(pos, neg)`` pairs cut to the
    smaller class, so that every prefix of a batch is balanced. A row is
    positive where any of its targets is nonzero. With ``shuffle`` both pools
    are reshuffled each epoch, positives first, from one persistent seeded
    Generator, so that the order equals the JAX package's."""

    def __init__(self, Y: np.ndarray, seed: int | None = None, shuffle: bool = False):
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        is_pos = np.asarray(Y).any(axis=1)
        all_idxs = np.arange(len(Y))
        self._pools = [all_idxs[is_pos], all_idxs[~is_pos]]

    def __iter__(self) -> Iterator[int]:
        if self._shuffle:
            for pool in self._pools:
                self._rng.shuffle(pool)
        pairs = len(self) // 2
        for pos, neg in zip(self._pools[0][:pairs], self._pools[1][:pairs]):
            yield int(pos)
            yield int(neg)

    def __len__(self) -> int:
        return 2 * min(pool.size for pool in self._pools)
