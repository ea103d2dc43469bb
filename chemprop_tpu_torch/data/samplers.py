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
