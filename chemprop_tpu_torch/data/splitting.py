"""Train/val/test splitting (cf. ``chemprop_tpu/data/splitting.py``), with
the JAX package's algorithms and its seeded numpy streams, so that both
packages split a dataset into the same indices:

* ``random``: a seeded permutation;
* ``random_with_repeated_smiles``: identical molecules (by canonical graph
  key) stay in one split;
* ``scaffold_balanced``: Bemis-Murcko scaffold groups; the groups larger
  than half the test set go to train, the rest fill the splits in seeded
  random order;
* ``kennard_stone``: the max-min diversity order on the Jaccard distances of
  Morgan fingerprints; its most diverse prefix becomes train;
* ``kmeans``: clusters of Morgan bits, numbered as scikit-learn's
  ``KMeans`` numbers them (``data/kmeans.py``, numpy, no scikit-learn),
  filled into the splits in seeded random order.

Each replicate increments the seed.
"""

from __future__ import annotations

from enum import auto
from typing import Iterable, Sequence

import numpy as np

from chemprop_tpu_torch.chem.mol import Mol
from chemprop_tpu_torch.chem.morgan import canonical_key
from chemprop_tpu_torch.chem.morgan_rdkit import rdkit_morgan_binary
from chemprop_tpu_torch.chem.scaffold import murcko_scaffold_key
from chemprop_tpu_torch.data.kmeans import kmeans_fit_predict
from chemprop_tpu_torch.utils.utils import EnumMapping


class SplitType(EnumMapping):
    SCAFFOLD_BALANCED = auto()
    RANDOM_WITH_REPEATED_SMILES = auto()
    RANDOM = auto()
    KENNARD_STONE = auto()
    KMEANS = auto()


def make_split_indices(
    mols: Sequence[Mol],
    split: SplitType | str = "random",
    sizes: tuple[float, float, float] = (0.8, 0.1, 0.1),
    seed: int = 0,
    num_replicates: int = 1,
) -> tuple[list[list[int]], list[list[int]], list[list[int]]]:
    split = SplitType.get(split)  # an unknown name raises before anything is done
    if len(sizes) != 3:
        raise ValueError(f"specify sizes for train/val/test (got {len(sizes)} values)")
    if any(s < 0 for s in sizes) or abs(sum(sizes) - 1.0) > 1e-8:
        raise ValueError(f"split sizes must be non-negative and sum to 1, got {sizes}")

    n = len(mols)
    if sizes == (1.0, 0.0, 0.0):
        return (
            [list(range(n))] * num_replicates,
            [[]] * num_replicates,
            [[]] * num_replicates,
        )

    trains, vals, tests = [], [], []
    for rep in range(num_replicates):
        rng = np.random.default_rng(seed + rep)
        match split:
            case SplitType.RANDOM:
                tr, va, te = _random_split(np.arange(n), sizes, rng)
            case SplitType.RANDOM_WITH_REPEATED_SMILES:
                groups = _group_by_key([canonical_key(m) for m in mols])
                tr, va, te = _grouped_random_split(groups, n, sizes, rng)
            case SplitType.SCAFFOLD_BALANCED:
                groups = _group_by_key([murcko_scaffold_key(m) for m in mols])
                tr, va, te = _scaffold_balanced_split(groups, n, sizes, rng)
            case SplitType.KENNARD_STONE:
                fps = _fingerprints(mols)
                tr, va, te = _kennard_stone_split(fps, sizes)
            case SplitType.KMEANS:
                fps = _fingerprints(mols)
                tr, va, te = _kmeans_split(fps, sizes, rng)
            case _:
                raise RuntimeError("unreachable")
        trains.append(sorted(tr))
        vals.append(sorted(va))
        tests.append(sorted(te))
    return trains, vals, tests


def _split_counts(n: int, sizes: tuple[float, float, float]) -> tuple[int, int, int]:
    n_train = int(round(sizes[0] * n))
    n_val = int(round(sizes[1] * n))
    n_train = min(n_train, n)
    n_val = min(n_val, n - n_train)
    return n_train, n_val, n - n_train - n_val


def _random_split(idxs: np.ndarray, sizes, rng) -> tuple[list[int], list[int], list[int]]:
    n = len(idxs)
    perm = rng.permutation(n)
    n_train, n_val, _ = _split_counts(n, sizes)
    return (
        idxs[perm[:n_train]].tolist(),
        idxs[perm[n_train : n_train + n_val]].tolist(),
        idxs[perm[n_train + n_val :]].tolist(),
    )


def _group_by_key(keys: list[str]) -> list[list[int]]:
    groups: dict[str, list[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return list(groups.values())


def _grouped_random_split(groups, n, sizes, rng):
    order = rng.permutation(len(groups))
    n_train, n_val, _ = _split_counts(n, sizes)
    tr, va, te = [], [], []
    for gi in order:
        g = groups[gi]
        if len(tr) + len(g) <= n_train or not tr:
            tr += g
        elif n_val and (len(va) + len(g) <= n_val or not va):
            va += g
        else:
            te += g
    return tr, va, te


def _scaffold_balanced_split(groups, n, sizes, rng):
    n_train, n_val, n_test = _split_counts(n, sizes)
    half_test = max(1, (n_test or n_val) // 2)
    big = [g for g in groups if len(g) > half_test]
    small = [g for g in groups if len(g) <= half_test]
    order = rng.permutation(len(small))
    tr, va, te = [], [], []
    for g in big:
        tr += g
    for gi in order:
        g = small[gi]
        if len(tr) + len(g) <= n_train:
            tr += g
        elif len(va) + len(g) <= n_val:
            va += g
        else:
            te += g
    return tr, va, te


def _fingerprints(mols: Sequence[Mol]) -> np.ndarray:
    return np.stack([rdkit_morgan_binary(m, 2, 2048) for m in mols]).astype(bool)


def _kennard_stone_split(fps: np.ndarray, sizes):
    n = len(fps)
    if n > 20000:
        raise ValueError("kennard_stone split is O(n^2); use random/kmeans for n > 20000")
    # popcount-based pairwise Jaccard (memory-light blocks)
    counts = fps.sum(1)
    D = np.empty((n, n), dtype=np.float32)
    block = max(1, 2**22 // max(n, 1))
    for s in range(0, n, block):
        e = min(n, s + block)
        inter = fps[s:e].astype(np.int32) @ fps.T.astype(np.int32)
        union = counts[s:e, None] + counts[None, :] - inter
        D[s:e] = 1.0 - inter / np.maximum(union, 1)
    # max-min ordering: start from the most distant pair
    i, j = np.unravel_index(np.argmax(D), D.shape)
    order = [int(i), int(j)]
    selected = np.zeros(n, dtype=bool)
    selected[[i, j]] = True
    mind = np.minimum(D[i], D[j])
    for _ in range(n - 2):
        mind[selected] = -1
        k = int(np.argmax(mind))
        order.append(k)
        selected[k] = True
        mind = np.minimum(mind, D[k])
    n_train, n_val, _ = _split_counts(n, sizes)
    return (
        order[:n_train],
        order[n_train : n_train + n_val],
        order[n_train + n_val :],
    )


def _greedy_fill(groups, order, targets) -> tuple[list[int], list[int], list[int]]:
    """Assign whole groups to (train, val, test), each to the split with the
    largest remaining relative deficit."""
    splits = ([], [], [])
    for gi in order:
        g = groups[gi]
        deficits = [
            (targets[k] - len(splits[k])) / max(targets[k], 1) if targets[k] else -1.0
            for k in range(3)
        ]
        splits[int(np.argmax(deficits))].extend(g)
    return splits


def _kmeans_split(fps: np.ndarray, sizes, rng):
    n = len(fps)
    n_clusters = min(max(2, n // 10), 100, n)
    labels = kmeans_fit_predict(fps, n_clusters, random_state=int(rng.integers(2**31)), n_init=3)
    clusters = [np.where(labels == c)[0].tolist() for c in range(n_clusters)]
    clusters = [c for c in clusters if c]
    order = rng.permutation(len(clusters))
    return _greedy_fill(clusters, order, _split_counts(n, sizes))


def split_data_by_indices(
    data,
    train_indices: Iterable[Iterable[int]] | None = None,
    val_indices: Iterable[Iterable[int]] | None = None,
    test_indices: Iterable[Iterable[int]] | None = None,
):
    """Partition datapoints (or per-component lists of datapoints) by
    replicate index lists (cf. reference ``splitting.py:213-239``)."""

    def helper(indices):
        if indices is None:
            return None
        if data and isinstance(data[0], (list, tuple)):
            return [
                [[component[i] for i in idxs] for component in data] for idxs in indices
            ]
        return [[data[i] for i in idxs] for idxs in indices]

    return helper(train_indices), helper(val_indices), helper(test_indices)
