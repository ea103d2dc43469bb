"""Leaf-level shared types (cf. reference ``chemprop/types.py``)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class MolGraph(NamedTuple):
    """Per-molecule graph record in COO layout with two directed edges per
    bond; ``rev_edge_index[e]`` is the opposite-direction edge of ``e``
    (cf. reference ``chemprop/data/molgraph.py:6-16``)."""

    V: np.ndarray
    """``[n_atoms, d_v]`` atom feature matrix (float32)"""
    E: np.ndarray
    """``[2 * n_bonds, d_e]`` directed-edge feature matrix (float32)"""
    edge_index: np.ndarray
    """``[2, 2 * n_bonds]`` int32 COO (row 0 = source, row 1 = destination)"""
    rev_edge_index: np.ndarray
    """``[2 * n_bonds]`` int32 reverse-edge permutation"""
