"""Multi-hot atom featurization.

Reproduces the exact feature layout of the reference atom featurizers
(``chemprop/featurizers/atom.py:11-288``): per-subfeature one-hot blocks with
an unknown-pad slot, followed by an aromaticity bit and ``0.01 * mass``.
Presets v1 (133-d), v2 (72-d, default), organic (44-d), and the
resonance-invariant RIGR variant (52-d) use the same vocabularies, so feature
indices line up one-to-one with the reference for checkpoint/parity work.

Implementation is fresh and batch-oriented: the hot path is
:meth:`featurize_mol`, which emits the whole ``[n_atoms, d]`` block in one
pass (the reference builds one numpy row per atom in Python).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import auto
from typing import Sequence

import numpy as np

from chemprop_tpu_torch.chem.mol import Atom, HybridizationType, Mol
from chemprop_tpu_torch.utils.utils import EnumMapping


@dataclass(frozen=True)
class _OneHotBlock:
    """One categorical subfeature: known choices + one trailing unknown slot."""

    choices: tuple
    name: str

    @property
    def width(self) -> int:
        return len(self.choices) + 1

    def index(self, value) -> int:
        try:
            return self.choices.index(value)
        except ValueError:
            return len(self.choices)


class MultiHotAtomFeaturizer:
    """Encodes atomic number, total degree, formal charge, chiral tag, total
    H count, and hybridization as one-hot-with-unknown blocks, plus an
    aromatic flag and scaled mass."""

    def __init__(
        self,
        atomic_nums: Sequence[int],
        degrees: Sequence[int],
        formal_charges: Sequence[int],
        chiral_tags: Sequence[int],
        num_Hs: Sequence[int],
        hybridizations: Sequence[int],
    ):
        self.blocks = [
            _OneHotBlock(tuple(atomic_nums), "atomic_num"),
            _OneHotBlock(tuple(degrees), "degree"),
            _OneHotBlock(tuple(formal_charges), "formal_charge"),
            _OneHotBlock(tuple(chiral_tags), "chiral_tag"),
            _OneHotBlock(tuple(num_Hs), "num_hs"),
            _OneHotBlock(tuple(int(h) for h in hybridizations), "hybridization"),
        ]
        self._offsets = np.cumsum([0] + [b.width for b in self.blocks])
        self._size = int(self._offsets[-1]) + 2  # + aromatic + mass

    def __len__(self) -> int:
        return self._size

    def _values(self, mol: Mol, atom: Atom) -> list:
        return [
            atom.atomic_num,
            mol.total_degree(atom.idx),
            atom.formal_charge,
            int(atom.chiral_tag),
            atom.total_num_hs,
            int(atom.hybridization),
        ]

    def featurize(self, mol: Mol, atom: Atom) -> np.ndarray:
        x = np.zeros(self._size)
        for block, off, value in zip(self.blocks, self._offsets, self._values(mol, atom)):
            x[off + block.index(value)] = 1
        x[-2] = float(atom.is_aromatic)
        x[-1] = 0.01 * atom.mass
        return x

    def featurize_mol(self, mol: Mol) -> np.ndarray:
        """Vectorized featurization of all atoms: ``[n_atoms, len(self)]``."""
        n = mol.num_atoms
        X = np.zeros((n, self._size))
        if n == 0:
            return X
        rows = np.arange(n)
        for block, off in zip(self.blocks, self._offsets):
            idxs = np.fromiter(
                (block.index(v) for v in self._column(mol, block.name)), dtype=np.int64, count=n
            )
            X[rows, off + idxs] = 1
        X[:, -2] = [float(a.is_aromatic) for a in mol.atoms]
        X[:, -1] = [0.01 * a.mass for a in mol.atoms]
        return X

    def _column(self, mol: Mol, name: str):
        if name == "atomic_num":
            return (a.atomic_num for a in mol.atoms)
        if name == "degree":
            return (mol.total_degree(a.idx) for a in mol.atoms)
        if name == "formal_charge":
            return (a.formal_charge for a in mol.atoms)
        if name == "chiral_tag":
            return (int(a.chiral_tag) for a in mol.atoms)
        if name == "num_hs":
            return (a.total_num_hs for a in mol.atoms)
        if name == "hybridization":
            return (int(a.hybridization) for a in mol.atoms)
        raise KeyError(name)

    def num_only(self, mol: Mol, atom: Atom) -> np.ndarray:
        """Only the atomic-number bit is set (used by the CGR featurizer for
        balanced-mode dummy atoms, cf. reference ``atom.py:113-123``)."""
        x = np.zeros(self._size)
        x[self.blocks[0].index(atom.atomic_num)] = 1
        return x

    # ------------------------------------------------------------- presets
    @classmethod
    def v1(cls, max_atomic_num: int = 100) -> "MultiHotAtomFeaturizer":
        """Chemprop V1 parameterization (133-d for the default max)."""
        return cls(
            atomic_nums=range(1, max_atomic_num + 1),
            degrees=range(6),
            formal_charges=[-1, -2, 1, 2, 0],
            chiral_tags=range(4),
            num_Hs=range(5),
            hybridizations=[
                HybridizationType.SP,
                HybridizationType.SP2,
                HybridizationType.SP3,
                HybridizationType.SP3D,
                HybridizationType.SP3D2,
            ],
        )

    @classmethod
    def v2(cls) -> "MultiHotAtomFeaturizer":
        """Default: first four periods + iodine (72-d)."""
        return cls(
            atomic_nums=list(range(1, 37)) + [53],
            degrees=range(6),
            formal_charges=[-1, -2, 1, 2, 0],
            chiral_tags=range(4),
            num_Hs=range(5),
            hybridizations=[
                HybridizationType.S,
                HybridizationType.SP,
                HybridizationType.SP2,
                HybridizationType.SP2D,
                HybridizationType.SP3,
                HybridizationType.SP3D,
                HybridizationType.SP3D2,
            ],
        )

    @classmethod
    def organic(cls) -> "MultiHotAtomFeaturizer":
        """Drug-like subset: H B C N O F Si P S Cl Br I (44-d)."""
        return cls(
            atomic_nums=[1, 5, 6, 7, 8, 9, 14, 15, 16, 17, 35, 53],
            degrees=range(6),
            formal_charges=[-1, -2, 1, 2, 0],
            chiral_tags=range(4),
            num_Hs=range(5),
            hybridizations=[
                HybridizationType.S,
                HybridizationType.SP,
                HybridizationType.SP2,
                HybridizationType.SP3,
            ],
        )


class RIGRAtomFeaturizer(MultiHotAtomFeaturizer):
    """Resonance-invariant features: atomic number, degree, H count, mass
    (52-d; cf. reference ``atom.py:204-264``)."""

    def __init__(
        self,
        atomic_nums: Sequence[int] | None = None,
        degrees: Sequence[int] | None = None,
        num_Hs: Sequence[int] | None = None,
    ):
        self.blocks = [
            _OneHotBlock(tuple(atomic_nums or list(range(1, 37)) + [53]), "atomic_num"),
            _OneHotBlock(tuple(degrees or range(6)), "degree"),
            _OneHotBlock(tuple(num_Hs or range(5)), "num_hs"),
        ]
        self._offsets = np.cumsum([0] + [b.width for b in self.blocks])
        self._size = int(self._offsets[-1]) + 1  # + mass

    def featurize(self, mol: Mol, atom: Atom) -> np.ndarray:
        x = np.zeros(self._size)
        values = [atom.atomic_num, mol.total_degree(atom.idx), atom.total_num_hs]
        for block, off, value in zip(self.blocks, self._offsets, values):
            x[off + block.index(value)] = 1
        x[-1] = 0.01 * atom.mass
        return x

    def featurize_mol(self, mol: Mol) -> np.ndarray:
        n = mol.num_atoms
        X = np.zeros((n, self._size))
        if n == 0:
            return X
        rows = np.arange(n)
        for block, off in zip(self.blocks, self._offsets):
            idxs = np.fromiter(
                (block.index(v) for v in self._column(mol, block.name)), dtype=np.int64, count=n
            )
            X[rows, off + idxs] = 1
        X[:, -1] = [0.01 * a.mass for a in mol.atoms]
        return X


class AtomFeatureMode(EnumMapping):
    V1 = auto()
    V2 = auto()
    ORGANIC = auto()
    RIGR = auto()


def get_multi_hot_atom_featurizer(mode: str | AtomFeatureMode) -> MultiHotAtomFeaturizer:
    match AtomFeatureMode.get(mode):
        case AtomFeatureMode.V1:
            return MultiHotAtomFeaturizer.v1()
        case AtomFeatureMode.V2:
            return MultiHotAtomFeaturizer.v2()
        case AtomFeatureMode.ORGANIC:
            return MultiHotAtomFeaturizer.organic()
        case AtomFeatureMode.RIGR:
            return RIGRAtomFeaturizer()
        case _:
            raise RuntimeError("unreachable")
