"""Molecule -> MolGraph featurization (cf. reference
``chemprop/featurizers/molgraph/molecule.py:17-92``).

Each bond emits two directed edges stored adjacently (u->v at 2k, v->u at
2k+1), so ``rev_edge_index`` is the pairwise swap permutation. A zero-atom
molecule produces a single all-zero atom row (keeps downstream aggregation
well-defined). Atom features are emitted in one vectorized pass per molecule.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from chemprop_tpu_torch.chem.mol import Mol
from chemprop_tpu_torch.types import MolGraph
from chemprop_tpu_torch.featurizers.atom import MultiHotAtomFeaturizer
from chemprop_tpu_torch.featurizers.bond import MultiHotBondFeaturizer


@dataclass
class SimpleMoleculeMolGraphFeaturizer:
    atom_featurizer: MultiHotAtomFeaturizer = field(default_factory=MultiHotAtomFeaturizer.v2)
    bond_featurizer: MultiHotBondFeaturizer = field(default_factory=MultiHotBondFeaturizer)
    extra_atom_fdim: int = 0
    extra_bond_fdim: int = 0

    def __post_init__(self):
        self.atom_fdim = len(self.atom_featurizer) + self.extra_atom_fdim
        self.bond_fdim = len(self.bond_featurizer) + self.extra_bond_fdim

    @property
    def shape(self) -> tuple[int, int]:
        return self.atom_fdim, self.bond_fdim

    def __call__(
        self,
        mol: Mol,
        atom_features_extra: np.ndarray | None = None,
        bond_features_extra: np.ndarray | None = None,
    ) -> MolGraph:
        n_atoms, n_bonds = mol.num_atoms, mol.num_bonds

        if atom_features_extra is not None and len(atom_features_extra) != n_atoms:
            raise ValueError(
                f"atom_features_extra has {len(atom_features_extra)} rows for {n_atoms} atoms"
            )
        if bond_features_extra is not None and len(bond_features_extra) != n_bonds:
            raise ValueError(
                f"bond_features_extra has {len(bond_features_extra)} rows for {n_bonds} bonds"
            )

        if n_atoms == 0:
            V = np.zeros((1, self.atom_fdim), dtype=np.float32)
        else:
            V = self.atom_featurizer.featurize_mol(mol).astype(np.float32)
            if atom_features_extra is not None:
                V = np.hstack((V, atom_features_extra.astype(np.float32)))

        E = np.empty((2 * n_bonds, self.bond_fdim), dtype=np.float32)
        src = np.empty(2 * n_bonds, dtype=np.int32)
        dst = np.empty(2 * n_bonds, dtype=np.int32)
        if n_bonds:
            Eb = self.bond_featurizer.featurize_mol(mol)
            if bond_features_extra is not None:
                Eb = np.hstack((Eb, bond_features_extra))
            # duplicate each bond row for its two directed edges
            E[0::2] = Eb
            E[1::2] = Eb
            begins = np.fromiter((b.begin_atom_idx for b in mol.bonds), np.int32, n_bonds)
            ends = np.fromiter((b.end_atom_idx for b in mol.bonds), np.int32, n_bonds)
            src[0::2] = begins
            src[1::2] = ends
            dst[0::2] = ends
            dst[1::2] = begins

        edge_index = np.stack([src, dst])
        rev_edge_index = np.arange(2 * n_bonds, dtype=np.int32).reshape(-1, 2)[:, ::-1].ravel()

        return MolGraph(V, E, edge_index, rev_edge_index)
