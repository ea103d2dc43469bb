"""Multi-hot bond featurization (layout-compatible with reference
``chemprop/featurizers/bond.py:9-130``): null bit | bond-type one-hot
(no unknown pad) | conjugated | in-ring | stereo one-hot (with unknown pad).
Default width 14; RIGR variant is [null, in-ring] (width 2)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from chemprop_tpu_torch.chem.mol import Bond, BondType, Mol


class MultiHotBondFeaturizer:
    def __init__(
        self,
        bond_types: Sequence[BondType] | None = None,
        stereos: Sequence[int] | None = None,
    ):
        self.bond_types = list(
            bond_types
            or [BondType.SINGLE, BondType.DOUBLE, BondType.TRIPLE, BondType.AROMATIC]
        )
        self.stereo = list(stereos or range(6))

    def __len__(self) -> int:
        return 1 + len(self.bond_types) + 2 + len(self.stereo) + 1

    def featurize(self, mol: Mol, bond: Bond | None) -> np.ndarray:
        x = np.zeros(len(self))
        if bond is None:
            x[0] = 1
            return x
        i = 1
        try:
            x[i + self.bond_types.index(bond.bond_type)] = 1
        except ValueError:
            pass  # unknown bond type: no bit set (matches reference semantics)
        i += len(self.bond_types)
        x[i] = float(bond.is_conjugated)
        x[i + 1] = float(bond.is_in_ring)
        i += 2
        stereo = int(bond.stereo)
        j = self.stereo.index(stereo) if stereo in self.stereo else len(self.stereo)
        x[i + j] = 1
        return x

    def featurize_mol(self, mol: Mol) -> np.ndarray:
        """``[n_bonds, len(self)]`` feature block for all bonds."""
        return np.stack(
            [self.featurize(mol, b) for b in mol.bonds], axis=0
        ) if mol.num_bonds else np.zeros((0, len(self)))

    __call__ = featurize


class RIGRBondFeaturizer:
    """Resonance-invariant bond features: [null, in-ring]."""

    def __len__(self) -> int:
        return 2

    def featurize(self, mol: Mol, bond: Bond | None) -> np.ndarray:
        x = np.zeros(2)
        if bond is None:
            x[0] = 1
        else:
            x[1] = float(bond.is_in_ring)
        return x

    def featurize_mol(self, mol: Mol) -> np.ndarray:
        return np.stack(
            [self.featurize(mol, b) for b in mol.bonds], axis=0
        ) if mol.num_bonds else np.zeros((0, 2))

    __call__ = featurize
