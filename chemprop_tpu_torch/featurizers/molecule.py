"""Molecule-level descriptor featurizers producing extra datapoint descriptors
``x_d`` (cf. reference ``chemprop/featurizers/molecule.py:15-106``).

Morgan fingerprints come from the in-repo RDKit-bit-compatible
implementation (:mod:`chemprop_tpu_torch.chem.morgan_rdkit`): for ACHIRAL
molecules bit positions match RDKit's ``GetMorganGenerator`` exactly, so
reference checkpoints trained with Morgan extra descriptors transfer
unchanged. ``include_chirality=True`` (the reference default,
``chemprop/featurizers/molecule.py:19-27``) folds CIP codes and
double-bond stereo into the invariants per RDKit's algorithm; no chiral
RDKit golden exists in this environment, so that path is pinned by
self-fixtures (see chem/morgan_rdkit.py and
docs/chemistry_divergences.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from chemprop_tpu_torch.chem.mol import Mol
from chemprop_tpu_torch.chem.morgan_rdkit import rdkit_morgan_binary, rdkit_morgan_count
from chemprop_tpu_torch.utils.registry import ClassRegistry

MoleculeFeaturizerRegistry = ClassRegistry()


@dataclass
class MorganFeaturizerMixin:
    radius: int = 2
    length: int = 2048
    include_chirality: bool = True

    def __post_init__(self):
        if self.radius < 0:
            raise ValueError(f"radius must be >= 0, got {self.radius}")

    def __len__(self) -> int:
        return self.length


class BinaryFeaturizerMixin:
    """Presence/absence fingerprint output (cf. reference
    ``featurizers/molecule.py:32``)."""

    def __call__(self, mol: Mol) -> np.ndarray:
        return rdkit_morgan_binary(mol, self.radius, self.length, self.include_chirality)


class CountFeaturizerMixin:
    """Occurrence-count fingerprint output (cf. reference
    ``featurizers/molecule.py:37``)."""

    def __call__(self, mol: Mol) -> np.ndarray:
        return rdkit_morgan_count(mol, self.radius, self.length, self.include_chirality)


@MoleculeFeaturizerRegistry.register("morgan_binary")
class MorganBinaryFeaturizer(MorganFeaturizerMixin, BinaryFeaturizerMixin):
    pass


@MoleculeFeaturizerRegistry.register("morgan_count")
class MorganCountFeaturizer(MorganFeaturizerMixin, CountFeaturizerMixin):
    pass


@MoleculeFeaturizerRegistry.register("charge")
class ChargeFeaturizer:
    """Net formal charge as a single descriptor."""

    def __call__(self, mol: Mol) -> np.ndarray:
        return np.array([sum(a.formal_charge for a in mol.atoms)])

    def __len__(self) -> int:
        return 1


@MoleculeFeaturizerRegistry.register("rdkit_2d")
class RDKit2DFeaturizer:
    """RDKit's full ``Descriptors.descList`` vector — 217 values in the
    reference's pinned RDKit version, in descList (registration) order —
    matching the reference's ``rdkit_2d`` registry entry
    (``chemprop/featurizers/molecule.py:52-73``), so reference checkpoints
    trained with ``rdkit_2d`` conditioning shape-check and predict here.

    Values come from the in-repo :mod:`chemprop_tpu_torch.chem.descriptors`
    suite. All 17 descList-only descriptors (SPS, BCUT2D x8, AvgIpc,
    NumAmideBonds, stereocenter/bridgehead/spiro/heterocycle counts, Phi)
    plus 142 of the shared 200 are pinned EXACT against the reference's own
    RDKit-generated fixture (``tests/unit/chem/test_desclist_217.py``,
    ``test_rdkit2d_200.py``); the 58 VSA surface-area values are
    fixture-calibrated to within 0.01 (docs/chemistry_divergences.md)."""

    def __init__(self):
        from chemprop_tpu_torch.chem.descriptors import DESCLIST_NAMES

        self.names = list(DESCLIST_NAMES)

    def __call__(self, mol: Mol) -> np.ndarray:
        from chemprop_tpu_torch.chem.descriptors import compute_desclist

        return compute_desclist(mol)

    def __len__(self) -> int:
        return len(self.names)


@MoleculeFeaturizerRegistry.register("v1_rdkit_2d")
class V1RDKit2DFeaturizer:
    """The 200-descriptor descriptastorus RDKit2D vector in string-sorted
    order (reference ``chemprop/featurizers/molecule.py:76-92``). 142 of
    200 pinned EXACT against the reference's own RDKit fixture
    (``tests/unit/chem/test_rdkit2d_200.py``); the 58 VSA surface-area
    values are fixture-calibrated to within 0.01."""

    def __init__(self):
        from chemprop_tpu_torch.chem.descriptors import RDKIT2D_NAMES

        self.names = list(RDKIT2D_NAMES)

    def __call__(self, mol: Mol) -> np.ndarray:
        from chemprop_tpu_torch.chem.descriptors import compute_rdkit2d

        return compute_rdkit2d(mol)

    def __len__(self) -> int:
        return len(self.names)


@MoleculeFeaturizerRegistry.register("v1_rdkit_2d_normalized")
class V1RDKit2DNormalizedFeaturizer(V1RDKit2DFeaturizer):
    """The 200 descriptors squashed to (-1, 1) via x/(1+|x|) per dimension.

    The reference's normalized variant applies descriptastorus CDFs fit on a
    proprietary corpus; without that corpus a bounded monotone transform is
    used instead (documented deviation — dimensionality matches). Reference
    checkpoints conditioned on the NORMALIZED variant are therefore NOT
    zero-shot transferable (every input dimension shifts); the convert path
    flags them (models/torch_convert.py)."""

    def __call__(self, mol: Mol) -> np.ndarray:
        x = super().__call__(mol)
        return x / (1.0 + np.abs(x))
