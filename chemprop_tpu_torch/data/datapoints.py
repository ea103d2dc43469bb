"""Datapoint records (cf. ``chemprop_tpu/data/datapoints.py``): one sample is
a molecule with its targets ``y`` (NaN encodes a missing task) and a sample
``weight``. Extra features and descriptors are not ported yet."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.chem.mol import Mol


@dataclass
class MoleculeDatapoint:
    mol: Mol
    y: np.ndarray | None = None
    weight: float = 1.0
    name: str | None = None

    def __post_init__(self):
        if self.mol is None:
            raise ValueError("mol is required")
        if self.y is not None:
            self.y = np.asarray(self.y, dtype=np.float64)

    @classmethod
    def from_smi(
        cls,
        smi: str,
        *,
        keep_h: bool = False,
        add_h: bool = False,
        ignore_stereo: bool = False,
        reorder_atoms: bool = False,
        **kwargs,
    ) -> "MoleculeDatapoint":
        mol = make_mol(smi, keep_h, add_h, ignore_stereo, reorder_atoms)
        kwargs.setdefault("name", smi)
        return cls(mol=mol, **kwargs)
