"""Datapoint records (cf. ``chemprop_tpu/data/datapoints.py``): one sample is
a molecule with its targets ``y`` (NaN encodes a missing task), a sample
``weight`` and optional extra inputs: molecule descriptors ``x_d``, extra atom
and bond features ``V_f`` and ``E_f`` (concatenated to the featurizer's
before message passing) and atom descriptors ``V_d`` (after it). NaNs in the
extra inputs become 0; targets keep them."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.chem.mol import Mol


def _nan_to_zero(x: np.ndarray | None) -> np.ndarray | None:
    if x is not None:
        x = np.array(x, dtype=np.float64)
        x[np.isnan(x)] = 0
    return x


@dataclass
class MoleculeDatapoint:
    mol: Mol
    y: np.ndarray | None = None
    weight: float = 1.0
    name: str | None = None
    x_d: np.ndarray | None = None
    V_f: np.ndarray | None = None
    E_f: np.ndarray | None = None
    V_d: np.ndarray | None = None

    def __post_init__(self):
        if self.mol is None:
            raise ValueError("mol is required")
        if self.y is not None:
            self.y = np.asarray(self.y, dtype=np.float64)
        self.x_d, self.V_f, self.E_f, self.V_d = map(
            _nan_to_zero, (self.x_d, self.V_f, self.E_f, self.V_d))

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
