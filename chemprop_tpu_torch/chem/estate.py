"""Kier-Hall electrotopological state (E-State) indices.

The reference's ``rdkit_2d`` descriptor vector (via descriptastorus, cf.
reference ``chemprop/featurizers/molecule.py:53-99``) includes
``MaxEStateIndex``/``MinEStateIndex``/``MaxAbsEStateIndex``/
``MinAbsEStateIndex`` plus the ``EState_VSA*`` / ``VSA_EState*`` hybrid
families. This module implements the underlying per-atom E-State values from
the primary literature (Kier & Hall, "An Electrotopological-State Index for
Atoms in Molecules", Pharm. Res. 1990, 7, 801-807):

* intrinsic state   ``I_i = ((2/N_i)^2 * dv_i + 1) / d_i``
  with ``N`` the principal quantum number, ``dv = Zv - nH`` the valence
  delta, and ``d`` the count of heavy-atom connections;
* field perturbation ``dI_i = sum_j (I_i - I_j) / (p_ij + 1)^2`` over all
  connected heavy-atom pairs, ``p_ij`` the topological (bond-count) distance;
* E-State ``S_i = I_i + dI_i``.

Isolated atoms (``d == 0``) take intrinsic state 0, matching RDKit's guard.
"""

from __future__ import annotations

import numpy as np

from chemprop_tpu_torch.chem.mol import Mol
from chemprop_tpu_torch.chem.periodic_table import n_outer_electrons


def principal_quantum_number(atomic_num: int) -> int:
    for bound, n in ((2, 1), (10, 2), (18, 3), (36, 4), (54, 5), (86, 6)):
        if atomic_num <= bound:
            return n
    return 7


def intrinsic_states(mol: Mol) -> np.ndarray:
    """Per-heavy-atom Kier-Hall intrinsic state ``I``."""
    out = np.zeros(mol.num_atoms)
    for a in mol.atoms:
        d = mol.degree(a.idx)
        if d == 0:
            continue
        dv = max(n_outer_electrons(a.atomic_num) - a.total_num_hs, 0)
        n = principal_quantum_number(a.atomic_num)
        out[a.idx] = ((2.0 / n) ** 2 * dv + 1.0) / d
    return out


def estate_indices(mol: Mol) -> np.ndarray:
    """Per-heavy-atom E-State value ``S = I + dI``."""
    from chemprop_tpu_torch.chem.descriptors import distance_matrix

    I = intrinsic_states(mol)
    n = mol.num_atoms
    if n == 0:
        return I
    dmat = distance_matrix(mol)
    S = I.copy()
    # (I_i - I_j)/(d_ij+1)^2, summed over connected pairs only
    with np.errstate(divide="ignore", invalid="ignore"):
        diff = I[:, None] - I[None, :]
        p = (dmat + 1.0) ** 2
        contrib = np.where(np.isfinite(dmat) & (dmat > 0), diff / p, 0.0)
    S += contrib.sum(axis=1)
    return S
