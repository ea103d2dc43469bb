"""Gasteiger-Marsili PEOE partial charges.

The reference's ``rdkit_2d`` descriptor vector includes
``Max/Min(Abs)PartialCharge`` and the 14 ``PEOE_VSA*`` descriptors, all built
on RDKit's Gasteiger charges (reference ``chemprop/featurizers/molecule.py:
53-99`` via descriptastorus). This is a from-scratch implementation of the
original algorithm — Gasteiger & Marsili, "Iterative partial equalization of
orbital electronegativity", Tetrahedron 1980, 36, 3219-3228:

* orbital electronegativity ``chi(q) = a + b q + c q^2`` with the published
  (a, b, c) parameters per element/hybridization;
* per iteration ``n``, each bond transfers
  ``dq = (chi_j - chi_i) / chi_plus * (1/2)^n`` from the less to the more
  electronegative end, where ``chi_plus`` is the cation electronegativity of
  the less electronegative atom (H uses the special value 20.02);
* hydrogens participate as explicit pseudo-nodes; the returned array holds
  the heavy-atom charges (H charges are NOT folded in, matching RDKit's
  ``_GasteigerCharge`` property used by ``MaxPartialCharge`` etc.).

Atoms without parameters (metals etc.) keep their formal charge and do not
exchange with neighbors, a documented approximation (RDKit marks them NaN).
"""

from __future__ import annotations

import numpy as np

from chemprop_tpu_torch.chem.mol import HybridizationType, Mol

# (a, b, c) by (atomic_num, key); key is "sp3"/"sp2"/"sp" or "" for
# single-state elements. Values from Gasteiger & Marsili 1980, Table 1
# (P from the extended parameter set popularized by later implementations).
_PARAMS: dict[tuple[int, str], tuple[float, float, float]] = {
    (1, ""): (7.17, 6.24, -0.56),
    (6, "sp3"): (7.98, 9.18, 1.88),
    (6, "sp2"): (8.79, 9.32, 1.51),
    (6, "sp"): (10.39, 9.45, 0.73),
    (7, "sp3"): (11.54, 10.82, 1.36),
    (7, "sp2"): (12.87, 11.15, 0.85),
    (7, "sp"): (15.68, 11.70, -0.27),
    (8, "sp3"): (14.18, 12.92, 1.39),
    (8, "sp2"): (17.07, 13.79, 0.47),
    (9, ""): (14.66, 13.85, 2.31),
    (17, ""): (11.00, 9.69, 1.35),
    (35, ""): (10.08, 8.47, 1.16),
    (53, ""): (9.90, 7.96, 0.96),
    (16, ""): (10.14, 9.13, 1.38),
    (15, ""): (8.90, 8.24, 0.96),
}

_H_CHI_PLUS = 20.02

_SP3 = {HybridizationType.SP3}
_SP2 = {HybridizationType.SP2}
_SP = {HybridizationType.SP}


def _param_key(mol: Mol, idx: int) -> tuple[float, float, float] | None:
    a = mol.atoms[idx]
    z = a.atomic_num
    if (z, "") in _PARAMS:
        return _PARAMS[(z, "")]
    if z not in (6, 7, 8):
        return None
    hyb = a.hybridization
    if a.is_aromatic or hyb in _SP2:
        key = "sp2"
    elif hyb in _SP:
        key = "sp"
    else:
        key = "sp3"
    if z == 8 and key == "sp":  # no O(sp) entry: nearest is sp2
        key = "sp2"
    return _PARAMS.get((z, key))


def gasteiger_charges(mol: Mol, n_iter: int = 12) -> np.ndarray:
    """Per-heavy-atom PEOE partial charges (cf. RDKit
    ``ComputeGasteigerCharges``, 12 iterations)."""
    n_heavy = mol.num_atoms
    params: list[tuple[float, float, float] | None] = []
    q: list[float] = []
    # nodes: heavy atoms [0, n_heavy) then one pseudo-node per implicit H
    bonds: list[tuple[int, int]] = [
        (b.begin_atom_idx, b.end_atom_idx) for b in mol.bonds
    ]
    for a in mol.atoms:
        params.append(_param_key(mol, a.idx))
        q.append(float(a.formal_charge))
    for a in mol.atoms:
        for _ in range(a.total_num_hs):
            h = len(q)
            params.append(_PARAMS[(1, "")])
            q.append(0.0)
            bonds.append((a.idx, h))

    qa = np.array(q)
    damp = 1.0
    for _ in range(n_iter):
        damp *= 0.5
        chi = np.array(
            [
                (p[0] + p[1] * qi + p[2] * qi * qi) if p is not None else np.nan
                for p, qi in zip(params, qa)
            ]
        )
        dq = np.zeros_like(qa)
        for i, j in bonds:
            ci, cj = chi[i], chi[j]
            if not (np.isfinite(ci) and np.isfinite(cj)) or ci == cj:
                continue
            lo, hi = (i, j) if ci < cj else (j, i)
            p_lo = params[lo]
            chi_plus = (
                _H_CHI_PLUS
                if lo >= n_heavy or mol.atoms[lo].atomic_num == 1
                else p_lo[0] + p_lo[1] + p_lo[2]
            )
            t = abs(cj - ci) / chi_plus * damp
            dq[lo] += t
            dq[hi] -= t
        qa += dq
    return qa[:n_heavy]


def max_min_partial_charges(mol: Mol) -> tuple[float, float]:
    """(MaxPartialCharge, MinPartialCharge) over heavy atoms."""
    ch = gasteiger_charges(mol)
    if ch.size == 0:
        return 0.0, 0.0
    return float(ch.max()), float(ch.min())
