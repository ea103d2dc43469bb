"""2D molecular descriptors computed on the in-repo :class:`Mol` substrate.

The reference exposes RDKit/descriptastorus descriptor featurizers
(``chemprop/featurizers/molecule.py:53-99``) as molecule-level extra
descriptors ``x_d``. The port, like the JAX package (whose
``chemprop_tpu/chem/descriptors.py`` this module copies), ships no RDKit, so the descriptor
set is implemented here from the primary literature:

* **Crippen LogP / MR** — Wildman & Crippen, J. Chem. Inf. Comput. Sci. 1999,
  39, 868-873 (atom-contribution method; the same scheme RDKit's ``MolLogP``/
  ``MolMR`` implement). Atom typing is a rule engine over the perceived
  molecular graph instead of SMARTS matching.
* **TPSA** — Ertl, Rohde & Selzer, J. Med. Chem. 2000, 43, 3714-3717
  (N/O contributions; S/P optionally, off by default like RDKit).
* **Kier-Hall connectivity (Chi) and shape (Kappa) indices, Hall-Kier
  alpha** — Kier & Hall, "Molecular Connectivity in Structure-Activity
  Analysis", 1986.
* **Balaban J** — Balaban, Chem. Phys. Lett. 1982, 89, 399-404.
* Constitutional counts (rings, rotatable bonds, H donors/acceptors,
  heteroatoms, fraction Csp3, ...) following the standard (Lipinski-style)
  definitions.

Values are validated against published/RDKit reference numbers in
``tests/unit/chem/test_descriptors.py`` (methane/benzene/phenol/water LogP,
benzene MR, aspirin/pyridine/aniline TPSA, benzene kappa indices).
"""

from __future__ import annotations

from collections import deque
from typing import Callable

import numpy as np

from chemprop_tpu_torch.chem.mol import Atom, Bond, BondType, HybridizationType, Mol
from chemprop_tpu_torch.chem.periodic_table import MASSES, n_outer_electrons

# --------------------------------------------------------------------------
# small graph helpers
# --------------------------------------------------------------------------

_HET = {7, 8, 15, 16, 9, 17, 35, 53}  # N O P S F Cl Br I
_HALOGENS = {9, 17, 35, 53}


def _heavy_neighbors(mol: Mol, idx: int) -> list[Atom]:
    return [mol.atoms[j] for j in mol.neighbors(idx)]


def _bond_orders(mol: Mol, idx: int) -> list[BondType]:
    return [b.bond_type for b in mol.atom_bonds(idx)]


def _has_double_to(mol: Mol, idx: int, pred) -> bool:
    for b in mol.atom_bonds(idx):
        if b.bond_type == BondType.DOUBLE and pred(mol.atoms[b.other_atom_idx(idx)]):
            return True
    return False


def _is_sp3_carbon(mol: Mol, a: Atom) -> bool:
    return (
        a.atomic_num == 6
        and not a.is_aromatic
        and all(b.bond_type in (BondType.SINGLE,) for b in mol.atom_bonds(a.idx))
    )


def distance_matrix(mol: Mol) -> np.ndarray:
    """All-pairs topological distances by BFS (float; inf across components)."""
    n = mol.num_atoms
    D = np.full((n, n), np.inf)
    adj = [mol.neighbors(i) for i in range(n)]
    for s in range(n):
        D[s, s] = 0.0
        q = deque([s])
        while q:
            u = q.popleft()
            for v in adj[u]:
                if D[s, v] == np.inf:
                    D[s, v] = D[s, u] + 1
                    q.append(v)
    return D


def _n_components(mol: Mol) -> int:
    n = mol.num_atoms
    seen = [False] * n
    comps = 0
    for s in range(n):
        if seen[s]:
            continue
        comps += 1
        q = deque([s])
        seen[s] = True
        while q:
            u = q.popleft()
            for v in mol.neighbors(u):
                if not seen[v]:
                    seen[v] = True
                    q.append(v)
    return comps


# --------------------------------------------------------------------------
# Crippen LogP / MR (Wildman & Crippen 1999)
# --------------------------------------------------------------------------
# (logp, mr) contribution per atom type. Types follow Table 1 of the paper.
_CRIPPEN: dict[str, tuple[float, float]] = {
    "C1": (0.1441, 2.503),
    "C2": (0.0000, 2.433),
    "C3": (-0.2035, 2.753),
    "C4": (-0.2051, 2.731),
    "C5": (-0.2783, 5.007),
    "C6": (0.1551, 3.513),
    "C7": (0.0017, 3.888),
    "C8": (0.08452, 2.464),
    "C9": (-0.1444, 2.412),
    "C10": (-0.0516, 2.488),
    "C11": (0.1193, 2.582),
    "C12": (-0.0967, 2.576),
    "C13": (-0.5443, 4.041),
    "C14": (0.0, 3.257),
    "C15": (0.245, 3.564),
    "C16": (0.198, 3.180),
    "C17": (0.0, 3.104),
    "C18": (0.1581, 3.350),
    "C19": (0.2955, 4.346),
    "C20": (0.2713, 3.904),
    "C21": (0.136, 3.509),
    "C22": (0.4619, 4.067),
    "C23": (0.5437, 3.853),
    "C24": (0.1893, 2.673),
    "C25": (-0.8186, 3.135),
    "C26": (0.2640, 4.305),
    "C27": (0.2148, 2.693),
    "CS": (0.08129, 3.243),
    "H1": (0.1230, 1.057),
    "H2": (-0.2677, 1.395),
    "H3": (0.2142, 0.9627),
    "H4": (0.2980, 1.805),
    "HS": (0.1125, 1.112),
    "N1": (-1.0190, 2.262),
    "N2": (-0.7096, 2.173),
    "N3": (-1.0270, 2.827),
    "N4": (-0.5188, 3.000),
    "N5": (0.08387, 1.757),
    "N6": (0.1836, 2.428),
    "N7": (-0.3187, 1.839),
    "N8": (-0.4458, 2.819),
    "N9": (0.01508, 1.725),
    "N10": (-1.950, 2.134),
    "N11": (-0.3239, 2.202),
    "N12": (-1.119, 2.134),
    "N13": (-0.3396, 0.2604),
    "N14": (0.2887, 3.359),
    "NS": (-0.4806, 2.134),
    "O1": (0.1552, 1.080),
    "O2": (-0.2893, 0.8238),
    "O3": (-0.0684, 1.085),
    "O4": (-0.4195, 1.182),
    "O5": (0.0335, 3.367),
    "O6": (-0.3339, 0.7774),
    "O7": (-1.189, 0.0),
    "O8": (0.1788, 3.135),
    "O9": (-0.1526, 0.0),
    "O10": (0.1129, 0.2215),
    "O11": (0.4833, 0.389),
    "O12": (-1.326, 0.0),
    "OS": (-0.1188, 0.6865),
    "F": (0.4202, 1.108),
    "Cl": (0.6895, 5.853),
    "Br": (0.8456, 8.927),
    "I": (0.8857, 14.02),
    "Hal": (-2.996, 5.754),
    "P": (0.8612, 6.920),
    "S1": (0.6482, 7.591),
    "S2": (-0.0024, 7.365),
    "S3": (0.6237, 6.691),
    "Me1": (-0.3808, 5.754),
    "Me2": (-0.0025, 5.754),
}

_ME1 = {3, 4, 11, 12, 19, 20, 13, 31, 49, 81, 32, 50, 82, 51, 83, 84, 85}  # main group
# everything else metallic -> Me2 (transition/lanthanide)


def _crippen_carbon(mol: Mol, a: Atom) -> str:
    i = a.idx
    nbrs = _heavy_neighbors(mol, i)
    nH = a.total_num_hs
    if a.is_aromatic:
        if nH >= 1:
            return "C18"
        # substituent through the one non-aromatic connection (ring fusion -> C19)
        ext: list[tuple[Bond, Atom]] = [
            (b, mol.atoms[b.other_atom_idx(i)])
            for b in mol.atom_bonds(i)
            if b.bond_type != BondType.AROMATIC
        ]
        if not ext:
            return "C19"  # aromatic bridgehead [c](:a)(:a):a
        b, x = ext[0]
        if b.bond_type == BondType.DOUBLE:
            return "C25"  # exocyclic double bond
        if x.is_aromatic:
            return "C20"  # aryl-aryl single bond
        z = x.atomic_num
        if z == 9:
            return "C14"
        if z == 17:
            return "C15"
        if z == 35:
            return "C16"
        if z == 53:
            return "C17"
        if z == 6:
            return "C21"
        if z == 7:
            return "C22"
        if z == 8:
            return "C23"
        if z == 16:
            return "C24"
        return "C13"  # unusual aliphatic substituent
    orders = _bond_orders(mol, i)
    if all(o == BondType.SINGLE for o in orders):  # sp3 (CX4)
        if nbrs and all(n.atomic_num == 6 and not n.is_aromatic for n in nbrs):
            return "C1" if nH >= 2 else "C2"
        if not nbrs:
            return "C1"  # CH4
        if any(n.atomic_num in _HET and not n.is_aromatic for n in nbrs):
            return "C3" if nH >= 2 else "C4"
        if any(n.is_aromatic for n in nbrs):
            arom_c = any(n.is_aromatic and n.atomic_num == 6 for n in nbrs)
            if nH == 3:
                return "C8" if arom_c else "C9"
            if nH == 2:
                return "C10"
            if nH == 1:
                return "C11"
            return "C12"
        return "C27" if any(n.atomic_num != 6 for n in nbrs) else "CS"
    # multiple bonds present: sp2 / sp
    if any(o == BondType.TRIPLE for o in orders):
        return "C7"
    dbl_partners = [
        mol.atoms[b.other_atom_idx(i)]
        for b in mol.atom_bonds(i)
        if b.bond_type == BondType.DOUBLE
    ]
    if any(p.atomic_num != 6 and not p.is_aromatic for p in dbl_partners):
        return "C5"  # C=O, C=N, C=S ...
    if any(p.is_aromatic for p in dbl_partners):
        return "C26"  # C=c
    if len(dbl_partners) == 2:
        return "C6"  # allene center [C](=C)=C
    # C=C; aromatic substituent promotes to C26
    if any(n.is_aromatic for n in nbrs):
        return "C26"
    # allene terminus: double bond to an sp carbon
    if any(
        sum(1 for o in _bond_orders(mol, p.idx) if o == BondType.DOUBLE) == 2
        for p in dbl_partners
    ):
        return "C7"
    return "C6"


def _crippen_nitrogen(mol: Mol, a: Atom) -> str:
    i = a.idx
    nH = a.total_num_hs
    chg = a.formal_charge
    if a.is_aromatic:
        if chg > 0:
            return "N12"
        if chg < 0:
            return "N14"
        return "N11"
    nbrs = _heavy_neighbors(mol, i)
    orders = _bond_orders(mol, i)
    if chg < 0:
        return "N14"
    if chg > 0:
        if nH >= 1 and all(o == BondType.SINGLE for o in orders):
            return "N10"
        if any(o == BondType.TRIPLE for o in orders):
            return "N14"
        # azide-style / quaternary and =N+ types
        if any(o == BondType.DOUBLE for o in orders) and any(
            n.formal_charge < 0 for n in nbrs
        ):
            return "N14"
        return "N13"
    if any(o == BondType.TRIPLE for o in orders):
        return "N9"
    has_dbl = any(o == BondType.DOUBLE for o in orders)
    arom_nbr = any(n.is_aromatic for n in nbrs)
    if has_dbl:
        return "N5" if nH >= 1 else "N6"
    if nH >= 2:
        return "N3" if arom_nbr else "N1"
    if nH == 1:
        return "N4" if arom_nbr else "N2"
    return "N8" if arom_nbr else "N7"


def _crippen_oxygen(mol: Mol, a: Atom) -> str:
    i = a.idx
    nH = a.total_num_hs
    if a.is_aromatic:
        return "O1"
    nbrs = _heavy_neighbors(mol, i)
    orders = _bond_orders(mol, i)
    if a.formal_charge < 0:
        # carboxylate / phosphate-style O-
        for n in nbrs:
            if n.atomic_num == 6 and _has_double_to(
                mol, n.idx, lambda x: x.atomic_num == 8
            ):
                return "O12"
            if n.atomic_num in (7, 8):
                return "O5"
            if n.atomic_num == 16:
                return "O6"
        return "O7"
    if nH >= 1:
        return "O2"  # hydroxyl / water
    if any(o == BondType.DOUBLE for o in orders):
        n = nbrs[0]
        if n.atomic_num in (7, 8):
            return "O5"  # nitro / N-oxide / O=O
        if n.atomic_num == 16:
            return "O6"  # S=O
        if n.is_aromatic:
            return "O8"  # O=c
        if n.atomic_num == 6:
            heavy = [x for x in _heavy_neighbors(mol, n.idx) if x.idx != i]
            n_nonC = sum(1 for x in heavy if x.atomic_num != 6)
            n_arom = sum(1 for x in heavy if x.is_aromatic)
            if len(heavy) == 2 and n_nonC == 2:
                return "O11"  # urea / carbamate / carbonate C=O
            if n_arom:
                return "O10"  # aryl ketone / benzamide C=O
            return "O9"  # aliphatic aldehyde/ketone/acid/ester C=O
        return "O7"
    # ether-type oxygen (two single bonds, no H)
    if nbrs and all(n.atomic_num == 6 and not n.is_aromatic for n in nbrs):
        return "O3"
    if any(n.is_aromatic for n in nbrs):
        return "O4"
    return "OS"


def _crippen_type(mol: Mol, a: Atom) -> str:
    z = a.atomic_num
    if z == 6:
        return _crippen_carbon(mol, a)
    if z == 7:
        return _crippen_nitrogen(mol, a)
    if z == 8:
        return _crippen_oxygen(mol, a)
    if z == 9:
        return "F" if a.formal_charge == 0 and mol.degree(a.idx) else "Hal"
    if z == 17:
        return "Cl" if a.formal_charge == 0 and mol.degree(a.idx) else "Hal"
    if z == 35:
        return "Br" if a.formal_charge == 0 and mol.degree(a.idx) else "Hal"
    if z == 53:
        return "I" if a.formal_charge == 0 and mol.degree(a.idx) else "Hal"
    if z == 15:
        return "P"
    if z == 16:
        if a.is_aromatic:
            return "S3"
        return "S2" if a.formal_charge != 0 else "S1"
    if z == 1:
        return "HS"
    if z in _ME1:
        return "Me1"
    return "Me2"


def _crippen_hydrogen(mol: Mol, heavy: Atom) -> str:
    """Type of the hydrogens attached to ``heavy``."""
    z = heavy.atomic_num
    if z == 6:
        return "H1"
    if z == 7:
        return "H3"
    if z == 8:
        nbrs = _heavy_neighbors(mol, heavy.idx)
        if not nbrs:
            return "H2"  # water
        n = nbrs[0]
        if n.atomic_num == 7:
            return "H3"  # H-O-N
        if n.atomic_num in (8, 16):
            return "H4"  # peroxide / H-O-S
        if n.atomic_num == 6 and any(
            b.bond_type == BondType.DOUBLE for b in mol.atom_bonds(n.idx)
        ):
            return "H4"  # acid / enol
        return "H2"
    return "H2"  # [#1][!C;!N;!O]


def crippen_atom_contribs(mol: Mol) -> tuple[np.ndarray, np.ndarray]:
    """Per-heavy-atom Wildman-Crippen (logP, MR) contributions, with each
    atom's hydrogen contributions folded into it — the convention MolLogP/
    MolMR sum over. NOTE: the SlogP_VSA/SMR_VSA families do NOT bin by
    this; they bin by the OWN-TYPE contribution without H folding
    (:func:`crippen_own_contribs` — the r5 fixture inversion showed RDKit's
    bin membership matches only that convention)."""
    logp = np.zeros(mol.num_atoms)
    mr = np.zeros(mol.num_atoms)
    for a in mol.atoms:
        lp, m = _CRIPPEN[_crippen_type(mol, a)]
        nH = a.total_num_hs
        if nH:
            lp_h, m_h = _CRIPPEN[_crippen_hydrogen(mol, a)]
            lp += nH * lp_h
            m += nH * m_h
        logp[a.idx] = lp
        mr[a.idx] = m
    return logp, mr


def crippen_own_contribs(mol: Mol) -> tuple[np.ndarray, np.ndarray]:
    """Per-atom OWN-TYPE Wildman-Crippen (logP, MR) contributions — NO
    implicit-H folding. This is the convention RDKit's BCUT2D diagonals AND
    the SlogP_VSA/SMR_VSA binning keys use (both fixture-verified exactly;
    the H-folded variant above is what the total MolLogP/MolMR sum over)."""
    logp = np.zeros(mol.num_atoms)
    mr = np.zeros(mol.num_atoms)
    for a in mol.atoms:
        logp[a.idx], mr[a.idx] = _CRIPPEN[_crippen_type(mol, a)]
    return logp, mr


def crippen_logp_mr(mol: Mol) -> tuple[float, float]:
    """Wildman-Crippen octanol/water logP and molar refractivity."""
    logp, mr = crippen_atom_contribs(mol)
    return float(logp.sum()), float(mr.sum())


# --------------------------------------------------------------------------
# TPSA (Ertl 2000)
# --------------------------------------------------------------------------


def tpsa(mol: Mol, include_s_p: bool = False) -> float:
    """Topological polar surface area from N/O (optionally S/P) fragment
    contributions (Ertl et al. 2000, Table 1)."""
    total = 0.0
    for a in mol.atoms:
        z = a.atomic_num
        if z not in (7, 8) and not (include_s_p and z in (15, 16)):
            continue
        i = a.idx
        nH = a.total_num_hs
        chg = a.formal_charge
        bonds = mol.atom_bonds(i)
        n_single = sum(1 for b in bonds if b.bond_type == BondType.SINGLE)
        n_double = sum(1 for b in bonds if b.bond_type == BondType.DOUBLE)
        n_triple = sum(1 for b in bonds if b.bond_type == BondType.TRIPLE)
        n_arom = sum(1 for b in bonds if b.bond_type == BondType.AROMATIC)
        in3ring = any(len(r) == 3 for r in getattr(mol, "rings", []) if i in r)

        # charge-separated nitro groups are scored in their pentavalent
        # neutral form (RDKit convention): N -> 11.68, both O -> 17.07
        def _is_nitro_n(atom: Atom) -> bool:
            if atom.atomic_num != 7 or atom.formal_charge != 1:
                return False
            bs = mol.atom_bonds(atom.idx)
            o_minus = o_dbl = 0
            for b in bs:
                x = mol.atoms[b.other_atom_idx(atom.idx)]
                if x.atomic_num == 8 and x.formal_charge == -1 and b.bond_type == BondType.SINGLE:
                    o_minus += 1
                elif x.atomic_num == 8 and b.bond_type == BondType.DOUBLE:
                    o_dbl += 1
            return o_minus == 1 and o_dbl == 1

        c = None
        if z == 8 and chg == -1 and any(
            _is_nitro_n(mol.atoms[b.other_atom_idx(i)]) for b in bonds
        ):
            total += 17.07
            continue
        if z == 7 and _is_nitro_n(a):
            total += 11.68
            continue
        if z == 7:
            if a.is_aromatic:
                if chg == 0:
                    if nH == 0:
                        if n_arom == 2 and n_single == 0 and n_double == 0:
                            c = 12.89  # [n](:a):a
                        elif n_arom == 3:
                            c = 4.41  # [n](:a)(:a):a
                        elif n_arom == 2 and n_single == 1:
                            c = 4.93  # [n](-*)(:a):a
                        elif n_arom == 2 and n_double == 1:
                            c = 8.39  # [n](=*)(:a):a
                    elif nH == 1:
                        c = 15.79  # [nH]
                elif chg > 0:
                    if nH == 0:
                        c = 4.10 if n_arom == 3 else 3.88
                    elif nH == 1:
                        c = 14.14
            else:
                if chg == 0:
                    if n_triple == 1 and n_single == 0:
                        c = 23.79  # N#*
                    elif n_double == 1 and n_triple == 1:
                        c = 13.60  # =N#
                    elif nH == 0:
                        if n_single == 3:
                            c = 3.01 if in3ring else 3.24
                        elif n_single == 1 and n_double == 1:
                            c = 12.36
                        elif n_single == 2 and n_double == 1:
                            c = 11.68  # nitro-style N(-*)(=*)=* handled below
                        elif n_double == 2 and n_single == 1:
                            c = 11.68
                    elif nH == 1:
                        if n_single == 2:
                            c = 21.94 if in3ring else 12.03
                        elif n_double == 1:
                            c = 23.85
                    elif nH == 2:
                        c = 26.02
                elif chg > 0:
                    if nH == 0:
                        if n_single == 4:
                            c = 0.0
                        elif n_single == 2 and n_double == 1:
                            c = 3.01
                        elif n_triple == 1:
                            c = 4.36
                    elif nH == 1:
                        if n_single == 3:
                            c = 4.44
                        elif n_double == 1:
                            c = 13.97
                    elif nH == 2:
                        c = 16.61 if n_single == 2 else 25.59
                    elif nH == 3:
                        c = 27.64
            if c is None:
                # Ertl's generic N fallback
                c = 30.5 - mol.degree(i) * 8.2 + nH * 1.5
                c = max(c, 0.0)
        elif z == 8:
            if a.is_aromatic:
                c = 13.14
            elif chg == 0:
                if nH >= 1:
                    c = 20.23
                elif n_double == 1:
                    c = 17.07
                elif n_single == 2:
                    c = 12.53 if in3ring else 9.23
            elif chg < 0:
                c = 23.06
            if c is None:
                c = 28.5 - mol.degree(i) * 8.6 + nH * 1.5
                c = max(c, 0.0)
        elif z == 16:
            if a.is_aromatic:
                c = 21.70 if n_double == 1 else 28.24
            elif nH == 1:
                c = 38.80
            elif n_single == 2 and n_double == 0:
                c = 25.30
            elif n_double == 1 and n_single == 0:
                c = 32.09
            elif n_single == 2 and n_double == 1:
                c = 19.21
            elif n_single == 2 and n_double == 2:
                c = 8.38
            else:
                c = 0.0
        else:  # P
            if n_single == 3 and n_double == 0:
                c = 13.59
            elif n_single == 1 and n_double == 1:
                c = 34.14
            elif n_single == 3 and n_double == 1:
                c = 9.81
            elif nH == 1 and n_single == 2 and n_double == 1:
                c = 23.47
            else:
                c = 0.0
        total += c
    return total


# --------------------------------------------------------------------------
# Kier-Hall indices
# --------------------------------------------------------------------------

# alpha contributions (covalent-radius ratio - 1) per element/hybridization
_ALPHA = {
    (6, HybridizationType.SP3): 0.0,
    (6, HybridizationType.SP2): -0.13,
    (6, HybridizationType.SP): -0.22,
    (7, HybridizationType.SP3): -0.04,
    (7, HybridizationType.SP2): -0.20,
    (7, HybridizationType.SP): -0.29,
    (8, HybridizationType.SP3): -0.04,
    (8, HybridizationType.SP2): -0.20,
    (9, None): -0.07,
    (15, None): 0.43,
    (16, HybridizationType.SP3): 0.35,
    (16, HybridizationType.SP2): 0.22,
    (17, None): 0.29,
    (35, None): 0.48,
    (53, None): 0.73,
}


def hall_kier_alpha(mol: Mol) -> float:
    total = 0.0
    for a in mol.atoms:
        key = (a.atomic_num, a.hybridization)
        if key in _ALPHA:
            total += _ALPHA[key]
        elif (a.atomic_num, None) in _ALPHA:
            total += _ALPHA[(a.atomic_num, None)]
        # carbon sp3 and unknown elements contribute 0
    return total


def _kappa(mol: Mol, k: int) -> float:
    A = mol.num_atoms
    alpha = hall_kier_alpha(mol)
    if k == 1:
        P = mol.num_bonds
        denom = (P + alpha) ** 2
        return (A + alpha) * (A + alpha - 1) ** 2 / denom if denom else 0.0
    P = len(_paths_of_length(mol, k))
    denom = (P + alpha) ** 2
    if P == 0 or denom <= 0:
        return 0.0
    if k == 2:
        return (A + alpha - 1) * (A + alpha - 2) ** 2 / denom
    if A % 2:
        return (A + alpha - 1) * (A + alpha - 3) ** 2 / denom
    return (A + alpha - 3) * (A + alpha - 2) ** 2 / denom


def kappa1(mol: Mol) -> float:
    return _kappa(mol, 1)


def kappa2(mol: Mol) -> float:
    return _kappa(mol, 2)


def kappa3(mol: Mol) -> float:
    return _kappa(mol, 3)


def _simple_deltas(mol: Mol) -> np.ndarray:
    return np.array([mol.degree(i) for i in range(mol.num_atoms)], dtype=float)


def _valence_deltas(mol: Mol) -> np.ndarray:
    """Kier-Hall valence delta: (Zv - h) for row 2, (Zv - h)/(Z - Zv - 1) below."""
    out = np.zeros(mol.num_atoms)
    for a in mol.atoms:
        z = a.atomic_num
        zv = n_outer_electrons(z)
        h = a.total_num_hs
        if z <= 10:
            out[a.idx] = max(zv - h, 0)
        else:
            out[a.idx] = (zv - h) / (z - zv - 1.0) if z - zv - 1 else max(zv - h, 0)
    return out


def _paths_of_length(mol: Mol, k: int) -> list[tuple[int, ...]]:
    """Simple paths with k bonds (each path counted once)."""
    if k == 0:
        return [(i,) for i in range(mol.num_atoms)]
    paths = []

    def extend(path: tuple[int, ...]):
        if len(path) == k + 1:
            if path[0] < path[-1] or (path[0] == path[-1]):
                paths.append(path)
            return
        for v in mol.neighbors(path[-1]):
            if v not in path:
                extend(path + (v,))

    for s in range(mol.num_atoms):
        extend((s,))
    return paths


def _chi(mol: Mol, k: int, deltas: np.ndarray) -> float:
    total = 0.0
    for path in _paths_of_length(mol, k):
        prod = float(np.prod(deltas[list(path)]))
        if prod > 0:
            total += prod**-0.5
    return total


def chi0(mol: Mol) -> float:
    d = _simple_deltas(mol)
    return float((d[d > 0] ** -0.5).sum())


def chi1(mol: Mol) -> float:
    total = 0.0
    d = _simple_deltas(mol)
    for b in mol.bonds:
        p = d[b.begin_atom_idx] * d[b.end_atom_idx]
        if p > 0:
            total += p**-0.5
    return total


def chi0v(mol: Mol) -> float:
    d = _valence_deltas(mol)
    return float((d[d > 0] ** -0.5).sum())


def chi1v(mol: Mol) -> float:
    d = _valence_deltas(mol)
    total = 0.0
    for b in mol.bonds:
        p = d[b.begin_atom_idx] * d[b.end_atom_idx]
        if p > 0:
            total += p**-0.5
    return total


def chi2v(mol: Mol) -> float:
    return _chi(mol, 2, _valence_deltas(mol))


def chi3v(mol: Mol) -> float:
    return _chi(mol, 3, _valence_deltas(mol))


def chi4v(mol: Mol) -> float:
    return _chi(mol, 4, _valence_deltas(mol))


def _nval_deltas(mol: Mol) -> np.ndarray:
    """Unadjusted valence delta (Zv - h) for all rows — the delta RDKit's
    ``ChiNn`` family uses (``_nVal``), distinct from the Kier-Hall
    row-adjusted delta of the ``ChiNv`` family."""
    out = np.zeros(mol.num_atoms)
    for a in mol.atoms:
        out[a.idx] = max(n_outer_electrons(a.atomic_num) - a.total_num_hs, 0)
    return out


def chi0n(mol: Mol) -> float:
    d = _nval_deltas(mol)
    return float((d[d > 0] ** -0.5).sum())


def chi1n(mol: Mol) -> float:
    d = _nval_deltas(mol)
    total = 0.0
    for b in mol.bonds:
        p = d[b.begin_atom_idx] * d[b.end_atom_idx]
        if p > 0:
            total += p**-0.5
    return total


def chi2n(mol: Mol) -> float:
    return _chi(mol, 2, _nval_deltas(mol))


def chi3n(mol: Mol) -> float:
    return _chi(mol, 3, _nval_deltas(mol))


def chi4n(mol: Mol) -> float:
    return _chi(mol, 4, _nval_deltas(mol))


def _weighted_distance_sums(mol: Mol) -> np.ndarray:
    """Row sums of the bond-order-weighted distance matrix (edge weight
    1/order, aromatic 2/3 — RDKit's ``useBO`` convention for Balaban J)."""
    import heapq

    n = mol.num_atoms
    wadj: list[list[tuple[int, float]]] = [[] for _ in range(n)]
    for b in mol.bonds:
        order = b.bond_type.order or 1.0
        w = 1.0 / order
        wadj[b.begin_atom_idx].append((b.end_atom_idx, w))
        wadj[b.end_atom_idx].append((b.begin_atom_idx, w))
    sums = np.zeros(n)
    for s in range(n):
        dist = np.full(n, np.inf)
        dist[s] = 0.0
        heap = [(0.0, s)]
        while heap:
            du, u = heapq.heappop(heap)
            if du > dist[u]:
                continue
            for v, w in wadj[u]:
                nd = du + w
                if nd < dist[v]:
                    dist[v] = nd
                    heapq.heappush(heap, (nd, v))
        dist[~np.isfinite(dist)] = 0.0
        sums[s] = dist.sum()
    return sums


def balaban_j(mol: Mol) -> float:
    """Balaban's distance connectivity index J over the bond-order-weighted
    distance matrix (benzene = 3.000, cyclohexane = 2.000); 0 for edgeless
    graphs."""
    m = mol.num_bonds
    n = mol.num_atoms
    if m == 0 or n < 2:
        return 0.0
    s = _weighted_distance_sums(mol)
    mu = m - n + _n_components(mol)
    total = 0.0
    for b in mol.bonds:
        p = s[b.begin_atom_idx] * s[b.end_atom_idx]
        if p > 0:
            total += p**-0.5
    return m / (mu + 1.0) * total


# --------------------------------------------------------------------------
# constitutional counts
# --------------------------------------------------------------------------


def mol_weight(mol: Mol) -> float:
    H = MASSES[1]
    return sum(a.mass + a.total_num_hs * H for a in mol.atoms)


def heavy_atom_count(mol: Mol) -> float:
    return float(mol.num_atoms)


def num_heteroatoms(mol: Mol) -> float:
    return float(sum(1 for a in mol.atoms if a.atomic_num not in (1, 6)))


def nhoh_count(mol: Mol) -> float:
    return float(sum(a.total_num_hs for a in mol.atoms if a.atomic_num in (7, 8)))


def no_count(mol: Mol) -> float:
    return float(sum(1 for a in mol.atoms if a.atomic_num in (7, 8)))


def num_h_donors(mol: Mol) -> float:
    return float(
        sum(1 for a in mol.atoms if a.atomic_num in (7, 8) and a.total_num_hs > 0)
    )


def num_h_acceptors(mol: Mol) -> float:
    """Lipinski-style acceptor count: N/O excluding pyrrole-type N, amide N,
    and positively-charged atoms."""
    n = 0
    for a in mol.atoms:
        if a.atomic_num == 8:
            if a.formal_charge <= 0:
                n += 1
        elif a.atomic_num == 7:
            if a.formal_charge > 0:
                continue
            if a.is_aromatic and a.total_num_hs > 0:
                continue  # pyrrole NH
            # amide nitrogen: single-bonded to a carbonyl carbon
            amide = any(
                x.atomic_num == 6
                and _has_double_to(mol, x.idx, lambda y: y.atomic_num in (8, 16))
                for x in _heavy_neighbors(mol, a.idx)
            )
            if not amide:
                n += 1
    return float(n)


def num_rotatable_bonds(mol: Mol) -> float:
    """Single, non-ring bonds between two non-terminal atoms, neither of
    which is triple-bonded (RDKit's non-strict definition)."""
    n = 0
    triple = {
        i
        for b in mol.bonds
        if b.bond_type == BondType.TRIPLE
        for i in (b.begin_atom_idx, b.end_atom_idx)
    }
    for b in mol.bonds:
        if b.bond_type != BondType.SINGLE or b.is_in_ring:
            continue
        u, v = b.begin_atom_idx, b.end_atom_idx
        if mol.degree(u) < 2 or mol.degree(v) < 2:
            continue
        if u in triple or v in triple:
            continue
        n += 1
    return float(n)


def ring_count(mol: Mol) -> float:
    return float(len(getattr(mol, "rings", [])))


def _ring_is_aromatic(mol: Mol, ring: list[int]) -> bool:
    return all(mol.atoms[i].is_aromatic for i in ring)


def _ring_is_saturated(mol: Mol, ring: list[int]) -> bool:
    rs = set(ring)
    for b in mol.bonds:
        if b.begin_atom_idx in rs and b.end_atom_idx in rs and b.is_in_ring:
            if b.bond_type != BondType.SINGLE:
                return False
    return not any(mol.atoms[i].is_aromatic for i in ring)


def _ring_has_hetero(mol: Mol, ring: list[int]) -> bool:
    return any(mol.atoms[i].atomic_num != 6 for i in ring)


def num_aromatic_rings(mol: Mol) -> float:
    return float(sum(_ring_is_aromatic(mol, r) for r in getattr(mol, "rings", [])))


def num_saturated_rings(mol: Mol) -> float:
    return float(sum(_ring_is_saturated(mol, r) for r in getattr(mol, "rings", [])))


def num_aliphatic_rings(mol: Mol) -> float:
    return float(
        sum(not _ring_is_aromatic(mol, r) for r in getattr(mol, "rings", []))
    )


def num_aromatic_heterocycles(mol: Mol) -> float:
    return float(
        sum(
            _ring_is_aromatic(mol, r) and _ring_has_hetero(mol, r)
            for r in getattr(mol, "rings", [])
        )
    )


def num_aromatic_carbocycles(mol: Mol) -> float:
    return float(
        sum(
            _ring_is_aromatic(mol, r) and not _ring_has_hetero(mol, r)
            for r in getattr(mol, "rings", [])
        )
    )


def num_saturated_heterocycles(mol: Mol) -> float:
    return float(
        sum(
            _ring_is_saturated(mol, r) and _ring_has_hetero(mol, r)
            for r in getattr(mol, "rings", [])
        )
    )


def num_saturated_carbocycles(mol: Mol) -> float:
    return float(
        sum(
            _ring_is_saturated(mol, r) and not _ring_has_hetero(mol, r)
            for r in getattr(mol, "rings", [])
        )
    )


def num_aliphatic_heterocycles(mol: Mol) -> float:
    return float(
        sum(
            not _ring_is_aromatic(mol, r) and _ring_has_hetero(mol, r)
            for r in getattr(mol, "rings", [])
        )
    )


def num_aliphatic_carbocycles(mol: Mol) -> float:
    return float(
        sum(
            not _ring_is_aromatic(mol, r) and not _ring_has_hetero(mol, r)
            for r in getattr(mol, "rings", [])
        )
    )


def fraction_csp3(mol: Mol) -> float:
    cs = [a for a in mol.atoms if a.atomic_num == 6]
    if not cs:
        return 0.0
    return sum(1 for a in cs if a.hybridization == HybridizationType.SP3) / len(cs)


def num_valence_electrons(mol: Mol) -> float:
    return float(
        sum(
            n_outer_electrons(a.atomic_num) - a.formal_charge + a.total_num_hs
            for a in mol.atoms
        )
    )


def formal_charge(mol: Mol) -> float:
    return float(sum(a.formal_charge for a in mol.atoms))


def num_atoms_with_hs(mol: Mol) -> float:
    return float(mol.num_atoms + sum(a.total_num_hs for a in mol.atoms))


def _labute_asa_lazy(mol: Mol) -> float:
    from chemprop_tpu_torch.chem.surface import labute_asa

    return labute_asa(mol)


def mol_logp(mol: Mol) -> float:
    return crippen_logp_mr(mol)[0]


def mol_mr(mol: Mol) -> float:
    return crippen_logp_mr(mol)[1]


# --------------------------------------------------------------------------
# the descriptor set
# --------------------------------------------------------------------------

DESCRIPTORS: dict[str, Callable[[Mol], float]] = {
    "MolWt": mol_weight,
    "HeavyAtomCount": heavy_atom_count,
    "NumHeteroatoms": num_heteroatoms,
    "NHOHCount": nhoh_count,
    "NOCount": no_count,
    "NumHDonors": num_h_donors,
    "NumHAcceptors": num_h_acceptors,
    "NumRotatableBonds": num_rotatable_bonds,
    "RingCount": ring_count,
    "NumAromaticRings": num_aromatic_rings,
    "NumSaturatedRings": num_saturated_rings,
    "NumAliphaticRings": num_aliphatic_rings,
    "NumAromaticHeterocycles": num_aromatic_heterocycles,
    "NumAromaticCarbocycles": num_aromatic_carbocycles,
    "NumSaturatedHeterocycles": num_saturated_heterocycles,
    "NumSaturatedCarbocycles": num_saturated_carbocycles,
    "NumAliphaticHeterocycles": num_aliphatic_heterocycles,
    "NumAliphaticCarbocycles": num_aliphatic_carbocycles,
    "FractionCSP3": fraction_csp3,
    "NumValenceElectrons": num_valence_electrons,
    "FormalCharge": formal_charge,
    "TPSA": tpsa,
    "MolLogP": mol_logp,
    "MolMR": mol_mr,
    "HallKierAlpha": hall_kier_alpha,
    "Kappa1": kappa1,
    "Kappa2": kappa2,
    "Kappa3": kappa3,
    "Chi0": chi0,
    "Chi1": chi1,
    "Chi0v": chi0v,
    "Chi1v": chi1v,
    "Chi2v": chi2v,
    "Chi3v": chi3v,
    "Chi4v": chi4v,
    "Chi2n": chi2n,
    "Chi3n": chi3n,
    "Chi4n": chi4n,
    "BalabanJ": balaban_j,
    # the calibrated Labute model (chem/surface.py; fixture-pinned 167.8922)
    "LabuteASA": _labute_asa_lazy,
}


def compute_descriptors(mol: Mol, names: list[str] | None = None) -> np.ndarray:
    """Descriptor vector in the order of :data:`DESCRIPTORS` (or ``names``)."""
    keys = names or list(DESCRIPTORS)
    return np.array([DESCRIPTORS[k](mol) for k in keys], dtype=np.float64)


# --------------------------------------------------------------------------
# the descriptastorus-compatible 200-descriptor ``rdkit_2d`` vector
# (reference ``chemprop/featurizers/molecule.py:53-99``: ``v1_rdkit_2d``
# emits the descriptastorus RDKit2D 200-vector; this block provides the same
# 200 names in the same string-sorted order)
# --------------------------------------------------------------------------

# monoisotopic masses for the elements the SMILES corpus uses; others fall
# back to average mass (documented approximation)
_MONOISOTOPIC: dict[int, float] = {
    1: 1.00782503, 2: 4.00260325, 3: 7.01600344, 4: 9.01218307, 5: 11.00930536,
    6: 12.0, 7: 14.00307401, 8: 15.99491462, 9: 18.99840316, 10: 19.99244018,
    11: 22.98976928, 12: 23.98504170, 13: 26.98153853, 14: 27.97692653,
    15: 30.97376200, 16: 31.97207117, 17: 34.96885268, 19: 38.96370649,
    20: 39.96259086, 26: 55.93493633, 29: 62.92959772, 30: 63.92914201,
    34: 79.91652180, 35: 78.91833760, 50: 119.90220163, 53: 126.90447190,
}


def exact_mol_weight(mol: Mol) -> float:
    """Monoisotopic molecular weight (cf. RDKit ``ExactMolWt``)."""
    total = 0.0
    for a in mol.atoms:
        if a.isotope:
            total += float(a.isotope)
        else:
            total += _MONOISOTOPIC.get(a.atomic_num, MASSES[a.atomic_num])
        total += a.total_num_hs * _MONOISOTOPIC[1]
    return total


def heavy_atom_mol_weight(mol: Mol) -> float:
    """Average molecular weight ignoring hydrogens (RDKit ``HeavyAtomMolWt``)."""
    return float(sum(a.mass for a in mol.atoms))


def num_radical_electrons(mol: Mol) -> float:
    """Unpaired electrons implied by bracket atoms whose stated H count
    leaves them under their default valence (e.g. ``[CH3]`` -> 1). Neutral,
    non-aromatic bracket atoms only — the common organic-SMILES cases;
    charged/aromatic radical centers are a documented approximation gap."""
    from chemprop_tpu_torch.chem.periodic_table import DEFAULT_VALENCES

    total = 0
    for a in mol.atoms:
        if a.num_explicit_hs is None or a.is_aromatic or a.formal_charge:
            continue
        vals = DEFAULT_VALENCES.get(a.atomic_num)
        if not vals:
            continue
        ev = mol.explicit_valence(a.idx)  # bond orders + bracket H count
        target = next((v for v in vals if v >= ev), None)
        if target is not None:
            total += max(target - ev, 0)
    return float(total)


def fp_density_morgan(mol: Mol, radius: int) -> float:
    """Distinct Morgan environment identifiers per heavy atom (RDKit
    ``FpDensityMorgan1/2/3`` = nonzero entries of the sparse count Morgan
    fingerprint / heavy atoms). Uses the RDKit-bit-exact environment
    invariants (`chem/morgan_rdkit`), so values match RDKit exactly
    (pinned by the reference's own fixture: 0.8966/1.6897/2.5517)."""
    from chemprop_tpu_torch.chem.morgan_rdkit import morgan_environment_invariants

    if mol.num_atoms == 0:
        return 0.0
    return len(set(morgan_environment_invariants(mol, radius))) / mol.num_atoms


def ipc(mol: Mol, avg: bool = False) -> float:
    """Bonchev-Trinajstic information content of the coefficients of the
    adjacency matrix's characteristic polynomial (RDKit ``Ipc``)."""
    n = mol.num_atoms
    if n == 0:
        return 0.0
    A = np.zeros((n, n))
    for b in mol.bonds:
        A[b.begin_atom_idx, b.end_atom_idx] = 1.0
        A[b.end_atom_idx, b.begin_atom_idx] = 1.0
    coeffs = np.abs(np.poly(A))
    coeffs = coeffs[coeffs > 1e-12]
    if coeffs.size == 0:
        return 0.0
    total = coeffs.sum()
    p = coeffs / total
    entropy = float(-(p * np.log2(p)).sum())
    return entropy if avg else entropy * float(total)


def _bo_distance_matrix(mol: Mol) -> np.ndarray:
    """All-pairs shortest paths with bond-order edge weights (1/order,
    aromatic 2/3 — RDKit ``GetDistanceMatrix(useBO=1)``, the "Balaban"
    matrix BertzCT's symmetry classes are built from)."""
    import heapq

    n = mol.num_atoms
    wadj: list[list[tuple[int, float]]] = [[] for _ in range(n)]
    for b in mol.bonds:
        w = 1.0 / (b.bond_type.order or 1.0)
        wadj[b.begin_atom_idx].append((b.end_atom_idx, w))
        wadj[b.end_atom_idx].append((b.begin_atom_idx, w))
    out = np.zeros((n, n))
    for s in range(n):
        dist = np.full(n, np.inf)
        dist[s] = 0.0
        heap = [(0.0, s)]
        while heap:
            du, u = heapq.heappop(heap)
            if du > dist[u]:
                continue
            for v, w in wadj[u]:
                nd = du + w
                if nd < dist[v]:
                    dist[v] = nd
                    heapq.heappush(heap, (nd, v))
        # unreachable (cross-fragment) pairs: RDKit's GetDistanceMatrix uses a
        # 1e8 sentinel, and BertzCT's sorted-row cutoff (first 100 entries)
        # relies on sentinels sorting to the BACK so they are cut first; a 0.0
        # placeholder would sort to the front and evict real distances.
        dist[~np.isfinite(dist)] = 1e8
        out[s] = dist
    return out


def bertz_ct(mol: Mol) -> float:
    """Bertz complexity index, RDKit's formulation
    (``rdkit.Chem.GraphDescriptors.BertzCT``; Bertz, JACS 1981, 103, 3599):

    * symmetry classes: atoms share a class iff their SORTED rows of the
      bond-order-weighted distance matrix are identical (rounded to 4
      decimals, first ``cutoff=100`` entries);
    * connections: for every hinge atom, each unordered pair of its bonds
      contributes ``order_i * order_j`` to the class
      ``(minNbrClass, hingeClass, maxNbrClass)``; each multiple bond
      additionally contributes ``order*(order-1)/2`` to the pair class of
      its endpoints;
    * CT = T*(H(connections) + log2 T) + N*H(element counts) with T the
      total connection count and H the Shannon entropy of the class
      distribution.

    Pinned by the reference's own RDKit-generated fixture (1143.0568)."""
    n = mol.num_atoms
    if n < 2:
        return 0.0
    bd = _bo_distance_matrix(mol)
    classes: list[int] = []
    seen: dict[tuple, int] = {}
    for i in range(n):
        key = tuple(round(x, 4) for x in sorted(bd[i].tolist())[:100])
        classes.append(seen.setdefault(key, len(seen) + 1))

    conn: dict[tuple, float] = {}
    for i in range(n):
        bonds = mol.atom_bonds(i)
        ci = classes[i]
        for x in range(len(bonds)):
            bx = bonds[x]
            jx = bx.other_atom_idx(i)
            ox = bx.bond_type.order or 1.0
            if ox > 1 and jx > i:
                key2 = (min(ci, classes[jx]), max(ci, classes[jx]))
                conn[key2] = conn.get(key2, 0.0) + ox * (ox - 1) / 2.0
            for y in range(x + 1, len(bonds)):
                by = bonds[y]
                jy = by.other_atom_idx(i)
                oy = by.bond_type.order or 1.0
                lo, hi = sorted((classes[jx], classes[jy]))
                key3 = (lo, ci, hi)
                conn[key3] = conn.get(key3, 0.0) + ox * oy

    def shannon(counts: list[float]) -> float:
        arr = np.asarray([c for c in counts if c > 0], dtype=float)
        if arr.size == 0:
            return 0.0
        p = arr / arr.sum()
        return float(-(p * np.log2(p)).sum())

    conn_counts = list(conn.values())
    tot = sum(conn_counts)
    connection_ie = tot * (shannon(conn_counts) + np.log2(tot)) if tot > 0 else 0.0
    elem_counts: dict[int, int] = {}
    for a in mol.atoms:
        elem_counts[a.atomic_num] = elem_counts.get(a.atomic_num, 0) + 1
    atom_type_ie = n * shannon(list(elem_counts.values()))
    return float(connection_ie + atom_type_ie)


# ----------------------------------------------------------------- E-State
def max_estate_index(mol: Mol) -> float:
    from chemprop_tpu_torch.chem.estate import estate_indices

    es = estate_indices(mol)
    return float(es.max()) if es.size else 0.0


def min_estate_index(mol: Mol) -> float:
    from chemprop_tpu_torch.chem.estate import estate_indices

    es = estate_indices(mol)
    return float(es.min()) if es.size else 0.0


def max_abs_estate_index(mol: Mol) -> float:
    from chemprop_tpu_torch.chem.estate import estate_indices

    es = estate_indices(mol)
    return float(np.abs(es).max()) if es.size else 0.0


def min_abs_estate_index(mol: Mol) -> float:
    from chemprop_tpu_torch.chem.estate import estate_indices

    es = estate_indices(mol)
    return float(np.abs(es).min()) if es.size else 0.0


# -------------------------------------------------------------------- QED
# Bickerton et al., "Quantifying the chemical beauty of drugs", Nat. Chem.
# 2012, 4, 90-98: asymmetric double sigmoid (ADS) desirability per property,
# weighted geometric mean. Parameters are the published table.
_QED_ADS: dict[str, tuple[float, float, float, float, float, float, float]] = {
    "MW": (2.817065973, 392.5754953, 290.7489764, 2.419764353, 49.22325677, 65.37051707, 104.9805561),
    "ALOGP": (3.172690585, 137.8624751, 2.534937431, 4.581497897, 0.822739154, 0.576295591, 131.3186604),
    "HBA": (2.948620388, 160.4605972, 3.615294657, 4.435986202, 0.290141953, 1.300669958, 148.7763046),
    "HBD": (1.618662227, 1010.051101, 0.985094388, 0.000000001, 0.713820843, 0.920922555, 258.1632616),
    "PSA": (1.876861559, 125.2232657, 62.90773554, 87.83366614, 12.01999824, 28.51324732, 104.5686167),
    "ROTB": (0.010000, 272.4121427, 2.558379970, 1.565547684, 1.271567166, 2.758063707, 105.4420403),
    "AROM": (3.217788970, 957.7374108, 2.274627939, 0.000000001, 1.317690384, 0.375760881, 312.3372610),
    "ALERTS": (0.010000, 1199.094025, -0.09002883, 0.000000001, 0.185904477, 0.875193782, 417.7253140),
}
_QED_WEIGHTS = {
    "MW": 0.66, "ALOGP": 0.46, "HBA": 0.05, "HBD": 0.61,
    "PSA": 0.06, "ROTB": 0.65, "AROM": 0.48, "ALERTS": 0.95,
}
# structural-alert subset (Brenk filters; RDKit's QED ships 94 patterns —
# this is the high-frequency core, a documented approximation)
_QED_ALERTS = (
    "[$([NX3](=O)=O),$([NX3+](=O)[O-])]",  # nitro
    "[SX2H1]",  # thiol
    "[OX2][OX2]",  # peroxide
    "[SX2][SX2]",  # disulfide
    "[NX3]-[NX3]",  # hydrazine
    "[CX3](=[OX1])[F,Cl,Br,I]",  # acyl halide
    "[CX4][Br,I]",  # alkyl Br/I
    "[NX2]=[CX2]=[OX1]",  # isocyanate
    "[NX2]=[CX2]=[SX1]",  # isothiocyanate
    "[O,N,S;r3]",  # strained 3-ring heteroatom
    "[#6]-[NX2]=[NX2]-[#6]",  # azo
    "[NX2]~[NX2+]~[NX1-,NX1]",  # azide
    "[CX3]=[CX3]-[CX3]=[OX1]",  # Michael acceptor
    "[CX3H1](=O)[#6]",  # aldehyde
    "[NX2]=[OX1]",  # nitroso
    "C1C(=O)NC(=O)NC1=O",  # barbiturate
    "[CR0]~[CR0]~[CR0]~[CR0]~[CR0]~[CR0]~[CR0]~[CR0]",  # long chain
    "[NX4]",  # quaternary N
)


def _ads(x: float, p: tuple) -> float:
    a, b, c, d, e, f, dmax = p
    with np.errstate(over="ignore"):
        val = a + b / (1.0 + np.exp(-(x - c + d / 2.0) / e)) * (
            1.0 - 1.0 / (1.0 + np.exp(-(x - c - d / 2.0) / f))
        )
    return float(val / dmax)


def qed(mol: Mol) -> float:
    """Quantitative estimate of drug-likeness (weighted QED)."""
    from chemprop_tpu_torch.chem.smarts import count_matches

    props = {
        "MW": mol_weight(mol),
        "ALOGP": mol_logp(mol),
        "HBA": num_h_acceptors(mol),
        "HBD": num_h_donors(mol),
        "PSA": tpsa(mol),
        "ROTB": num_rotatable_bonds(mol),
        "AROM": num_aromatic_rings(mol),
        "ALERTS": float(sum(1 for s in _QED_ALERTS if count_matches(mol, s) > 0)),
    }
    num = 0.0
    den = 0.0
    for k, x in props.items():
        d = max(_ads(x, _QED_ADS[k]), 1e-10)
        w = _QED_WEIGHTS[k]
        num += w * np.log(d)
        den += w
    return float(np.exp(num / den))


# --------------------------------------------------------------------------
# descList-only descriptors: the 17 beyond the descriptastorus 200-set
# (RDKit's full ``Descriptors.descList`` — the reference's ``rdkit_2d``
# registry entry, ``chemprop/featurizers/molecule.py:53-73`` — is 217 wide)
# --------------------------------------------------------------------------


def _ring_bond_idxs(mol: Mol, ring: list[int]) -> set[int]:
    """Bond indices around an ORDERED ring cycle (consecutive pairs + the
    closing pair)."""
    out: set[int] = set()
    k = len(ring)
    for t in range(k):
        u, v = ring[t], ring[(t + 1) % k]
        for b in mol.atom_bonds(u):
            if b.other_atom_idx(u) == v:
                out.add(b.idx)
                break
    return out


def num_heterocycles(mol: Mol) -> float:
    """Rings containing at least one non-carbon atom (RDKit
    ``NumHeterocycles``; fixture-pinned: 2 on the reference molecule)."""
    return float(sum(_ring_has_hetero(mol, r) for r in getattr(mol, "rings", [])))


def num_spiro_atoms(mol: Mol) -> float:
    """Atoms shared between ring pairs that share EXACTLY one atom (RDKit
    ``CalcNumSpiroAtoms`` semantics over the smallest-ring set)."""
    rings = [set(r) for r in getattr(mol, "rings", [])]
    spiro: set[int] = set()
    for i in range(len(rings)):
        for j in range(i + 1, len(rings)):
            shared = rings[i] & rings[j]
            if len(shared) == 1:
                spiro.update(shared)
    return float(len(spiro))


def num_bridgehead_atoms(mol: Mol) -> float:
    """Atoms shared between ring pairs that share at least TWO bonds (RDKit
    ``CalcNumBridgeheadAtoms``): for each such pair, the endpoints of the
    shared bond path — atoms incident to exactly one shared bond — are
    bridgeheads (norbornane: C1/C4, not the bridge carbon)."""
    rings = getattr(mol, "rings", [])
    bond_rings = [_ring_bond_idxs(mol, r) for r in rings]
    heads: set[int] = set()
    for i in range(len(rings)):
        for j in range(i + 1, len(rings)):
            shared = bond_rings[i] & bond_rings[j]
            if len(shared) < 2:
                continue
            incidence: dict[int, int] = {}
            for bi in shared:
                b = mol.bonds[bi]
                for a in (b.begin_atom_idx, b.end_atom_idx):
                    incidence[a] = incidence.get(a, 0) + 1
            heads.update(a for a, c in incidence.items() if c == 1)
    return float(len(heads))


def num_amide_bonds(mol: Mol) -> float:
    """Count of C(=O)-N amide bonds (RDKit ``CalcNumAmideBonds``, SMARTS
    ``C(=[OX1])N``). The reference fixture molecule has none, so the exact
    SMARTS nuance (N connectivity constraints) is pinned by self-tests on
    classic amides/ureas only (docs/chemistry_divergences.md)."""
    from chemprop_tpu_torch.chem.smarts import smarts

    return float(smarts("C(=[OX1])N").count_matches(mol))


def find_potential_stereocenters(mol: Mol) -> tuple[list[int], list[int]]:
    """Tetrahedral stereocenter detection with RDKit LEGACY
    ``assignStereochemistry(flagPossible=True)`` semantics: candidates are
    4-coordinate atoms (counting one implicit H) or 3-coordinate lone-pair
    centers (N only in a 3-ring; P/As/S/Se generally), whose bonded
    neighbors all land in DISTINCT legacy CIP rank classes
    (:func:`~chemprop_tpu_torch.chem.perception.legacy_cip_ranks` — the same rank
    function legacy RDKit uses, including its map-number seeding). Returns
    ``(specified, unspecified)`` index lists: specified = carries a
    tetrahedral chiral tag (RDKit's ``_CIPCode`` atoms), unspecified =
    potential but untagged (``_ChiralityPossible``)."""
    from chemprop_tpu_torch.chem.mol import ChiralType
    from chemprop_tpu_torch.chem.perception import legacy_cip_ranks

    ranks = legacy_cip_ranks(mol)
    in_3ring = set()
    for ring in getattr(mol, "rings", []):
        if len(ring) == 3:
            in_3ring.update(ring)
    specified: list[int] = []
    unspecified: list[int] = []
    for a in mol.atoms:
        nbrs = [b.other_atom_idx(a.idx) for b in mol.atom_bonds(a.idx)]
        deg = len(nbrs)
        nH = a.total_num_hs
        if deg < 3 or deg + nH > 4 or nH > 1:
            continue
        if deg + nH == 3:
            # lone-pair center: N only in a 3-membered ring (aziridine);
            # P/As/S/Se invert too slowly (RDKit legacy's element list)
            z = a.atomic_num
            if z == 7 and a.idx not in in_3ring:
                continue
            if z not in (7, 15, 16, 33, 34):
                continue
        if len({ranks[j] for j in nbrs}) != deg:
            continue
        if a.chiral_tag in (ChiralType.CHI_TETRAHEDRAL_CW, ChiralType.CHI_TETRAHEDRAL_CCW):
            specified.append(a.idx)
        else:
            unspecified.append(a.idx)
    return specified, unspecified


def num_atom_stereo_centers(mol: Mol) -> float:
    return float(len(find_potential_stereocenters(mol)[0]))


def num_unspecified_atom_stereo_centers(mol: Mol) -> float:
    return float(len(find_potential_stereocenters(mol)[1]))


def phi(mol: Mol) -> float:
    """Kier flexibility index Phi = Kappa1*Kappa2 / heavy atoms (RDKit
    ``CalcPhi``; fixture-pinned 4.601)."""
    n = mol.num_atoms
    if n == 0:
        return 0.0
    return kappa1(mol) * kappa2(mol) / n


def sps(mol: Mol, normalize: bool = True, stereocenters=None) -> float:
    """Spacial score (Krzyzanowski et al., J. Med. Chem. 2023; RDKit
    ``SPS``): per heavy atom ``h*s*r*n^2`` with h = hybridization term
    (sp 1, sp2 2, sp3 3, other 4), s = 2 for stereocenter atoms (tagged or
    potential) and atoms of stereo-labeled double bonds else 1, r = 2 for
    NON-AROMATIC ring atoms else 1 (aromatic rings count as flat), n =
    graph degree. ``normalize=True`` (the descList entry) divides by heavy
    atom count. Constants fixture-pinned: 469/29 = 16.1724 on the reference
    molecule; the stereo term is self-tested (the fixture is achiral)."""
    n_atoms = mol.num_atoms
    if n_atoms == 0:
        return 0.0
    from chemprop_tpu_torch.chem.mol import BondStereo

    spec, unspec = stereocenters if stereocenters is not None else find_potential_stereocenters(mol)
    stereo_atoms = set(spec) | set(unspec)
    for b in mol.bonds:
        if b.bond_type == BondType.DOUBLE and b.stereo != BondStereo.STEREONONE:
            stereo_atoms.update((b.begin_atom_idx, b.end_atom_idx))
    hyb_term = {
        HybridizationType.SP: 1,
        HybridizationType.SP2: 2,
        HybridizationType.SP3: 3,
    }
    total = 0
    for a in mol.atoms:
        h = hyb_term.get(a.hybridization, 4)
        s = 2 if a.idx in stereo_atoms else 1
        r = 1 if (a.is_aromatic or not a.is_in_ring) else 2
        deg = len(mol.atom_bonds(a.idx))
        total += h * s * r * deg * deg
    return total / n_atoms if normalize else float(total)


_BCUT_KEYS = (
    "BCUT2D_MWHI", "BCUT2D_MWLOW", "BCUT2D_CHGHI", "BCUT2D_CHGLO",
    "BCUT2D_LOGPHI", "BCUT2D_LOGPLOW", "BCUT2D_MRHI", "BCUT2D_MRLOW",
)


def bcut2d(mol: Mol, charges=None, crippen=None) -> dict[str, float]:
    """Burden eigenvalue descriptors (Pearlman & Smith BCUT; RDKit
    ``BCUT2D_*``): symmetric Burden matrix with diagonal = per-atom
    property, off-diagonal = ``1/sqrt(bond order)`` for bonded pairs
    (aromatic order 1.5) and 0.001 for every non-bonded pair; HI/LOW = the
    extreme eigenvalues. Atom properties: average atomic mass, Gasteiger
    charge, and the Crippen logP/MR OWN-TYPE contribution (implicit-H
    contributions NOT folded in — unlike the VSA binning convention). All
    8 values + both conventions pinned EXACT (4 decimals) against the
    reference's own RDKit fixture; non-finite Gasteiger charges (exotic
    elements) are zeroed where RDKit would raise."""
    n = mol.num_atoms
    if n == 0:
        return {k: 0.0 for k in _BCUT_KEYS}
    masses = np.array([MASSES[a.atomic_num] for a in mol.atoms])
    if charges is None:
        from chemprop_tpu_torch.chem.charges import gasteiger_charges

        charges = gasteiger_charges(mol)
        charges = np.where(np.isfinite(charges), charges, 0.0)
    q = charges
    logp, mr = crippen if crippen is not None else crippen_own_contribs(mol)

    coupling = np.full((n, n), 0.001)
    np.fill_diagonal(coupling, 0.0)
    for b in mol.bonds:
        i, j = b.begin_atom_idx, b.end_atom_idx
        coupling[i, j] = coupling[j, i] = (b.bond_type.order or 1.0) ** -0.5
    out: dict[str, float] = {}
    # RDKit's own (inconsistent) suffixes: CHGLO but MWLOW/LOGPLOW/MRLOW
    for name, lo_name, diag in (
        ("MWHI", "MWLOW", masses),
        ("CHGHI", "CHGLO", q),
        ("LOGPHI", "LOGPLOW", logp),
        ("MRHI", "MRLOW", mr),
    ):
        B = coupling + np.diag(diag)
        ev = np.linalg.eigvalsh(B)
        out[f"BCUT2D_{name}"] = float(ev[-1])
        out[f"BCUT2D_{lo_name}"] = float(ev[0])
    return out


# ------------------------------------------------------- vector assembly
RDKIT2D_NAMES: list[str] = (
    [
        "BalabanJ", "BertzCT",
        "Chi0", "Chi0n", "Chi0v", "Chi1", "Chi1n", "Chi1v",
        "Chi2n", "Chi2v", "Chi3n", "Chi3v", "Chi4n", "Chi4v",
    ]
    + [f"EState_VSA{i}" for i in (1, 10, 11, 2, 3, 4, 5, 6, 7, 8, 9)]
    + [
        "ExactMolWt", "FpDensityMorgan1", "FpDensityMorgan2", "FpDensityMorgan3",
        "FractionCSP3", "HallKierAlpha", "HeavyAtomCount", "HeavyAtomMolWt",
        "Ipc", "Kappa1", "Kappa2", "Kappa3", "LabuteASA",
        "MaxAbsEStateIndex", "MaxAbsPartialCharge", "MaxEStateIndex",
        "MaxPartialCharge", "MinAbsEStateIndex", "MinAbsPartialCharge",
        "MinEStateIndex", "MinPartialCharge", "MolLogP", "MolMR", "MolWt",
        "NHOHCount", "NOCount",
        "NumAliphaticCarbocycles", "NumAliphaticHeterocycles", "NumAliphaticRings",
        "NumAromaticCarbocycles", "NumAromaticHeterocycles", "NumAromaticRings",
        "NumHAcceptors", "NumHDonors", "NumHeteroatoms", "NumRadicalElectrons",
        "NumRotatableBonds",
        "NumSaturatedCarbocycles", "NumSaturatedHeterocycles", "NumSaturatedRings",
        "NumValenceElectrons",
    ]
    + [f"PEOE_VSA{i}" for i in (1, 10, 11, 12, 13, 14, 2, 3, 4, 5, 6, 7, 8, 9)]
    + ["RingCount"]
    + [f"SMR_VSA{i}" for i in (1, 10, 2, 3, 4, 5, 6, 7, 8, 9)]
    + [f"SlogP_VSA{i}" for i in (1, 10, 11, 12, 2, 3, 4, 5, 6, 7, 8, 9)]
    + ["TPSA"]
    + [f"VSA_EState{i}" for i in (1, 10, 2, 3, 4, 5, 6, 7, 8, 9)]
    + []  # fragment names appended below (import-time, keeps one source of truth)
)


def _finalize_names() -> None:
    from chemprop_tpu_torch.chem.fragments import FRAGMENT_NAMES

    RDKIT2D_NAMES.extend(FRAGMENT_NAMES)
    RDKIT2D_NAMES.append("qed")
    assert RDKIT2D_NAMES == sorted(RDKIT2D_NAMES), "descriptastorus order is string-sorted"
    assert len(RDKIT2D_NAMES) == 200, len(RDKIT2D_NAMES)


_finalize_names()


def _rdkit2d_vals(mol: Mol, shared: dict | None = None) -> dict[str, float]:
    """Name -> value dict of the descriptastorus 200-set (the shared core of
    both the ``v1_rdkit_2d`` 200-vector and the descList 217-vector).

    Shared intermediates (VSA contributions, E-State, Gasteiger charges,
    Crippen contributions) are computed once and reused across families;
    pass a ``shared`` dict to also hand them to the caller (so the
    descList-only descriptors don't recompute them).
    """
    from chemprop_tpu_torch.chem import surface
    from chemprop_tpu_torch.chem.charges import gasteiger_charges
    from chemprop_tpu_torch.chem.estate import estate_indices
    from chemprop_tpu_torch.chem.fragments import fragment_counts

    vsa, h_vsa = surface.labute_asa_contribs(mol)
    es = estate_indices(mol)
    charges = gasteiger_charges(mol)
    charges = np.where(np.isfinite(charges), charges, 0.0)
    logp_c, mr_c = crippen_atom_contribs(mol)
    # SlogP/SMR families bin by the OWN-TYPE contribution (r5 fixture
    # finding — bin membership matches RDKit exactly with these keys)
    logp_own, mr_own = crippen_own_contribs(mol)
    if shared is not None:
        shared["charges"] = charges
        shared["crippen_own"] = (logp_own, mr_own)

    vals: dict[str, float] = {}
    for i, v in enumerate(surface._binned_sum(es, vsa, surface.ESTATE_BINS)):
        vals[f"EState_VSA{i + 1}"] = float(v)
    for i, v in enumerate(surface._binned_sum(charges, vsa, surface.PEOE_BINS)):
        vals[f"PEOE_VSA{i + 1}"] = float(v)
    for i, v in enumerate(surface._binned_sum(mr_own, vsa, surface.SMR_BINS)):
        vals[f"SMR_VSA{i + 1}"] = float(v)
    for i, v in enumerate(surface._binned_sum(logp_own, vsa, surface.SLOGP_BINS)):
        vals[f"SlogP_VSA{i + 1}"] = float(v)
    for i, v in enumerate(surface._binned_sum(vsa, es, surface.VSA_BINS)):
        vals[f"VSA_EState{i + 1}"] = float(v)
    vals["LabuteASA"] = float(vsa.sum() + h_vsa)
    vals["MaxEStateIndex"] = float(es.max()) if es.size else 0.0
    vals["MinEStateIndex"] = float(es.min()) if es.size else 0.0
    vals["MaxAbsEStateIndex"] = float(np.abs(es).max()) if es.size else 0.0
    vals["MinAbsEStateIndex"] = float(np.abs(es).min()) if es.size else 0.0
    vals["MaxPartialCharge"] = float(charges.max()) if charges.size else 0.0
    vals["MinPartialCharge"] = float(charges.min()) if charges.size else 0.0
    # RDKit defines the Abs variants over the (max, min) charge PAIR, not
    # over all atoms: MaxAbs = max(|maxq|, |minq|), MinAbs = min(|maxq|, |minq|)
    # (rdkit.Chem.Descriptors MaxAbsPartialCharge/MinAbsPartialCharge; pinned
    # by the reference's own RDKit-generated fixture)
    _qpair = (abs(float(charges.max())), abs(float(charges.min()))) if charges.size else (0.0, 0.0)
    vals["MaxAbsPartialCharge"] = max(_qpair)
    vals["MinAbsPartialCharge"] = min(_qpair)
    vals["MolLogP"] = float(logp_c.sum())
    vals["MolMR"] = float(mr_c.sum())

    scalar_fns: dict[str, Callable[[Mol], float]] = {
        "BalabanJ": balaban_j, "BertzCT": bertz_ct,
        "Chi0": chi0, "Chi0n": chi0n, "Chi0v": chi0v,
        "Chi1": chi1, "Chi1n": chi1n, "Chi1v": chi1v,
        "Chi2n": chi2n, "Chi2v": chi2v, "Chi3n": chi3n, "Chi3v": chi3v,
        "Chi4n": chi4n, "Chi4v": chi4v,
        "ExactMolWt": exact_mol_weight,
        "FpDensityMorgan1": lambda m: fp_density_morgan(m, 1),
        "FpDensityMorgan2": lambda m: fp_density_morgan(m, 2),
        "FpDensityMorgan3": lambda m: fp_density_morgan(m, 3),
        "FractionCSP3": fraction_csp3, "HallKierAlpha": hall_kier_alpha,
        "HeavyAtomCount": heavy_atom_count, "HeavyAtomMolWt": heavy_atom_mol_weight,
        "Ipc": ipc, "Kappa1": kappa1, "Kappa2": kappa2, "Kappa3": kappa3,
        "MolWt": mol_weight, "NHOHCount": nhoh_count, "NOCount": no_count,
        "NumAliphaticCarbocycles": num_aliphatic_carbocycles,
        "NumAliphaticHeterocycles": num_aliphatic_heterocycles,
        "NumAliphaticRings": num_aliphatic_rings,
        "NumAromaticCarbocycles": num_aromatic_carbocycles,
        "NumAromaticHeterocycles": num_aromatic_heterocycles,
        "NumAromaticRings": num_aromatic_rings,
        "NumHAcceptors": num_h_acceptors, "NumHDonors": num_h_donors,
        "NumHeteroatoms": num_heteroatoms,
        "NumRadicalElectrons": num_radical_electrons,
        "NumRotatableBonds": num_rotatable_bonds,
        "NumSaturatedCarbocycles": num_saturated_carbocycles,
        "NumSaturatedHeterocycles": num_saturated_heterocycles,
        "NumSaturatedRings": num_saturated_rings,
        "NumValenceElectrons": num_valence_electrons,
        "RingCount": ring_count, "TPSA": tpsa, "qed": qed,
    }
    for name, fn in scalar_fns.items():
        vals[name] = float(fn(mol))

    frags = fragment_counts(mol)
    from chemprop_tpu_torch.chem.fragments import FRAGMENT_NAMES

    for name, v in zip(FRAGMENT_NAMES, frags):
        vals[name] = float(v)

    return vals


def compute_rdkit2d(mol: Mol) -> np.ndarray:
    """The 200-descriptor vector, name/order-compatible with descriptastorus
    RDKit2D (reference ``chemprop/featurizers/molecule.py:79`` returns 200)."""
    vals = _rdkit2d_vals(mol)
    return np.array([vals[n] for n in RDKIT2D_NAMES], dtype=np.float64)


# RDKit ``Descriptors.descList`` in registration (NOT sorted) order — the
# reference's ``rdkit_2d`` vector layout, 217 values in its pinned RDKit
# version. Order decoded from (and pinned against) the reference's own
# RDKit-generated fixture
# (the reference chemprop's ``tests/unit/featurizers/test_molecule.py:50-106``):
# the 132 non-fragment descriptors below, then the 85 ``fr_*`` fragments in
# sorted order. Shared names carry the same values as the 200-set.
DESCLIST_NAMES: list[str] = (
    [
        "MaxAbsEStateIndex", "MaxEStateIndex", "MinAbsEStateIndex",
        "MinEStateIndex", "qed", "SPS", "MolWt", "HeavyAtomMolWt",
        "ExactMolWt", "NumValenceElectrons", "NumRadicalElectrons",
        "MaxPartialCharge", "MinPartialCharge", "MaxAbsPartialCharge",
        "MinAbsPartialCharge", "FpDensityMorgan1", "FpDensityMorgan2",
        "FpDensityMorgan3",
        "BCUT2D_MWHI", "BCUT2D_MWLOW", "BCUT2D_CHGHI", "BCUT2D_CHGLO",
        "BCUT2D_LOGPHI", "BCUT2D_LOGPLOW", "BCUT2D_MRHI", "BCUT2D_MRLOW",
        "AvgIpc", "BalabanJ", "BertzCT",
        "Chi0", "Chi0n", "Chi0v", "Chi1", "Chi1n", "Chi1v",
        "Chi2n", "Chi2v", "Chi3n", "Chi3v", "Chi4n", "Chi4v",
        "HallKierAlpha", "Ipc", "Kappa1", "Kappa2", "Kappa3", "LabuteASA",
    ]
    # the VSA families appear in descList in STRING-SORTED order
    # (PEOE_VSA1, PEOE_VSA10, PEOE_VSA11, ..., PEOE_VSA2, ...) — verified
    # by the reference's descList fixture matching the sorted v1 fixture
    # value-for-value across each family block
    + [f"PEOE_VSA{i}" for i in (1, 10, 11, 12, 13, 14, 2, 3, 4, 5, 6, 7, 8, 9)]
    + [f"SMR_VSA{i}" for i in (1, 10, 2, 3, 4, 5, 6, 7, 8, 9)]
    + [f"SlogP_VSA{i}" for i in (1, 10, 11, 12, 2, 3, 4, 5, 6, 7, 8, 9)]
    + ["TPSA"]
    + [f"EState_VSA{i}" for i in (1, 10, 11, 2, 3, 4, 5, 6, 7, 8, 9)]
    + [f"VSA_EState{i}" for i in (1, 10, 2, 3, 4, 5, 6, 7, 8, 9)]
    + [
        "FractionCSP3", "HeavyAtomCount", "NHOHCount", "NOCount",
        "NumAliphaticCarbocycles", "NumAliphaticHeterocycles",
        "NumAliphaticRings", "NumAmideBonds", "NumAromaticCarbocycles",
        "NumAromaticHeterocycles", "NumAromaticRings",
        "NumAtomStereoCenters", "NumBridgeheadAtoms", "NumHAcceptors",
        "NumHDonors", "NumHeteroatoms", "NumHeterocycles",
        "NumRotatableBonds", "NumSaturatedCarbocycles",
        "NumSaturatedHeterocycles", "NumSaturatedRings", "NumSpiroAtoms",
        "NumUnspecifiedAtomStereoCenters", "Phi", "RingCount",
        "MolLogP", "MolMR",
    ]
    + []  # fragment names appended just below
)


def _finalize_desclist_names() -> None:
    # descList appends the fragments AFTER the scalar block, in the same
    # sorted order (ASCII sort puts fr_A* before fr_a*, matching RDKit's
    # registration order — verified against the reference fixture layout)
    from chemprop_tpu_torch.chem.fragments import FRAGMENT_NAMES

    DESCLIST_NAMES.extend(FRAGMENT_NAMES)
    assert len(DESCLIST_NAMES) == 217, len(DESCLIST_NAMES)
    assert set(RDKIT2D_NAMES) - set(DESCLIST_NAMES) == set()


_finalize_desclist_names()


def compute_desclist(mol: Mol) -> np.ndarray:
    """The full 217-descriptor ``Descriptors.descList`` vector in descList
    order — what the reference's ``rdkit_2d`` registry entry returns
    (``chemprop/featurizers/molecule.py:53-73``). The 200 shared names reuse
    :func:`_rdkit2d_vals`; the 17 descList-only descriptors (SPS, BCUT2D x8,
    AvgIpc, NumAmideBonds, stereocenter/bridgehead/spiro/heterocycle counts,
    Phi) are fixture-pinned where the fixture discriminates."""
    shared: dict = {}
    vals = _rdkit2d_vals(mol, shared)
    # expensive intermediates (legacy-CIP stereo perception, Gasteiger
    # charges, Crippen contributions) computed once and shared across the
    # descList-only descriptors
    stereo = find_potential_stereocenters(mol)
    vals["SPS"] = sps(mol, stereocenters=stereo)
    vals.update(bcut2d(mol, charges=shared["charges"], crippen=shared["crippen_own"]))
    vals["AvgIpc"] = ipc(mol, avg=True)
    vals["NumAmideBonds"] = num_amide_bonds(mol)
    vals["NumAtomStereoCenters"] = float(len(stereo[0]))
    vals["NumUnspecifiedAtomStereoCenters"] = float(len(stereo[1]))
    vals["NumBridgeheadAtoms"] = num_bridgehead_atoms(mol)
    vals["NumSpiroAtoms"] = num_spiro_atoms(mol)
    vals["NumHeterocycles"] = num_heterocycles(mol)
    vals["Phi"] = phi(mol)
    return np.array([vals[n] for n in DESCLIST_NAMES], dtype=np.float64)
