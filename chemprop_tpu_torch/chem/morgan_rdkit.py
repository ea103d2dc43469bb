"""RDKit-bit-compatible Morgan (ECFP) fingerprints.

The reference featurizes extra descriptors with RDKit's
``GetMorganGenerator`` (``chemprop/featurizers/molecule.py:18-50``), so a
reference-trained checkpoint that consumed Morgan features only transfers if
this framework reproduces RDKit's exact bit positions. This module
implements that algorithm on the in-repo :class:`Mol`:

* initial atom invariants = RDKit connectivity invariants (atomic number,
  total degree, total H count, formal charge, mass defect, ring
  membership), hashed with the 32-bit boost ``hash_range``;
* per-layer update = boost ``hash_combine`` over the layer index, the
  previous invariant, and the ``(bond type, neighbor invariant)`` pairs
  sorted ascending;
* environment deduplication: each environment is the set of bonds within
  the layer's radius; an environment seen before (this round or earlier)
  emits no bit and kills its atom, matching RDKit's
  ``includeRedundantEnvironments=False`` default.

Verified bit-for-bit against the reference's pinned RDKit fixtures
(radius 2 x 2048 binary + counts, radius 3 x 1024) in
``tests/unit/chem/test_morgan_rdkit.py``.

``include_chirality`` implements RDKit's stereochemistry augmentation
(``MorganFingerprints.cpp`` / ``MorganGenerator.cpp``):

* bond invariants: a DOUBLE bond with assigned stereo hashes as
  ``100 + 10 * bondTypeCode + stereoCode`` instead of the plain bond-type
  code (``MorganBondInvGenerator`` with ``useChirality``);
* atom invariants: the first layer that processes a tagged tetrahedral
  stereocenter with an assignable CIP code adds ``1`` (R) / ``2`` (S) to
  that layer's environment invariant, exactly once per atom (RDKit's
  ``chiralAtoms`` bitset); centers without an assignable code (RDKit: no
  ``_CIPCode`` property) contribute nothing. CIP codes come from the
  in-repo perception (:func:`chemprop_tpu_torch.chem.perception.atom_cip_code`).

No RDKit is available in this environment and the reference pins no CHIRAL
Morgan fixtures, so unlike the achiral path the chirality augmentation is
validated by construction (achiral molecules are bit-identical with the
flag on or off; enantiomers differ exactly in their stereocenter-rooted
bits) plus self-pinned fixtures, not against an RDKit golden — see
``docs/chemistry_divergences.md``.
"""

from __future__ import annotations

import numpy as np

from chemprop_tpu_torch.chem.mol import BondType, Mol

_M32 = 0xFFFFFFFF
# RDKit Bond::BondType enum values (GraphMol/Bond.h)
_RDKIT_BOND_CODE = {
    BondType.SINGLE: 1,
    BondType.DOUBLE: 2,
    BondType.TRIPLE: 3,
    BondType.AROMATIC: 12,
}


def _hash_combine(seed: int, v: int) -> int:
    """boost::hash_combine with a 32-bit seed (RDKit's bundled hash)."""
    return (seed ^ (((v & _M32) + 0x9E3779B9 + ((seed << 6) & _M32) + (seed >> 2)) & _M32)) & _M32


def _hash_range(vals) -> int:
    seed = 0
    for v in vals:
        seed = _hash_combine(seed, v)
    return seed


def connectivity_invariants(mol: Mol, include_ring_membership: bool = True) -> list[int]:
    """RDKit ``getConnectivityInvariants`` (MorganFingerprints.cpp)."""
    invs = []
    for a in mol.atoms:
        delta_mass = int(_exact_mass(a.atomic_num, a.isotope) - _standard_weight(a.atomic_num))
        comps = [
            a.atomic_num,
            mol.total_degree(a.idx),
            a.total_num_hs,
            a.formal_charge & _M32,
            delta_mass & _M32,
        ]
        if include_ring_membership and a.is_in_ring:
            comps.append(1)
        invs.append(_hash_range(comps))
    return invs


def _standard_weight(z: int) -> float:
    from chemprop_tpu_torch.chem.mol import MASSES

    return MASSES[z]


def _exact_mass(z: int, isotope: int) -> float:
    """Isotope exact mass for the RDKit mass-defect invariant. The mass
    number itself is accurate enough (C-truncation of ``exact - weight``
    lands on the same integer) for every element except hydrogen, whose
    isotopes sit ABOVE their mass number (D = 2.014)."""
    if not isotope:
        return _standard_weight(z)
    if z == 1:
        return {1: 1.008, 2: 2.014, 3: 3.016}.get(isotope, float(isotope))
    return float(isotope)


def _bond_invariant(b, include_chirality: bool) -> int:
    """RDKit ``MorganBondInvGenerator``: the plain bond-type code, except —
    with ``useChirality`` — a stereo-assigned DOUBLE bond hashes as
    ``stereoOffset(100) + bondTypeOffset(10) * bondType + stereo``."""
    bt = _RDKIT_BOND_CODE.get(b.bond_type, 0)
    if include_chirality and b.bond_type == BondType.DOUBLE and int(b.stereo):
        return 100 + 10 * bt + int(b.stereo)
    return bt


def morgan_environment_invariants(mol: Mol, radius: int, include_chirality: bool = False):
    """Yield every emitted environment invariant (with multiplicity), i.e.
    the values whose ``% fpSize`` are the fingerprint bit positions.

    Achiral molecules match RDKit bit-for-bit (pinned fixtures), with or
    without ``include_chirality``. With it, stereocenter CIP codes and
    double-bond stereo fold into the invariants per the module docstring."""
    n_atoms, n_bonds = mol.num_atoms, mol.num_bonds
    current = connectivity_invariants(mol)
    emitted = list(current)  # round 0: every atom emits its invariant
    if radius == 0 or n_atoms == 0:
        return emitted

    atom_envs = [0] * n_atoms  # bond-set bitmask per atom
    seen_envs: list[int] = []
    # RDKit kills zero-degree atoms before the first layer
    # (MorganFingerprints.cpp: ``if (!tAtom->getDegree()) deadAtoms.set``),
    # so an isolated atom emits ONLY its radius-0 invariant
    dead = [mol.degree(i) == 0 for i in range(n_atoms)]

    # CIP augmentation state: each stereocenter contributes once, at the
    # first layer that processes it (RDKit's chiralAtoms bitset)
    chiral_done = [False] * n_atoms
    cip_codes: dict[int, str | None] = {}
    if include_chirality:
        from chemprop_tpu_torch.chem.mol import ChiralType
        from chemprop_tpu_torch.chem.perception import atom_cip_code

        for i, a in enumerate(mol.atoms):
            if a.chiral_tag in (
                ChiralType.CHI_TETRAHEDRAL_CW,
                ChiralType.CHI_TETRAHEDRAL_CCW,
            ):
                cip_codes[i] = atom_cip_code(mol, i)

    for layer in range(radius):
        round_inv = list(current)
        round_envs = list(atom_envs)
        this_round = []
        for idx in range(n_atoms):
            if dead[idx]:
                continue
            nbrs = []
            env = atom_envs[idx]
            for b in mol.atom_bonds(idx):
                env |= 1 << b.idx
                o = b.other_atom_idx(idx)
                env |= atom_envs[o]
                nbrs.append((_bond_invariant(b, include_chirality), current[o]))
            nbrs.sort()
            invar = _hash_combine(layer, current[idx])
            for bt, ninv in nbrs:
                # boost hashes the std::pair as one unit (seed 0), then
                # combines the pair-hash into the environment invariant
                invar = _hash_combine(invar, _hash_combine(_hash_combine(0, bt), ninv))
            if include_chirality and not chiral_done[idx] and idx in cip_codes:
                code = cip_codes[idx]
                if code is not None:
                    invar = (invar + (1 if code == "R" else 2)) & _M32
                    chiral_done[idx] = True
            round_inv[idx] = invar
            round_envs[idx] = env
            this_round.append((env, invar, idx))
        this_round.sort()
        for env, invar, idx in this_round:
            if env not in seen_envs:
                emitted.append(invar)
                seen_envs.append(env)
            else:
                dead[idx] = True
        current = round_inv
        atom_envs = round_envs
        if n_bonds and all(e == (1 << n_bonds) - 1 or d for e, d in zip(atom_envs, dead)):
            break
    return emitted


def rdkit_morgan_binary(
    mol: Mol, radius: int = 2, length: int = 2048, include_chirality: bool = False
) -> np.ndarray:
    fp = np.zeros(length, dtype=np.uint8)
    for inv in morgan_environment_invariants(mol, radius, include_chirality):
        fp[inv % length] = 1
    return fp


def rdkit_morgan_count(
    mol: Mol, radius: int = 2, length: int = 2048, include_chirality: bool = False
) -> np.ndarray:
    fp = np.zeros(length, dtype=np.int32)
    for inv in morgan_environment_invariants(mol, radius, include_chirality):
        fp[inv % length] += 1
    return fp
