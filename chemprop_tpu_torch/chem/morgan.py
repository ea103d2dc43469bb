"""Hashed circular fingerprints and canonical graph hashing of a :class:`Mol`
(cf. ``chemprop_tpu/chem/morgan.py``): ECFP-style environment identifiers
and their binary and count fingerprints, the JAX package's own vocabulary
(a blake2b hash, so the bits are not RDKit's; ``chem/morgan_rdkit.py``
gives the RDKit-compatible bits that ``MorganBinaryFeaturizer`` and the
``kennard_stone`` split use), bit for bit the JAX module's; and a
Weisfeiler-Lehman style key, which the ``random_with_repeated_smiles`` split
groups molecules by."""

from __future__ import annotations

import hashlib
import struct

import numpy as np

from chemprop_tpu_torch.chem.mol import BondType, Mol


def _hash_ints(*vals: int) -> int:
    """Stable 64-bit hash of an integer tuple (endianness-independent)."""
    raw = struct.pack(f"<{len(vals)}q", *[v & 0x7FFFFFFFFFFFFFFF for v in vals])
    return int.from_bytes(hashlib.blake2b(raw, digest_size=8).digest(), "little")


def _initial_invariants(mol: Mol) -> list[int]:
    inv = []
    for a in mol.atoms:
        inv.append(
            _hash_ints(
                a.atomic_num,
                mol.degree(a.idx),
                a.total_num_hs,
                a.formal_charge,
                int(a.is_in_ring),
                int(a.is_aromatic),
                a.isotope,
            )
        )
    return inv


_BOND_CODE = {
    BondType.SINGLE: 1,
    BondType.DOUBLE: 2,
    BondType.TRIPLE: 3,
    BondType.AROMATIC: 4,
}


def morgan_identifiers(mol: Mol, radius: int = 2) -> list[int]:
    """All (atom, radius<=r) environment identifiers."""
    inv = _initial_invariants(mol)
    ids = list(inv)
    for _ in range(radius):
        new_inv = []
        for a in mol.atoms:
            nbrs = sorted(
                (_BOND_CODE.get(b.bond_type, 5), inv[b.other_atom_idx(a.idx)])
                for b in mol.atom_bonds(a.idx)
            )
            flat = [inv[a.idx]]
            for code, ninv in nbrs:
                flat += [code, ninv]
            new_inv.append(_hash_ints(*flat))
        inv = new_inv
        ids.extend(inv)
    return ids


def morgan_binary_fingerprint(mol: Mol, radius: int = 2, length: int = 2048) -> np.ndarray:
    """Hashed binary circular fingerprint: bit ``id % length`` set for each
    environment identifier."""
    fp = np.zeros(length, dtype=np.int32)
    for ident in morgan_identifiers(mol, radius):
        fp[ident % length] = 1
    return fp


def morgan_count_fingerprint(mol: Mol, radius: int = 2, length: int = 2048) -> np.ndarray:
    """Hashed count circular fingerprint: each environment identifier adds
    one at ``id % length``."""
    fp = np.zeros(length, dtype=np.int32)
    for ident in morgan_identifiers(mol, radius):
        fp[ident % length] += 1
    return fp


def canonical_key(mol: Mol, iterations: int = 8) -> str:
    """A canonical, permutation-invariant key for a molecular graph
    (Weisfeiler-Lehman refinement + sorted multiset hash). Used where the
    reference uses canonical SMILES strings as dictionary keys (e.g. scaffold
    grouping)."""
    if mol.num_atoms == 0:
        return "empty"
    inv = _initial_invariants(mol)
    for _ in range(iterations):
        new_inv = []
        for a in mol.atoms:
            nbrs = sorted(
                _hash_ints(_BOND_CODE.get(b.bond_type, 5), inv[b.other_atom_idx(a.idx)])
                for b in mol.atom_bonds(a.idx)
            )
            new_inv.append(_hash_ints(inv[a.idx], *nbrs))
        if sorted(new_inv) == sorted(inv):
            break
        inv = new_inv
    bond_codes = sorted(
        _hash_ints(
            _BOND_CODE.get(b.bond_type, 5),
            *sorted((inv[b.begin_atom_idx], inv[b.end_atom_idx])),
        )
        for b in mol.bonds
    )
    final = _hash_ints(mol.num_atoms, mol.num_bonds, *sorted(inv), *bond_codes)
    return f"{final:016x}"
