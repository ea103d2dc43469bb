"""Bemis-Murcko scaffolds for scaffold-balanced splitting.

The reference uses RDKit's ``MurckoScaffold`` (via ``astartes``/RDKit inside
``chemprop/data/splitting.py``) and groups molecules by scaffold SMILES.
This implementation extracts the scaffold subgraph natively (ring systems +
linkers + double-bonded ring substituents) and keys it with its canonical
SMILES (:mod:`chemprop_tpu_torch.chem.smiles_writer`).
"""

from __future__ import annotations

from chemprop_tpu_torch.chem.mol import BondType, Mol


def murcko_scaffold_atoms(mol: Mol) -> list[bool]:
    """Flags atoms belonging to the Bemis-Murcko scaffold: the ring/linker
    core (iteratively strip all terminal non-ring atoms) plus atoms directly
    double/triple-bonded to a core atom (exocyclic =O etc., RDKit
    ``MurckoScaffold`` behavior)."""
    n = mol.num_atoms
    keep = [True] * n
    changed = True
    while changed:
        changed = False
        for a in mol.atoms:
            i = a.idx
            if not keep[i] or a.is_in_ring:
                continue
            live = sum(1 for b in mol.atom_bonds(i) if keep[b.other_atom_idx(i)])
            if live <= 1:
                keep[i] = False
                changed = True
    core = list(keep)
    for b in mol.bonds:
        if b.bond_type in (BondType.DOUBLE, BondType.TRIPLE):
            u, v = b.begin_atom_idx, b.end_atom_idx
            if core[u] and not core[v]:
                keep[v] = True
            elif core[v] and not core[u]:
                keep[u] = True
    return keep


def murcko_scaffold_key(mol: Mol, include_chirality: bool = False) -> str:
    """Canonical key of the Murcko scaffold (acyclic molecules -> '')."""
    keep = murcko_scaffold_atoms(mol)
    if not any(keep):
        return ""
    # rebuild the scaffold as a standalone molecule and re-perceive (RDKit
    # recomputes H counts on the scaffold, so "Cc1ccccc1" == "c1ccccc1")
    from chemprop_tpu_torch.chem.mol import Atom
    from chemprop_tpu_torch.chem.perception import sanitize

    sub = Mol()
    remap: dict[int, int] = {}
    for a in mol.atoms:
        if keep[a.idx]:
            na = Atom(
                atomic_num=a.atomic_num,
                formal_charge=a.formal_charge,
                is_aromatic=a.is_aromatic,
                isotope=a.isotope,
                chiral_tag=a.chiral_tag,
            )
            remap[a.idx] = sub.add_atom(na)
    for b in mol.bonds:
        if keep[b.begin_atom_idx] and keep[b.end_atom_idx]:
            nb = sub.add_bond(remap[b.begin_atom_idx], remap[b.end_atom_idx], b.bond_type)
            nb.is_aromatic = b.is_aromatic
    sanitize(sub)
    # canonical Murcko scaffold SMILES (r3): same grouping semantics as the
    # reference's RDKit MurckoScaffold SMILES keys (two molecules share a
    # key iff their scaffold graphs are isomorphic), and human-inspectable
    from chemprop_tpu_torch.chem.smiles_writer import write_smiles

    key = write_smiles(sub)
    if include_chirality:
        tags = sorted(
            (remap[a.idx], int(a.chiral_tag)) for a in mol.atoms if keep[a.idx] and a.chiral_tag
        )
        if tags:
            key += "|" + ",".join(f"{i}:{t}" for i, t in tags)
    return key
