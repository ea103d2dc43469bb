"""Self-contained chemistry substrate (SMILES in, perceived molecular graphs out).

Replaces the reference framework's RDKit dependency (reference
``chemprop/utils/utils.py:39-90`` ``make_mol``) with an in-repo implementation:
parser (:mod:`.smiles`), perception (:mod:`.perception`), fingerprints
(:mod:`.morgan`), and scaffolds (:mod:`.scaffold`).
"""

from __future__ import annotations

from chemprop_tpu_torch.chem.mol import (
    Atom,
    Bond,
    BondDir,
    BondStereo,
    BondType,
    ChiralType,
    HybridizationType,
    Mol,
)
from chemprop_tpu_torch.chem.perception import sanitize
from chemprop_tpu_torch.chem.smiles import SmilesParseError, parse_smiles

__all__ = [
    "Atom",
    "Bond",
    "BondDir",
    "BondStereo",
    "BondType",
    "ChiralType",
    "HybridizationType",
    "Mol",
    "SmilesParseError",
    "make_mol",
    "parse_smiles",
    "sanitize",
]


def make_mol(
    smi: str,
    keep_h: bool = False,
    add_h: bool = False,
    ignore_stereo: bool = False,
    reorder_atoms: bool = False,
) -> Mol:
    """SMILES -> sanitized :class:`Mol`.

    Mirrors the semantics of the reference ``make_mol``
    (``chemprop/utils/utils.py:39-90``):

    * ``keep_h=False``: explicit ``[H]`` graph atoms are folded into their
      heavy neighbor's H count (isotopic H like ``[2H]`` is kept);
    * ``add_h=True``: all implicit Hs become explicit graph atoms;
    * ``ignore_stereo=True``: chiral tags, bond stereo, and bond directions
      are cleared;
    * ``reorder_atoms=True``: atoms are sorted by atom-map number.
    """
    mol = parse_smiles(smi)
    if not keep_h:
        mol = _remove_explicit_hs(mol)
    sanitize(mol)
    if add_h:
        mol = _add_explicit_hs(mol)
    if ignore_stereo:
        for atom in mol.atoms:
            atom.chiral_tag = ChiralType.CHI_UNSPECIFIED
        for bond in mol.bonds:
            bond.stereo = BondStereo.STEREONONE
            bond.stereo_atoms = None
            bond.direction = BondDir.NONE
    if reorder_atoms:
        mol = _reorder_by_atom_map(mol)
    return mol


def _rebuild(mol: Mol, keep_atom: list[bool]) -> Mol:
    """Rebuild a Mol keeping flagged atoms (and bonds among them), preserving
    atom order and all perceived attributes."""
    new = Mol()
    remap: dict[int, int] = {}
    for atom in mol.atoms:
        if keep_atom[atom.idx]:
            old_idx = atom.idx
            remap[old_idx] = new.add_atom(atom)
    implicit_bond_idxs: set[int] = set()
    old_implicit = getattr(mol, "_implicit_bond_idxs", set())
    for bond in mol.bonds:
        u, v = bond.begin_atom_idx, bond.end_atom_idx
        if keep_atom[u] and keep_atom[v]:
            old_bond_idx = bond.idx
            nb = new.add_bond(remap[u], remap[v], bond.bond_type)
            nb.is_aromatic = bond.is_aromatic
            nb.is_conjugated = bond.is_conjugated
            nb.is_in_ring = bond.is_in_ring
            nb.stereo = bond.stereo
            nb.direction = bond.direction
            if old_bond_idx in old_implicit:
                implicit_bond_idxs.add(nb.idx)
            if bond.stereo_atoms is not None and all(keep_atom[i] for i in bond.stereo_atoms):
                nb.stereo_atoms = tuple(remap[i] for i in bond.stereo_atoms)
    new._implicit_bond_idxs = implicit_bond_idxs
    return new


def _remove_explicit_hs(mol: Mol) -> Mol:
    """Fold explicit ``[H]`` graph atoms into their neighbor's H count."""
    keep = [True] * mol.num_atoms
    changed = False
    for atom in mol.atoms:
        if (
            atom.atomic_num == 1
            and atom.isotope == 0
            and atom.formal_charge == 0
            and atom.atom_map_num == 0  # mapped Hs carry reaction information
            and mol.degree(atom.idx) == 1
            and not (atom.num_explicit_hs or 0)
        ):
            bond = mol.atom_bonds(atom.idx)[0]
            if bond.bond_type != BondType.SINGLE:
                continue
            nbr = mol.atoms[bond.other_atom_idx(atom.idx)]
            if nbr.atomic_num == 1:
                continue  # H-H
            # organic-subset neighbors (num_explicit_hs is None) re-absorb the
            # H via implicit valence counting during sanitize; bracket atoms
            # get their explicit count incremented (RDKit RemoveHs semantics)
            if nbr.num_explicit_hs is not None:
                nbr.num_explicit_hs += 1
            keep[atom.idx] = False
            changed = True
    if not changed:
        return mol
    return _rebuild(mol, keep)


def _add_explicit_hs(mol: Mol) -> Mol:
    """Make every implicit/bracket H an explicit graph atom."""
    for atom in list(mol.atoms):
        n_h = atom.total_num_hs
        atom.num_explicit_hs = 0
        atom.num_implicit_hs = 0
        for _ in range(n_h):
            h = Atom(atomic_num=1, num_explicit_hs=0)
            h.hybridization = HybridizationType.S
            h_idx = mol.add_atom(h)
            mol.add_bond(atom.idx, h_idx, BondType.SINGLE)
    return mol


def _reorder_by_atom_map(mol: Mol) -> Mol:
    order = sorted(range(mol.num_atoms), key=lambda i: mol.atoms[i].atom_map_num)
    new = Mol()
    remap: dict[int, int] = {}
    for old_idx in order:
        remap[old_idx] = new.add_atom(mol.atoms[old_idx])
    for bond in mol.bonds:
        nb = new.add_bond(
            remap[bond.begin_atom_idx], remap[bond.end_atom_idx], bond.bond_type
        )
        nb.is_aromatic = bond.is_aromatic
        nb.is_conjugated = bond.is_conjugated
        nb.is_in_ring = bond.is_in_ring
        nb.stereo = bond.stereo
        nb.direction = bond.direction
        if bond.stereo_atoms is not None:
            nb.stereo_atoms = tuple(remap[i] for i in bond.stereo_atoms)
    return new
