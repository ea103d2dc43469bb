"""Self-contained molecular graph data model.

The reference framework represents molecules as RDKit ``Chem.Mol`` objects
(C++ via boost-python; see reference ``chemprop/utils/utils.py:39-90``). This
framework is TPU-native and dependency-free on the chemistry side: molecules
are plain Python objects produced by the in-repo SMILES parser
(:mod:`chemprop_tpu_torch.chem.smiles`) with perception passes
(:mod:`chemprop_tpu_torch.chem.perception`).

Integer enum values (chiral tags, hybridization, bond stereo) intentionally
mirror RDKit's numeric values so that featurization output (cf. reference
``chemprop/featurizers/atom.py:95-101``) has the same vocabulary indices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from chemprop_tpu_torch.chem.periodic_table import MASSES, SYMBOLS


class BondType(IntEnum):
    UNSPECIFIED = 0
    SINGLE = 1
    DOUBLE = 2
    TRIPLE = 3
    QUADRUPLE = 4
    AROMATIC = 12
    DATIVE = 17

    @property
    def order(self) -> float:
        """Bond-order contribution to atom valence (aromatic = 1.5)."""
        if self == BondType.AROMATIC:
            return 1.5
        if self == BondType.DATIVE:
            return 0.0
        return float(int(self))


class HybridizationType(IntEnum):
    UNSPECIFIED = 0
    S = 1
    SP = 2
    SP2 = 3
    SP3 = 4
    SP2D = 5
    SP3D = 6
    SP3D2 = 7
    OTHER = 8


class ChiralType(IntEnum):
    CHI_UNSPECIFIED = 0
    CHI_TETRAHEDRAL_CW = 1  # written ``@@``
    CHI_TETRAHEDRAL_CCW = 2  # written ``@``
    CHI_OTHER = 3


class BondStereo(IntEnum):
    STEREONONE = 0
    STEREOANY = 1
    STEREOZ = 2
    STEREOE = 3
    STEREOCIS = 4
    STEREOTRANS = 5


class BondDir(IntEnum):
    NONE = 0
    ENDUPRIGHT = 1  # ``/``
    ENDDOWNRIGHT = 2  # ``\\``


@dataclass(slots=True)
class Atom:
    atomic_num: int
    formal_charge: int = 0
    is_aromatic: bool = False
    # Bracket-atom H count; None => implicit Hs are computed by valence rules.
    num_explicit_hs: int | None = None
    isotope: int = 0
    chiral_tag: ChiralType = ChiralType.CHI_UNSPECIFIED
    atom_map_num: int = 0
    # --- fields filled in by sanitization/perception ---
    num_implicit_hs: int = 0
    hybridization: HybridizationType = HybridizationType.UNSPECIFIED
    is_in_ring: bool = False
    idx: int = -1

    @property
    def symbol(self) -> str:
        return SYMBOLS[self.atomic_num]

    @property
    def mass(self) -> float:
        return float(self.isotope) if self.isotope else MASSES[self.atomic_num]

    @property
    def total_num_hs(self) -> int:
        """Implicit + bracket-explicit H count (graph-H neighbors NOT included,
        matching RDKit ``Atom.GetTotalNumHs()`` default semantics)."""
        return (self.num_explicit_hs or 0) + self.num_implicit_hs


@dataclass(slots=True)
class Bond:
    begin_atom_idx: int
    end_atom_idx: int
    bond_type: BondType = BondType.SINGLE
    is_aromatic: bool = False
    is_conjugated: bool = False
    is_in_ring: bool = False
    stereo: BondStereo = BondStereo.STEREONONE
    # cis/trans reference atoms (neighbor on each side used to define Z/E)
    stereo_atoms: tuple[int, int] | None = None
    direction: BondDir = BondDir.NONE
    idx: int = -1

    def other_atom_idx(self, idx: int) -> int:
        return self.end_atom_idx if idx == self.begin_atom_idx else self.begin_atom_idx


@dataclass
class Mol:
    """A molecular graph: atoms, bonds, and an adjacency structure.

    Mirrors the subset of the RDKit ``Mol`` API that the featurization layer
    needs (reference ``chemprop/featurizers/molgraph/molecule.py:45-92``).
    """

    atoms: list[Atom] = field(default_factory=list)
    bonds: list[Bond] = field(default_factory=list)
    # adjacency: atom idx -> list of bond indices
    _adj: list[list[int]] = field(default_factory=list)

    # ------------------------------------------------------------------ build
    def add_atom(self, atom: Atom) -> int:
        atom.idx = len(self.atoms)
        self.atoms.append(atom)
        self._adj.append([])
        return atom.idx

    def add_bond(self, begin: int, end: int, bond_type: BondType = BondType.SINGLE) -> Bond:
        if begin == end:
            raise ValueError(f"self-bond on atom {begin}")
        if self.get_bond_between(begin, end) is not None:
            raise ValueError(f"duplicate bond {begin}-{end}")
        bond = Bond(begin, end, bond_type)
        bond.idx = len(self.bonds)
        self.bonds.append(bond)
        self._adj[begin].append(bond.idx)
        self._adj[end].append(bond.idx)
        return bond

    # ------------------------------------------------------------------ query
    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    @property
    def num_bonds(self) -> int:
        return len(self.bonds)

    def atom_bonds(self, idx: int) -> list[Bond]:
        return [self.bonds[bi] for bi in self._adj[idx]]

    def neighbors(self, idx: int) -> list[int]:
        return [self.bonds[bi].other_atom_idx(idx) for bi in self._adj[idx]]

    def degree(self, idx: int) -> int:
        """Number of explicit (graph) neighbors, incl. explicit-H atoms."""
        return len(self._adj[idx])

    def total_degree(self, idx: int) -> int:
        """Graph degree plus implicit/bracket H count (RDKit GetTotalDegree)."""
        return self.degree(idx) + self.atoms[idx].total_num_hs

    def get_bond_between(self, u: int, v: int) -> Bond | None:
        for bi in self._adj[u]:
            b = self.bonds[bi]
            if b.other_atom_idx(u) == v:
                return b
        return None

    def bond_order_sum(self, idx: int, aromatic_as: float = 1.5) -> float:
        """Sum of bond orders at an atom (not counting implicit Hs)."""
        total = 0.0
        for b in self.atom_bonds(idx):
            if b.bond_type == BondType.AROMATIC:
                total += aromatic_as
            else:
                total += b.bond_type.order
        return total

    def explicit_valence(self, idx: int) -> int:
        """Integer valence from explicit bonds + bracket Hs (aromatic rounds
        the *total* up, Daylight-style)."""
        import math

        v = self.bond_order_sum(idx)
        return int(math.ceil(v)) + (self.atoms[idx].num_explicit_hs or 0)

    def total_valence(self, idx: int) -> int:
        return self.explicit_valence(idx) + self.atoms[idx].num_implicit_hs

    # ------------------------------------------------------------- utilities
    def __repr__(self) -> str:
        return f"Mol(num_atoms={self.num_atoms}, num_bonds={self.num_bonds})"
