"""A self-contained SMILES parser.

The reference framework parses SMILES with RDKit (``Chem.MolFromSmiles``, cf.
reference ``chemprop/utils/utils.py:39-90``). RDKit is a large C++ dependency
that is not part of this framework's TPU-first stack, so we implement the
OpenSMILES grammar directly: organic-subset atoms, bracket atoms (isotope,
chirality, H count, charge, atom maps), all bond symbols, ring closures
(including ``%nn``), branches, and dot-disconnected fragments.

Output is a :class:`~chemprop_tpu_torch.chem.mol.Mol`, which is then run through the
perception pipeline (:mod:`chemprop_tpu_torch.chem.perception`) to fill in implicit
hydrogens, aromaticity, conjugation, hybridization, ring flags, and bond
stereo — the exact attribute set the featurizers consume.
"""

from __future__ import annotations

from chemprop_tpu_torch.chem.mol import Atom, Bond, BondDir, BondType, ChiralType, Mol
from chemprop_tpu_torch.chem.periodic_table import ATOMIC_NUM, AROMATIC_SYMBOLS, ORGANIC_SUBSET


class SmilesParseError(ValueError):
    def __init__(self, smiles: str, pos: int, msg: str):
        super().__init__(f"Failed to parse SMILES {smiles!r} at position {pos}: {msg}")
        self.smiles = smiles
        self.pos = pos


_BOND_SYMBOLS = {
    "-": BondType.SINGLE,
    "=": BondType.DOUBLE,
    "#": BondType.TRIPLE,
    "$": BondType.QUADRUPLE,
    ":": BondType.AROMATIC,
}

# sentinel order for "no explicit bond symbol written" — resolved after ring
# perception: aromatic if both atoms aromatic and the bond is in a ring
_IMPLICIT = BondType.UNSPECIFIED

_TWO_CHAR_ORGANIC = ("Cl", "Br")


def parse_smiles(smiles: str) -> Mol:
    """Parse a SMILES string into an (unsanitized) :class:`Mol`.

    Use :func:`chemprop_tpu_torch.chem.make_mol` for the full parse + perception
    pipeline.
    """
    mol = Mol()
    s = smiles
    n = len(s)
    i = 0

    prev_atom: int | None = None
    prev_stack: list[int | None] = []
    pending_bond: BondType = _IMPLICIT
    pending_dir: BondDir = BondDir.NONE
    # ring number -> (atom idx, bond type, bond dir)
    ring_closures: dict[int, tuple[int, BondType, BondDir]] = {}
    # closing atom -> ring digits closed there, in appearance order (for the
    # chirality parity adjustment below)
    closed_digits: dict[int, list[int]] = {}
    # bond idx -> written as implicit (no symbol)
    implicit_bonds: set[int] = set()

    def add_parsed_atom(atom: Atom) -> None:
        nonlocal prev_atom, pending_bond, pending_dir
        idx = mol.add_atom(atom)
        if prev_atom is not None:
            _make_bond(mol, prev_atom, idx, pending_bond, pending_dir, implicit_bonds, s, i)
        prev_atom = idx
        pending_bond = _IMPLICIT
        pending_dir = BondDir.NONE

    while i < n:
        c = s[i]

        if c == "(":
            if prev_atom is None:
                raise SmilesParseError(s, i, "branch with no root atom")
            prev_stack.append(prev_atom)
            i += 1
        elif c == ")":
            if not prev_stack:
                raise SmilesParseError(s, i, "unmatched ')'")
            prev_atom = prev_stack.pop()
            i += 1
        elif c == ".":
            prev_atom = None
            pending_bond = _IMPLICIT
            pending_dir = BondDir.NONE
            i += 1
        elif c in _BOND_SYMBOLS:
            pending_bond = _BOND_SYMBOLS[c]
            i += 1
        elif c == "/":
            pending_bond = BondType.SINGLE
            pending_dir = BondDir.ENDUPRIGHT
            i += 1
        elif c == "\\":
            pending_bond = BondType.SINGLE
            pending_dir = BondDir.ENDDOWNRIGHT
            i += 1
        elif c.isdigit() or c == "%":
            if prev_atom is None:
                raise SmilesParseError(s, i, "ring closure with no open atom")
            if c == "%":
                if i + 2 >= n or not (s[i + 1].isdigit() and s[i + 2].isdigit()):
                    raise SmilesParseError(s, i, "'%' must be followed by two digits")
                num = int(s[i + 1 : i + 3])
                i += 3
            else:
                num = int(c)
                i += 1
            if num in ring_closures:
                other, other_bond, other_dir = ring_closures.pop(num)
                bond_type = _reconcile_ring_bond(other_bond, pending_bond, s, i)
                direction = pending_dir if pending_dir != BondDir.NONE else _flip(other_dir)
                _make_bond(
                    mol, other, prev_atom, bond_type, direction, implicit_bonds, s, i, ring=True
                )
                closed_digits.setdefault(prev_atom, []).append(num)
            else:
                ring_closures[num] = (prev_atom, pending_bond, pending_dir)
            pending_bond = _IMPLICIT
            pending_dir = BondDir.NONE
        elif c == "[":
            j = s.find("]", i)
            if j < 0:
                raise SmilesParseError(s, i, "unclosed bracket atom")
            atom = _parse_bracket_atom(s, i + 1, j)
            add_parsed_atom(atom)
            i = j + 1
        elif c == "*":
            add_parsed_atom(Atom(atomic_num=0, num_explicit_hs=0))
            i += 1
        else:
            # organic subset atom (possibly two-char, possibly aromatic)
            sym = None
            for two in _TWO_CHAR_ORGANIC:
                if s.startswith(two, i):
                    sym = two
                    break
            if sym is None:
                sym = c
            aromatic = sym[0].islower()
            lookup = sym.capitalize() if aromatic else sym
            if lookup not in ORGANIC_SUBSET:
                raise SmilesParseError(s, i, f"unknown atom symbol {sym!r}")
            if aromatic and sym.lower() not in AROMATIC_SYMBOLS:
                raise SmilesParseError(s, i, f"{sym!r} cannot be aromatic")
            add_parsed_atom(Atom(atomic_num=ATOMIC_NUM[lookup], is_aromatic=aromatic))
            i += len(sym)

    if prev_stack:
        raise SmilesParseError(s, n, "unclosed branch '('")
    if ring_closures:
        raise SmilesParseError(s, n, f"unclosed ring closures: {sorted(ring_closures)}")

    # RDKit parity quirk (observed against RDKit-generated goldens, cf.
    # tests/data/mol_atom_bond/atomic_regression_atom_mapped_preds.csv):
    # when one atom CLOSES several rings, RDKit's effective neighbor order
    # for tetrahedral parity has those ring bonds sorted by ring DIGIT, not
    # by appearance — ``[C@]21[H]`` flips relative to ``[C@]12[H]``. Our
    # bond list keeps appearance order, so a chiral closing atom's tag must
    # absorb the digit-sort permutation parity.
    for atom_idx, nums in closed_digits.items():
        atom = mol.atoms[atom_idx]
        if len(nums) >= 2 and atom.chiral_tag in (
            ChiralType.CHI_TETRAHEDRAL_CW,
            ChiralType.CHI_TETRAHEDRAL_CCW,
        ):
            if _perm_parity_to_sorted(nums):
                atom.chiral_tag = (
                    ChiralType.CHI_TETRAHEDRAL_CCW
                    if atom.chiral_tag == ChiralType.CHI_TETRAHEDRAL_CW
                    else ChiralType.CHI_TETRAHEDRAL_CW
                )
    mol._implicit_bond_idxs = implicit_bonds  # consumed by perception
    return mol


def _perm_parity_to_sorted(nums: list[int]) -> bool:
    """True if sorting ``nums`` ascending (stable) is an ODD permutation."""
    order = sorted(range(len(nums)), key=lambda k: nums[k])
    swaps = 0
    seen = [False] * len(order)
    for start in range(len(order)):
        if seen[start]:
            continue
        cycle = 0
        k = start
        while not seen[k]:
            seen[k] = True
            k = order[k]
            cycle += 1
        swaps += cycle - 1
    return swaps % 2 == 1


def _flip(d: BondDir) -> BondDir:
    """A ring-closure direction written only at the *opening* position applies
    with begin/end swapped relative to how the bond is stored."""
    if d == BondDir.ENDUPRIGHT:
        return BondDir.ENDDOWNRIGHT
    if d == BondDir.ENDDOWNRIGHT:
        return BondDir.ENDUPRIGHT
    return d


def _reconcile_ring_bond(a: BondType, b: BondType, s: str, pos: int) -> BondType:
    if a == _IMPLICIT:
        return b
    if b == _IMPLICIT or a == b:
        return a
    raise SmilesParseError(s, pos, f"conflicting ring-closure bond orders {a!r} vs {b!r}")


def _make_bond(
    mol: Mol,
    u: int,
    v: int,
    bond_type: BondType,
    direction: BondDir,
    implicit_bonds: set[int],
    s: str,
    pos: int,
    ring: bool = False,
) -> Bond:
    implicit = bond_type == _IMPLICIT
    if implicit:
        both_aromatic = mol.atoms[u].is_aromatic and mol.atoms[v].is_aromatic
        bond_type = BondType.AROMATIC if both_aromatic else BondType.SINGLE
    try:
        bond = mol.add_bond(u, v, bond_type)
    except ValueError as e:
        raise SmilesParseError(s, pos, str(e)) from None
    bond.direction = direction
    if implicit and bond.bond_type == BondType.AROMATIC:
        # may be demoted to SINGLE if it turns out not to be a ring bond
        # (e.g. biphenyl written without the explicit '-')
        implicit_bonds.add(bond.idx)
    return bond


def _parse_bracket_atom(s: str, start: int, end: int) -> Atom:
    """Parse the contents of ``[...]`` (``start``/``end`` delimit the inside)."""
    i = start
    # isotope
    isotope = 0
    while i < end and s[i].isdigit():
        isotope = isotope * 10 + int(s[i])
        i += 1
    # symbol (one or two chars, possibly aromatic-lowercase)
    if i >= end:
        raise SmilesParseError(s, i, "bracket atom missing symbol")
    sym = None
    if i + 1 < end and s[i : i + 2] in ATOMIC_NUM and s[i].isupper() and s[i + 1].islower():
        sym = s[i : i + 2]
        aromatic = False
    elif i + 1 < end and s[i : i + 2].lower() in AROMATIC_SYMBOLS and s[i].islower():
        sym = s[i : i + 2]
        aromatic = True
    if sym is None:
        sym = s[i]
        aromatic = sym.islower()
        if aromatic and sym not in AROMATIC_SYMBOLS:
            raise SmilesParseError(s, i, f"{sym!r} cannot be aromatic")
    lookup = sym[0].upper() + sym[1:] if aromatic else sym
    if lookup == "*":
        atomic_num = 0
    elif lookup in ATOMIC_NUM:
        atomic_num = ATOMIC_NUM[lookup]
    else:
        raise SmilesParseError(s, i, f"unknown element {sym!r}")
    i += len(sym)

    atom = Atom(
        atomic_num=atomic_num, is_aromatic=aromatic, isotope=isotope, num_explicit_hs=0
    )

    # chirality
    if i < end and s[i] == "@":
        if i + 1 < end and s[i + 1] == "@":
            atom.chiral_tag = ChiralType.CHI_TETRAHEDRAL_CW
            i += 2
        else:
            atom.chiral_tag = ChiralType.CHI_TETRAHEDRAL_CCW
            i += 1
        # extended chirality classes (@TH1, @AL1, @SP1 ...): mark OTHER
        for cls in ("TH", "AL", "SP", "TB", "OH"):
            if s.startswith(cls, i):
                atom.chiral_tag = ChiralType.CHI_OTHER
                i += len(cls)
                while i < end and s[i].isdigit():
                    i += 1
                break

    # explicit H count
    if i < end and s[i] == "H":
        i += 1
        h = 1
        if i < end and s[i].isdigit():
            h = 0
            while i < end and s[i].isdigit():
                h = h * 10 + int(s[i])
                i += 1
        atom.num_explicit_hs = h

    # formal charge
    if i < end and s[i] in "+-":
        sign = 1 if s[i] == "+" else -1
        i += 1
        if i < end and s[i].isdigit():
            mag = 0
            while i < end and s[i].isdigit():
                mag = mag * 10 + int(s[i])
                i += 1
        else:
            mag = 1
            while i < end and s[i] == ("+" if sign > 0 else "-"):
                mag += 1
                i += 1
        atom.formal_charge = sign * mag

    # atom map
    if i < end and s[i] == ":":
        i += 1
        if i >= end or not s[i].isdigit():
            raise SmilesParseError(s, i, "atom map ':' must be followed by digits")
        m = 0
        while i < end and s[i].isdigit():
            m = m * 10 + int(s[i])
            i += 1
        atom.atom_map_num = m

    if i != end:
        raise SmilesParseError(s, i, f"unexpected bracket-atom content {s[i:end]!r}")

    return atom
