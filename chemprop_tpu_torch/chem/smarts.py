"""SMARTS substructure query engine over the in-repo ``Mol`` model.

The reference stack gets substructure matching from RDKit
(``mol.GetSubstructMatches``), which backs the 85 ``fr_*`` fragment
descriptors and the QED structural alerts used by the descriptastorus
``rdkit_2d`` 200-descriptor vector (reference
``chemprop/featurizers/molecule.py:77-99``). This module is a from-scratch
implementation of the SMARTS subset those patterns need:

* atom primitives: ``*`` ``A`` ``a``, element symbols (aromatic lowercase /
  aliphatic uppercase), ``#n``, ``D<n>`` (explicit degree), ``X<n>`` (total
  connectivity), ``H<n>`` (total H count), ``h<n>`` (implicit H), ``v<n>``
  (total valence), ``R<n>`` / ``R`` (SSSR ring membership count), ``r<n>`` /
  ``r`` (smallest-ring size), ``+``/``-`` charges (with digit or repetition),
  isotope prefix digits, atom maps ``:n`` (parsed, ignored), chirality ``@``
  ``@@`` (parsed, ignored — fragment patterns don't constrain chirality),
  recursive SMARTS ``$(...)``;
* logical operators ``!`` (not), ``&`` (high-and), ``,`` (or), ``;``
  (low-and), and implicit-and by adjacency;
* bond primitives ``-`` ``=`` ``#`` ``:`` ``~`` ``@`` ``/`` ``\\`` with the
  same logical operators; the default (absent) bond is "single or aromatic";
* branches, ring-closure digits (incl. ``%nn``) and dot-disconnected
  components are NOT needed by the fragment set (no ``.`` patterns) — dots
  raise.

Matching is a straightforward backtracking subgraph isomorphism seeded at
every molecule atom, with RDKit-compatible ``uniquify`` semantics (matches
that hit the same *set* of molecule atoms count once).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

from chemprop_tpu_torch.chem.mol import Bond, BondType, Mol
from chemprop_tpu_torch.chem.periodic_table import SYMBOLS

_SYMBOL_TO_NUM = {s: i for i, s in enumerate(SYMBOLS) if s}

# two-letter organic-subset / common bracket symbols the tokenizer must try first
_TWO_LETTER = sorted((s for s in _SYMBOL_TO_NUM if len(s) == 2), key=len, reverse=True)


class SmartsError(ValueError):
    pass


# --------------------------------------------------------------------------- #
# Query predicate tree
# --------------------------------------------------------------------------- #


@dataclass(slots=True)
class _Prim:
    """Leaf predicate: (kind, value)."""

    kind: str
    value: object = None

    def matches_atom(self, mol: Mol, idx: int) -> bool:
        a = mol.atoms[idx]
        k, v = self.kind, self.value
        if k == "any":
            return True
        if k == "elem":
            return a.atomic_num == v
        if k == "elem_arom":  # lowercase symbol: element AND aromatic
            return a.atomic_num == v and a.is_aromatic
        if k == "elem_aliph":  # uppercase symbol: element AND NOT aromatic
            return a.atomic_num == v and not a.is_aromatic
        if k == "arom":
            return a.is_aromatic
        if k == "aliph":
            return not a.is_aromatic
        if k == "degree":
            return mol.degree(idx) == v
        if k == "connectivity":  # X: explicit degree + total Hs
            return mol.degree(idx) + a.total_num_hs == v
        if k == "total_h":
            return a.total_num_hs == v
        if k == "implicit_h":
            return a.num_implicit_hs == v
        if k == "valence":
            return mol.total_valence(idx) == v
        if k == "ring_count":  # R<n>: member of exactly n SSSR rings
            n = sum(1 for r in getattr(mol, "rings", []) if idx in r)
            return n == v
        if k == "in_ring":
            return a.is_in_ring if v else not a.is_in_ring
        if k == "ring_size":  # r<n>: smallest ring containing atom has size n
            sizes = [len(r) for r in getattr(mol, "rings", []) if idx in r]
            return bool(sizes) and min(sizes) == v
        if k == "charge":
            return a.formal_charge == v
        if k == "isotope":
            return a.isotope == v
        if k == "chiral":
            return True  # parsed, not constrained (see module docstring)
        if k == "recursive":
            return _recursive_hit(v, mol, idx)
        raise AssertionError(f"unknown atom primitive {k!r}")

    def matches_bond(self, bond: Bond) -> bool:
        k = self.kind
        if k == "b_any":
            return True
        if k == "b_single":
            return bond.bond_type == BondType.SINGLE and not bond.is_aromatic
        if k == "b_double":
            return bond.bond_type == BondType.DOUBLE and not bond.is_aromatic
        if k == "b_triple":
            return bond.bond_type == BondType.TRIPLE
        if k == "b_arom":
            return bond.is_aromatic or bond.bond_type == BondType.AROMATIC
        if k == "b_ring":
            return bond.is_in_ring
        if k == "b_default":  # unwritten bond: single or aromatic
            return (
                bond.bond_type == BondType.SINGLE and not bond.is_aromatic
            ) or (bond.is_aromatic or bond.bond_type == BondType.AROMATIC)
        raise AssertionError(f"unknown bond primitive {k!r}")


@dataclass(slots=True)
class _Not:
    child: object

    def matches_atom(self, mol: Mol, idx: int) -> bool:
        return not self.child.matches_atom(mol, idx)

    def matches_bond(self, bond: Bond) -> bool:
        return not self.child.matches_bond(bond)


@dataclass(slots=True)
class _And:
    children: list

    def matches_atom(self, mol: Mol, idx: int) -> bool:
        return all(c.matches_atom(mol, idx) for c in self.children)

    def matches_bond(self, bond: Bond) -> bool:
        return all(c.matches_bond(bond) for c in self.children)


@dataclass(slots=True)
class _Or:
    children: list

    def matches_atom(self, mol: Mol, idx: int) -> bool:
        return any(c.matches_atom(mol, idx) for c in self.children)

    def matches_bond(self, bond: Bond) -> bool:
        return any(c.matches_bond(bond) for c in self.children)


def _recursive_hit(pattern: "SmartsPattern", mol: Mol, idx: int) -> bool:
    """True if ``pattern`` matches with its first query atom anchored at idx."""
    return pattern._matches_rooted(mol, idx)


# --------------------------------------------------------------------------- #
# Pattern graph
# --------------------------------------------------------------------------- #


@dataclass(slots=True)
class _QAtom:
    pred: object
    idx: int
    # list of (neighbor qatom idx, bond predicate)
    neighbors: list = field(default_factory=list)


class SmartsPattern:
    """A parsed SMARTS query."""

    def __init__(self, qatoms: list[_QAtom], smarts: str):
        self.qatoms = qatoms
        self.smarts = smarts
        # match order: DFS from atom 0 so each new query atom (after the
        # first) has at least one already-mapped neighbor -> cheap pruning
        self._order, self._anchor = self._plan()

    @classmethod
    def from_string(cls, smarts: str) -> "SmartsPattern":
        return _parse(smarts)

    # ------------------------------------------------------------- planning
    def _plan(self):
        n = len(self.qatoms)
        seen = [False] * n
        order: list[int] = []
        anchor: list[list[tuple[int, object]]] = [[] for _ in range(n)]
        stack = [0]
        while stack:
            qi = stack.pop()
            if seen[qi]:
                continue
            seen[qi] = True
            order.append(qi)
            for nbr, bpred in self.qatoms[qi].neighbors:
                if seen[nbr]:
                    continue
                stack.append(nbr)
        if not all(seen):
            raise SmartsError(f"disconnected SMARTS not supported: {self.smarts!r}")
        pos = {qi: k for k, qi in enumerate(order)}
        for qi in order:
            for nbr, bpred in self.qatoms[qi].neighbors:
                if pos[nbr] < pos[qi]:
                    anchor[qi].append((nbr, bpred))
        return order, anchor

    # ------------------------------------------------------------- matching
    def _extend(self, mol: Mol, mapping: dict[int, int], used: set[int], k: int, out, first_only: bool) -> bool:
        if k == len(self._order):
            out.append(tuple(mapping[qi] for qi in range(len(self.qatoms))))
            return first_only
        qi = self._order[k]
        qa = self.qatoms[qi]
        anchors = self._anchor[qi]
        if anchors:
            # candidates = mol-neighbors of the first anchored query neighbor
            nbr_q, bpred0 = anchors[0]
            base = mapping[nbr_q]
            cands = []
            for b in mol.atom_bonds(base):
                m = b.other_atom_idx(base)
                if m in used or not bpred0.matches_bond(b):
                    continue
                cands.append(m)
        else:  # only the root has no anchor
            cands = range(mol.num_atoms)
        for m in cands:
            if m in used or not qa.pred.matches_atom(mol, m):
                continue
            ok = True
            for nbr_q, bpred in anchors[1:] if anchors else ():
                b = mol.get_bond_between(m, mapping[nbr_q])
                if b is None or not bpred.matches_bond(b):
                    ok = False
                    break
            if not ok:
                continue
            mapping[qi] = m
            used.add(m)
            if self._extend(mol, mapping, used, k + 1, out, first_only):
                return True
            used.discard(m)
            del mapping[qi]
        return False

    def get_matches(self, mol: Mol, uniquify: bool = True) -> list[tuple[int, ...]]:
        root = self._order[0]
        out: list[tuple[int, ...]] = []
        for start in range(mol.num_atoms):
            if not self.qatoms[root].pred.matches_atom(mol, start):
                continue
            self._extend(mol, {root: start}, {start}, 1, out, first_only=False)
        if uniquify:
            seen: set[frozenset[int]] = set()
            uniq = []
            for m in out:
                key = frozenset(m)
                if key not in seen:
                    seen.add(key)
                    uniq.append(m)
            return uniq
        return out

    def count_matches(self, mol: Mol, uniquify: bool = True) -> int:
        return len(self.get_matches(mol, uniquify))

    def has_match(self, mol: Mol) -> bool:
        return self._first_match(mol) is not None

    def _first_match(self, mol: Mol):
        root = self._order[0]
        out: list[tuple[int, ...]] = []
        for start in range(mol.num_atoms):
            if not self.qatoms[root].pred.matches_atom(mol, start):
                continue
            if self._extend(mol, {root: start}, {start}, 1, out, first_only=True):
                return out[0]
        return None

    def _matches_rooted(self, mol: Mol, start: int) -> bool:
        root = self._order[0]
        if not self.qatoms[root].pred.matches_atom(mol, start):
            return False
        out: list[tuple[int, ...]] = []
        return self._extend(mol, {root: start}, {start}, 1, out, first_only=True)


# --------------------------------------------------------------------------- #
# Parser
# --------------------------------------------------------------------------- #

_BOND_CHARS = "-=#:~@/\\"


class _Parser:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    # ------------------------------------------------------------- low level
    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def take(self) -> str:
        c = self.peek()
        self.i += 1
        return c

    def expect(self, c: str):
        if self.take() != c:
            raise SmartsError(f"expected {c!r} at {self.i - 1} in {self.s!r}")

    def number(self, default=None):
        j = self.i
        while self.i < len(self.s) and self.s[self.i].isdigit():
            self.i += 1
        if self.i == j:
            return default
        return int(self.s[j : self.i])

    # ----------------------------------------------------------------- atoms
    def parse(self) -> SmartsPattern:
        qatoms: list[_QAtom] = []
        ring_open: dict[int, tuple[int, object | None]] = {}
        stack: list[int] = []
        prev: int | None = None
        pending_bond: object | None = None

        def add_bond(a: int, b: int, bpred):
            if bpred is None:
                bpred = _Prim("b_default")
            qatoms[a].neighbors.append((b, bpred))
            qatoms[b].neighbors.append((a, bpred))

        while self.i < len(self.s):
            c = self.peek()
            if c == "(":
                self.take()
                if prev is None:
                    raise SmartsError(f"branch with no prior atom in {self.s!r}")
                stack.append(prev)
            elif c == ")":
                self.take()
                if not stack:
                    raise SmartsError(f"unbalanced ')' in {self.s!r}")
                prev = stack.pop()
            elif c in _BOND_CHARS or c == "!":
                pending_bond = self._bond_expr()
            elif c.isdigit() or c == "%":
                if c == "%":
                    self.take()
                    d1, d2 = self.take(), self.take()
                    num = int(d1 + d2)
                else:
                    num = int(self.take())
                if prev is None:
                    raise SmartsError(f"ring closure with no prior atom in {self.s!r}")
                if num in ring_open:
                    other, obond = ring_open.pop(num)
                    add_bond(prev, other, pending_bond or obond)
                else:
                    ring_open[num] = (prev, pending_bond)
                pending_bond = None
            elif c == ".":
                raise SmartsError("disconnected ('.') SMARTS not supported")
            else:
                pred = self._atom_expr()
                qi = len(qatoms)
                qatoms.append(_QAtom(pred, qi))
                if prev is not None:
                    add_bond(prev, qi, pending_bond)
                pending_bond = None
                prev = qi
        if ring_open:
            raise SmartsError(f"unclosed ring bond(s) {sorted(ring_open)} in {self.s!r}")
        if stack:
            raise SmartsError(f"unbalanced '(' in {self.s!r}")
        if not qatoms:
            raise SmartsError(f"empty SMARTS {self.s!r}")
        return SmartsPattern(qatoms, self.s)

    def _atom_expr(self):
        c = self.peek()
        if c == "[":
            self.take()
            pred = self._expr(self._atom_prim, depth="low")
            self.expect("]")
            return pred
        return self._bare_atom()

    def _bare_atom(self):
        """Organic-subset atom outside brackets."""
        c = self.take()
        if c == "*":
            return _Prim("any")
        if c == "A":
            return _Prim("aliph")
        if c == "a":
            return _Prim("arom")
        # two-letter aliphatic (Cl, Br) — only these are legal bare
        if c in "CB" and self.peek() in "lr":
            sym = c + self.peek()
            if sym in ("Cl", "Br"):
                self.take()
                return _Prim("elem_aliph", _SYMBOL_TO_NUM[sym])
        if c.isupper():
            if c not in _SYMBOL_TO_NUM:
                raise SmartsError(f"unknown element {c!r} in {self.s!r}")
            return _Prim("elem_aliph", _SYMBOL_TO_NUM[c])
        if c.islower():
            sym = c.upper()
            if sym not in _SYMBOL_TO_NUM:
                raise SmartsError(f"unknown aromatic element {c!r} in {self.s!r}")
            return _Prim("elem_arom", _SYMBOL_TO_NUM[sym])
        raise SmartsError(f"unexpected {c!r} at {self.i - 1} in {self.s!r}")

    # --------------------------------------------------- logical expressions
    def _expr(self, prim_fn, depth="low"):
        """low:  x;y  (weakest) / mid: x,y / high: x&y + implicit-and."""
        if depth == "low":
            parts = [self._expr(prim_fn, "mid")]
            while self.peek() == ";":
                self.take()
                parts.append(self._expr(prim_fn, "mid"))
            return parts[0] if len(parts) == 1 else _And(parts)
        if depth == "mid":
            parts = [self._expr(prim_fn, "high")]
            while self.peek() == ",":
                self.take()
                parts.append(self._expr(prim_fn, "high"))
            return parts[0] if len(parts) == 1 else _Or(parts)
        # high: & or implicit adjacency
        parts = [self._unary(prim_fn)]
        while True:
            c = self.peek()
            if c == "&":
                self.take()
                parts.append(self._unary(prim_fn))
            elif c and c not in ";,]()" and not self._at_bond_boundary(prim_fn):
                parts.append(self._unary(prim_fn))
            else:
                break
        return parts[0] if len(parts) == 1 else _And(parts)

    def _at_bond_boundary(self, prim_fn) -> bool:
        """For bond expressions parsed outside brackets, implicit-and ends
        where an atom begins. Atom expressions always sit inside [...] here,
        so this only matters for bonds."""
        if prim_fn.__func__ is _Parser._atom_prim:
            return False
        return self.peek() not in _BOND_CHARS and self.peek() != "!"

    def _unary(self, prim_fn):
        if self.peek() == "!":
            self.take()
            return _Not(self._unary(prim_fn))
        return prim_fn()

    # -------------------------------------------------------- atom primitive
    def _atom_prim(self):
        c = self.peek()
        if c == "$":
            self.take()
            self.expect("(")
            j = self.i
            bal = 1
            while bal:
                ch = self.take()
                if not ch:
                    raise SmartsError(f"unbalanced '$(' in {self.s!r}")
                if ch == "(":
                    bal += 1
                elif ch == ")":
                    bal -= 1
            inner = self.s[j : self.i - 1]
            return _Prim("recursive", _parse(inner))
        if c == "*":
            self.take()
            return _Prim("any")
        if c == "#":
            self.take()
            n = self.number()
            if n is None:
                raise SmartsError(f"'#' needs a number in {self.s!r}")
            return _Prim("elem", n)
        if c.isdigit():  # isotope
            return _Prim("isotope", self.number())
        if c == "+":
            self.take()
            n = self.number(default=None)
            if n is None:
                n = 1
                while self.peek() == "+":
                    self.take()
                    n += 1
            return _Prim("charge", n)
        if c == "-":
            self.take()
            n = self.number(default=None)
            if n is None:
                n = 1
                while self.peek() == "-":
                    self.take()
                    n += 1
            return _Prim("charge", -n)
        if c == "@":
            self.take()
            if self.peek() == "@":
                self.take()
            return _Prim("chiral")
        if c == ":":
            self.take()
            self.number()  # atom map, ignored
            return _Prim("any")
        # letter-keyed primitives. Order matters: try two-letter element
        # symbols first, but H/D/X/v/R/r/h/a/A are primitives, not elements,
        # when in brackets.
        for sym in _TWO_LETTER:
            if self.s.startswith(sym, self.i):
                self.i += len(sym)
                return _Prim("elem_aliph", _SYMBOL_TO_NUM[sym])
        self.take()
        if c == "D":
            return _Prim("degree", self.number(default=1))
        if c == "X":
            return _Prim("connectivity", self.number(default=1))
        if c == "H":
            return _Prim("total_h", self.number(default=1))
        if c == "h":
            return _Prim("implicit_h", self.number(default=1))
        if c == "v":
            return _Prim("valence", self.number(default=1))
        if c == "R":
            n = self.number(default=None)
            if n is None:
                return _Prim("in_ring", True)
            if n == 0:
                return _Prim("in_ring", False)
            return _Prim("ring_count", n)
        if c == "r":
            n = self.number(default=None)
            if n is None:
                return _Prim("in_ring", True)
            return _Prim("ring_size", n)
        if c == "a":
            return _Prim("arom")
        if c == "A":
            return _Prim("aliph")
        if c.isupper():
            if c in _SYMBOL_TO_NUM:
                return _Prim("elem_aliph", _SYMBOL_TO_NUM[c])
            raise SmartsError(f"unknown primitive {c!r} in {self.s!r}")
        if c.islower():
            sym = c.upper()
            if sym in _SYMBOL_TO_NUM:
                return _Prim("elem_arom", _SYMBOL_TO_NUM[sym])
        raise SmartsError(f"unknown primitive {c!r} in {self.s!r}")

    # -------------------------------------------------------- bond primitive
    def _bond_expr(self):
        return self._expr(self._bond_prim, "low")

    def _bond_prim(self):
        c = self.take()
        if c == "-":
            return _Prim("b_single")
        if c == "=":
            return _Prim("b_double")
        if c == "#":
            return _Prim("b_triple")
        if c == ":":
            return _Prim("b_arom")
        if c == "~":
            return _Prim("b_any")
        if c == "@":
            return _Prim("b_ring")
        if c in "/\\":
            return _Prim("b_single")  # directional bonds match as single
        raise SmartsError(f"unknown bond primitive {c!r} in {self.s!r}")


@lru_cache(maxsize=4096)
def _parse(smarts: str) -> SmartsPattern:
    return _Parser(smarts).parse()


def smarts(pattern: str) -> SmartsPattern:
    """Parse (with caching) a SMARTS string."""
    return _parse(pattern)


def count_matches(mol: Mol, pattern: str, uniquify: bool = True) -> int:
    return smarts(pattern).count_matches(mol, uniquify)


def has_match(mol: Mol, pattern: str) -> bool:
    return smarts(pattern).has_match(mol)
