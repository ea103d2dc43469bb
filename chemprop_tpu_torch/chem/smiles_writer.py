"""Canonical SMILES writer for the in-repo chemistry substrate.

Fills the substrate's output half (the reference side uses RDKit's
``Chem.MolToSmiles``, e.g. for Murcko scaffold keys inside scaffold-balanced
splitting — ``chemprop/data/splitting.py:28-180``): a permutation-INVARIANT
canonical form via iterative invariant refinement with branch-and-minimize
individualization (the textbook canonical-labeling scheme — refinement
alone, like a WL hash, cannot separate some symmetric non-isomorphic
graphs, and deterministic-index tie-breaks are permutation-dependent).

The emitted string is THIS substrate's canonical form, not byte-identical
to RDKit's (RDKit's ranking priorities are unspecified internals); what it
guarantees is:

* two molecules get the same string iff their perceived graphs are
  isomorphic (same grouping semantics as RDKit canonical SMILES keys);
* ``parse_smiles(write(mol))`` round-trips to an isomorphic molecule.

Tetrahedral/bond stereo is NOT written (scaffold grouping uses
``include_chirality=False``; the writer's other in-repo uses are achiral
keys). Branch width is bounded in practice: molecule cells after refinement
are tiny; a hard cap guards pathological symmetric graphs.
"""

from __future__ import annotations

from chemprop_tpu_torch.chem.mol import BondType, Mol
from chemprop_tpu_torch.chem.periodic_table import SYMBOLS

_ORGANIC = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
_AROMATIC_OK = {"b", "c", "n", "o", "p", "s", "se", "as"}
_BOND_SYM = {
    BondType.SINGLE: "",
    BondType.DOUBLE: "=",
    BondType.TRIPLE: "#",
    BondType.QUADRUPLE: "$",
    BondType.AROMATIC: "",
}
# Daylight default valences for bracket-free organic-subset atoms
_DEFAULT_VALENCE = {
    "B": (3,),
    "C": (4,),
    "N": (3, 5),
    "O": (2,),
    "P": (3, 5),
    "S": (2, 4, 6),
    "F": (1,),
    "Cl": (1,),
    "Br": (1,),
    "I": (1,),
}


def _refine(mol: Mol, ranks: list[int]) -> list[int]:
    """Iteratively refine ranks by sorted neighbor (bond, rank) multisets
    until the partition stabilizes."""
    n = mol.num_atoms
    while True:
        keys = []
        for a in mol.atoms:
            nbrs = sorted(
                (int(b.bond_type), ranks[b.other_atom_idx(a.idx)])
                for b in mol.atom_bonds(a.idx)
            )
            keys.append((ranks[a.idx], tuple(nbrs)))
        order = sorted(range(n), key=lambda i: keys[i])
        new = [0] * n
        r = 0
        for k, i in enumerate(order):
            if k and keys[i] != keys[order[k - 1]]:
                r = k
            new[i] = r
        if new == ranks:
            return ranks
        ranks = new


def _initial_ranks(mol: Mol) -> list[int]:
    # rank on the WRITTEN aromatic state (not the raw flag): an aromatic
    # flag without aromatic bonds is not SMILES-representable, and ranking
    # on it would make the canonical form non-idempotent under reparse
    keys = [
        (
            a.atomic_num,
            int(_written_aromatic(mol, a.idx)),
            a.formal_charge,
            a.total_num_hs,
            a.isotope,
            mol.degree(a.idx),
            int(a.is_in_ring),
        )
        for a in mol.atoms
    ]
    order = sorted(range(mol.num_atoms), key=lambda i: keys[i])
    ranks = [0] * mol.num_atoms
    r = 0
    for k, i in enumerate(order):
        if k and keys[i] != keys[order[k - 1]]:
            r = k
        ranks[i] = r
    return ranks


def canonical_ranks(mol: Mol, _budget: int = 4096) -> list[int]:
    """Canonical atom ranks: refinement + branch-and-minimize
    individualization over the first non-singleton cell. Permutation
    invariant (the branch takes the minimum over all members). The leaf
    budget guards pathological symmetric graphs: molecules never approach
    it (refinement separates cells fast), but a graph that exhausts it may
    lose the same-string-iff-isomorphic guarantee — a DoS/correctness
    tradeoff, not expected for chemical inputs."""
    ranks = _refine(mol, _initial_ranks(mol))

    def discrete(rs):
        return len(set(rs)) == len(rs)

    best: list[int] | None = None
    best_key = None
    budget = [_budget]

    def search(rs):
        nonlocal best, best_key
        if budget[0] <= 0:
            return
        if discrete(rs):
            budget[0] -= 1
            key = _emit_key(mol, rs)
            if best_key is None or key < best_key:
                best, best_key = rs, key
            return
        # first (lowest-rank) non-singleton cell
        from collections import Counter

        counts = Counter(rs)
        target = min(r for r, c in counts.items() if c > 1)
        # orbit pruning: automorphic cell members yield the same refined
        # partition signature — explore each signature once (collapses the
        # factorial branching of symmetric molecules)
        seen_sigs = set()
        for i in range(mol.num_atoms):
            if rs[i] == target:
                # individualize strictly between cells: scale by 3 keeps all
                # other ranks multiples of 3, 3*target - 1 is unique
                child = [3 * r for r in rs]
                child[i] = 3 * target - 1
                refined = _refine(mol, child)
                sig = _emit_key(mol, refined)
                if sig in seen_sigs:
                    continue
                seen_sigs.add(sig)
                search(refined)

    search(ranks)
    return best if best is not None else ranks


def _emit_key(mol: Mol, ranks: list[int]):
    """Total order on labeled graphs for the branch-min comparison."""
    n = mol.num_atoms
    pos = sorted(range(n), key=lambda i: ranks[i])
    rows = []
    for i in pos:
        a = mol.atoms[i]
        nbrs = sorted((ranks[b.other_atom_idx(i)], int(b.bond_type)) for b in mol.atom_bonds(i))
        rows.append(
            (
                a.atomic_num,
                int(_written_aromatic(mol, i)),
                a.formal_charge,
                a.total_num_hs,
                a.isotope,
                tuple(nbrs),
            )
        )
    return tuple(rows)


def _written_aromatic(mol: Mol, idx: int) -> bool:
    """Lowercase output only for atoms that actually sit on AROMATIC-typed
    bonds: an aromatic FLAG without aromatic bonds (a lowercase-written ring
    this substrate's perception kekulized/rejected) must emit uppercase with
    explicit bond orders, or the string would not round-trip."""
    a = mol.atoms[idx]
    sym = SYMBOLS[a.atomic_num] if a.atomic_num < len(SYMBOLS) else "*"
    return (
        a.is_aromatic
        and sym.lower() in _AROMATIC_OK
        and any(b.bond_type == BondType.AROMATIC for b in mol.atom_bonds(idx))
    )


def _atom_token(mol: Mol, idx: int) -> str:
    a = mol.atoms[idx]
    sym = SYMBOLS[a.atomic_num] if a.atomic_num < len(SYMBOLS) else "*"
    lower = sym.lower()
    if _written_aromatic(mol, idx):
        sym_out = lower
    else:
        sym_out = sym
    n_h = a.total_num_hs
    needs_bracket = (
        a.formal_charge != 0
        or a.isotope
        or sym not in _ORGANIC
        or a.atomic_num == 0
    )
    if not needs_bracket:
        # bracket-free atoms must carry exactly the implied H count
        bond_sum = 0.0
        for b in mol.atom_bonds(idx):
            bond_sum += 1.5 if b.bond_type == BondType.AROMATIC else float(int(b.bond_type))
        implied = None
        for v in _DEFAULT_VALENCE[sym]:
            if bond_sum <= v:
                implied = int(v - round(bond_sum)) if not _written_aromatic(mol, idx) else None
                break
        if sym_out != sym:  # written lowercase (aromatic)
            # aromatic H counts are perception-dependent: bracket when H > 0
            # on nitrogen-likes ([nH]); carbons with the standard count stay
            # bare
            if sym_out in ("n", "p") and n_h > 0:
                needs_bracket = True
            elif sym_out == "c":
                needs_bracket = False
            elif n_h > 0:
                needs_bracket = True
        elif implied is None or implied != n_h:
            needs_bracket = True
    if not needs_bracket:
        return sym_out
    parts = ["["]
    if a.isotope:
        parts.append(str(a.isotope))
    parts.append(sym_out)
    if n_h == 1:
        parts.append("H")
    elif n_h > 1:
        parts.append(f"H{n_h}")
    q = a.formal_charge
    if q == 1:
        parts.append("+")
    elif q == -1:
        parts.append("-")
    elif q > 1:
        parts.append(f"+{q}")
    elif q < -1:
        parts.append(f"-{-q}")
    parts.append("]")
    return "".join(parts)


def _bond_token(mol: Mol, b) -> str:
    if b.bond_type == BondType.AROMATIC:
        return ""
    if b.bond_type == BondType.SINGLE:
        u, v = b.begin_atom_idx, b.end_atom_idx
        # single bond between two lowercase-WRITTEN atoms (biphenyl linker)
        # must be explicit or it would read back as aromatic
        if _written_aromatic(mol, u) and _written_aromatic(mol, v):
            return "-"
        return ""
    return _BOND_SYM.get(b.bond_type, "")


def write_smiles(mol: Mol, canonical: bool = True) -> str:
    """Emit a (by default canonical) SMILES string for ``mol``.

    Stereo is not emitted (see module doc). Disconnected fragments join
    with '.'.
    """
    n = mol.num_atoms
    if n == 0:
        return ""
    ranks = canonical_ranks(mol) if canonical else list(range(n))

    visited = [False] * n
    ring_bonds: dict[int, int] = {}  # bond idx -> ring digit
    open_digits: dict[int, int] = {}
    next_digit = [1]

    # pre-compute DFS spanning tree from each component's min-rank root,
    # marking back edges (ring closures)
    def nbrs_sorted(i, parent_bond):
        out = []
        for b in mol.atom_bonds(i):
            if parent_bond is not None and b.idx == parent_bond:
                continue
            out.append((ranks[b.other_atom_idx(i)], b))
        out.sort(key=lambda t: t[0])
        return out

    tree_children: dict[int, list] = {}
    back_edges: dict[int, list] = {}

    def dfs(root):
        # true iterative DFS: a neighbor becomes a tree child only at the
        # moment it is first reached (an already-visited neighbor is a ring
        # closure), so the spanning tree matches sequential emission order
        visited[root] = True
        stack = [(root, iter(nbrs_sorted(root, None)))]
        while stack:
            i, it = stack[-1]
            for _, b in it:
                j = b.other_atom_idx(i)
                if visited[j]:
                    if b.idx not in ring_bonds:
                        ring_bonds[b.idx] = 0  # placeholder; digit at write
                        back_edges.setdefault(i, []).append(b)
                        back_edges.setdefault(j, []).append(b)
                else:
                    visited[j] = True
                    tree_children.setdefault(i, []).append(b)
                    stack.append((j, iter(nbrs_sorted(j, b.idx))))
                    break
            else:
                stack.pop()

    def write_from(root) -> str:
        # iterative emission following tree_children (an explicit work stack
        # — a recursive walk overflows on 1000+-atom chains, exactly the
        # giant polymers the edge-partition work targets)
        out = []
        emitted[root] = True
        stack: list = [("atom", root, None)]
        while stack:
            op, a1, a2 = stack.pop()
            if op == "lit":
                out.append(a1)
                continue
            i, via_bond = a1, a2
            if via_bond is not None:
                out.append(_bond_token(mol, via_bond))
            out.append(_atom_token(mol, i))
            for b in back_edges.get(i, ()):  # open/close ring digits
                if b.idx in open_digits:
                    d = open_digits.pop(b.idx)
                else:
                    d = next_digit[0]
                    next_digit[0] += 1
                    open_digits[b.idx] = d
                out.append(_bond_token(mol, b) + (str(d) if d < 10 else f"%{d:02d}"))
            kids = [b for b in tree_children.get(i, ()) if not emitted[b.other_atom_idx(i)]]
            for b in kids:
                emitted[b.other_atom_idx(i)] = True
            # push in reverse so the first kid is emitted first
            for k in range(len(kids) - 1, -1, -1):
                b = kids[k]
                j = b.other_atom_idx(i)
                if k < len(kids) - 1:
                    stack.append(("lit", ")", None))
                    stack.append(("atom", j, b))
                    stack.append(("lit", "(", None))
                else:
                    stack.append(("atom", j, b))
        return "".join(out)

    # ring closures open at the atom visited FIRST (lower DFS order): swap
    # digits bookkeeping is handled by open_digits above
    emitted = [False] * n
    frags = []
    comp_roots = sorted(range(n), key=lambda i: ranks[i])
    for root in comp_roots:
        if visited[root]:
            continue
        dfs(root)
        frags.append(write_from(root))
    return ".".join(frags)
