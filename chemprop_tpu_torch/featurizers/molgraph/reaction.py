"""Condensed Graph of Reaction (CGR) featurization.

Same semantics as the reference CGR featurizer (``chemprop/featurizers/
molgraph/reaction.py:45-332``; Heid & Green, JCIM 2022) over the in-repo chem
substrate: reactant and product are atom-mapped; node features concatenate
the reactant-side block with either the product block or the feature
difference (minus the atomic-number one-hot), and edges are the union of
reactant/product bonds with per-side feature blocks. Six modes:
{REAC_PROD, REAC_DIFF, PROD_DIFF} x {plain, _BALANCE}.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import auto

import numpy as np

from chemprop_tpu_torch.chem.mol import Atom, Bond, Mol
from chemprop_tpu_torch.featurizers.atom import MultiHotAtomFeaturizer
from chemprop_tpu_torch.featurizers.bond import MultiHotBondFeaturizer
from chemprop_tpu_torch.types import MolGraph
from chemprop_tpu_torch.utils.utils import EnumMapping

Rxn = tuple[Mol, Mol]


class RxnMode(EnumMapping):
    REAC_PROD = auto()
    REAC_PROD_BALANCE = auto()
    REAC_DIFF = auto()
    REAC_DIFF_BALANCE = auto()
    PROD_DIFF = auto()
    PROD_DIFF_BALANCE = auto()

    @property
    def balanced(self) -> bool:
        return self.name.endswith("BALANCE")


@dataclass
class CondensedGraphOfReactionFeaturizer:
    atom_featurizer: MultiHotAtomFeaturizer = field(default_factory=MultiHotAtomFeaturizer.v2)
    bond_featurizer: MultiHotBondFeaturizer = field(default_factory=MultiHotBondFeaturizer)
    mode_: str | RxnMode = RxnMode.REAC_DIFF

    def __post_init__(self):
        self.mode = RxnMode.get(self.mode_)
        d_a = len(self.atom_featurizer)
        self._n_atomic_block = len(self.atom_featurizer.blocks[0].choices) + 1
        # second block drops the atomic-number one-hot
        self.atom_fdim = 2 * d_a - self._n_atomic_block
        self.bond_fdim = 2 * len(self.bond_featurizer)

    @property
    def shape(self) -> tuple[int, int]:
        return self.atom_fdim, self.bond_fdim

    # ------------------------------------------------------------- mapping
    @classmethod
    def map_reac_to_prod(
        cls, rct: Mol, pdt: Mol
    ) -> tuple[dict[int, int], list[int], list[int]]:
        """Atom-map based correspondence: returns (reactant idx -> product
        idx, product-only idxs, reactant-only idxs)."""
        pdt_only = []
        mapno2pj = {}
        rct_mapnos = {a.atom_map_num for a in rct.atoms}
        for a in pdt.atoms:
            if a.atom_map_num > 0:
                mapno2pj[a.atom_map_num] = a.idx
                if a.atom_map_num not in rct_mapnos:
                    pdt_only.append(a.idx)
            else:
                pdt_only.append(a.idx)
        rct_only = []
        r2p = {}
        for a in rct.atoms:
            if a.atom_map_num > 0 and a.atom_map_num in mapno2pj:
                r2p[a.idx] = mapno2pj[a.atom_map_num]
            else:
                rct_only.append(a.idx)
        return r2p, pdt_only, rct_only

    # ---------------------------------------------------------------- call
    def __call__(
        self,
        rxn: Rxn,
        atom_features_extra: np.ndarray | None = None,
        bond_features_extra: np.ndarray | None = None,
    ) -> MolGraph:
        rct, pdt = rxn
        r2p, pdt_only, rct_only = self.map_reac_to_prod(rct, pdt)

        V = self._node_features(rct, pdt, r2p, pdt_only, rct_only)
        n_tot = len(V)
        n_rct = rct.num_atoms

        E_rows: list[np.ndarray] = []
        src: list[int] = []
        dst: list[int] = []
        for u in range(n_tot):
            for v in range(u + 1, n_tot):
                b_r, b_p = self._get_bonds(rct, pdt, r2p, pdt_only, n_rct, u, v)
                if b_r is None and b_p is None:
                    continue
                x_e = self._edge_feature(rct, pdt, b_r, b_p)
                E_rows.extend([x_e, x_e])
                src.extend([u, v])
                dst.extend([v, u])

        E = np.array(E_rows, dtype=np.float32) if E_rows else np.empty(
            (0, self.bond_fdim), dtype=np.float32
        )
        edge_index = np.array([src, dst], dtype=np.int32).reshape(2, -1)
        rev_edge_index = np.arange(len(E), dtype=np.int32).reshape(-1, 2)[:, ::-1].ravel()
        return MolGraph(V.astype(np.float32), E, edge_index, rev_edge_index)

    # ------------------------------------------------------------ features
    def _feat(self, mol: Mol, atom: Atom) -> np.ndarray:
        return self.atom_featurizer.featurize(mol, atom)

    def _num_only(self, mol: Mol, atom: Atom) -> np.ndarray:
        return self.atom_featurizer.num_only(mol, atom)

    def _node_features(self, rct, pdt, r2p, pdt_only, rct_only) -> np.ndarray:
        d = len(self.atom_featurizer)
        X_r1 = np.array([self._feat(rct, a) for a in rct.atoms]).reshape(-1, d)
        balanced = self.mode.balanced

        if not balanced:
            X_r2 = np.array([self._num_only(pdt, pdt.atoms[i]) for i in pdt_only]).reshape(-1, d)
            X_p1 = np.array(
                [
                    self._feat(pdt, pdt.atoms[r2p[a.idx]])
                    if a.idx not in rct_only
                    else self._num_only(rct, a)
                    for a in rct.atoms
                ]
            ).reshape(-1, d)
        else:
            X_r2 = np.array([self._feat(pdt, pdt.atoms[i]) for i in pdt_only]).reshape(-1, d)
            X_p1 = np.array(
                [
                    self._feat(pdt, pdt.atoms[r2p[a.idx]])
                    if a.idx not in rct_only
                    else self._feat(rct, a)
                    for a in rct.atoms
                ]
            ).reshape(-1, d)
        X_p2 = np.array([self._feat(pdt, pdt.atoms[i]) for i in pdt_only]).reshape(-1, d)

        X_r = np.concatenate([X_r1, X_r2]) if len(X_r2) else X_r1
        X_p = np.concatenate([X_p1, X_p2]) if len(X_p2) else X_p1
        m = min(len(X_r), len(X_p))
        k = self._n_atomic_block

        match self.mode:
            case RxnMode.REAC_PROD | RxnMode.REAC_PROD_BALANCE:
                return np.hstack([X_r[:m], X_p[:m, k:]])
            case RxnMode.REAC_DIFF | RxnMode.REAC_DIFF_BALANCE:
                return np.hstack([X_r[:m], (X_p[:m] - X_r[:m])[:, k:]])
            case _:
                return np.hstack([X_p[:m], (X_p[:m] - X_r[:m])[:, k:]])

    def _get_bonds(
        self, rct: Mol, pdt: Mol, r2p, pdt_only, n_rct: int, u: int, v: int
    ) -> tuple[Bond | None, Bond | None]:
        balanced = self.mode.balanced
        if u >= n_rct and v >= n_rct:
            b_p = pdt.get_bond_between(pdt_only[u - n_rct], pdt_only[v - n_rct])
            b_r = b_p if balanced else None
        elif u < n_rct and v >= n_rct:
            b_r = None
            if u in r2p:
                b_p = pdt.get_bond_between(r2p[u], pdt_only[v - n_rct])
            else:
                b_p = None
        else:
            b_r = rct.get_bond_between(u, v)
            if u in r2p and v in r2p:
                b_p = pdt.get_bond_between(r2p[u], r2p[v])
            elif balanced:
                b_p = None if (u in r2p or v in r2p) else b_r
            else:
                b_p = None
        return b_r, b_p

    def _edge_feature(self, rct, pdt, b_r: Bond | None, b_p: Bond | None) -> np.ndarray:
        x_r = self.bond_featurizer.featurize(rct, b_r)
        x_p = self.bond_featurizer.featurize(pdt, b_p)
        match self.mode:
            case RxnMode.REAC_PROD | RxnMode.REAC_PROD_BALANCE:
                return np.hstack([x_r, x_p])
            case RxnMode.REAC_DIFF | RxnMode.REAC_DIFF_BALANCE:
                return np.hstack([x_r, x_p - x_r])
            case _:
                return np.hstack([x_p, x_p - x_r])


CGRFeaturizer = CondensedGraphOfReactionFeaturizer
