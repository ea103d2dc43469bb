"""Myerson-value atom attributions and MCTS rationales (cf.
``chemprop_tpu/interpret.py``), over the port's ``MPNN``.

The Myerson value is the Shapley value of the graph-restricted game: the
worth of an atom subset ``S`` is the sum of the model's predictions over the
connected components of the subgraph induced by ``S``,

    v(S) = sum_{C in components(S)} f(C),        v({}) = 0,

and atom ``i``'s attribution is its Shapley value under ``v``. Molecules of
at most ``sampling_threshold`` atoms enumerate all ``2^n`` subsets; larger
ones sample permutations of marginal contributions.

Subset and component bookkeeping is integer bitmask work on the host, in
numpy, as in the JAX package. Every distinct connected subgraph is evaluated
by the model in padded batches of ``graphs_per_batch`` graphs, one pad per
call (the JAX package's pad, which it jits once): ``batch_mol_graphs`` and
``MPNN.forward`` on the explainer's device under ``torch.no_grad``, so that
on the card the forward runs through the hand-written kernels. Such a batch
holds many single atoms without edges, and its last chunk ends in graphs
without nodes."""

from __future__ import annotations

from dataclasses import dataclass, field
from math import lgamma, sqrt
from typing import Sequence

import numpy as np
import torch

from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs, pad_to_bucket
from chemprop_tpu_torch.types import MolGraph
from chemprop_tpu_torch.utils.device import resolve_device


def _neighbor_masks(mg: MolGraph) -> list[int]:
    n = mg.V.shape[0]
    nb = [0] * n
    src, dst = mg.edge_index
    for u, v in zip(src.tolist(), dst.tolist()):
        nb[u] |= 1 << v
        nb[v] |= 1 << u
    return nb


def _component(members: int, start_bit: int, nb: Sequence[int]) -> int:
    """Connected component of ``start_bit`` within the ``members`` bitmask."""
    comp = 1 << start_bit
    frontier = comp
    while frontier:
        grow = 0
        f = frontier
        while f:
            b = f & -f
            grow |= nb[b.bit_length() - 1]
            f ^= b
        new = grow & members & ~comp
        comp |= new
        frontier = new
    return comp


def _submolgraph(mg: MolGraph, mask: int) -> MolGraph:
    atoms = [i for i in range(mg.V.shape[0]) if mask >> i & 1]
    relabel = {a: k for k, a in enumerate(atoms)}
    src, dst = mg.edge_index
    keep = [
        e
        for e in range(src.shape[0])
        if (mask >> int(src[e]) & 1) and (mask >> int(dst[e]) & 1)
    ]
    new_idx = {e: k for k, e in enumerate(keep)}
    V = mg.V[atoms]
    E = mg.E[keep] if keep else np.zeros((0, mg.E.shape[1]), dtype=mg.E.dtype)
    edge_index = np.array(
        [[relabel[int(src[e])] for e in keep], [relabel[int(dst[e])] for e in keep]],
        dtype=np.int32,
    ).reshape(2, -1)
    rev = np.array([new_idx[int(mg.rev_edge_index[e])] for e in keep], dtype=np.int32)
    return MolGraph(V=V, E=E, edge_index=edge_index, rev_edge_index=rev)


def subgraph_pad(mg: MolGraph, n_masks: int, graphs_per_batch: int) -> PadSpec:
    """The one pad of every chunk of an explanation of ``mg`` over
    ``n_masks`` subgraphs: room for ``B`` copies of the whole molecule."""
    B = min(graphs_per_batch, max(1, n_masks))
    n = mg.V.shape[0]
    return PadSpec(pad_to_bucket(B * n + 1), pad_to_bucket(max(1, B * mg.E.shape[0])), B)


def check_explainable(model) -> None:
    """Raise unless the explainers can attribute ``model``'s predictions: a
    single-molecule ``MPNN`` with a regression or binary classification head
    (the heads whose forward is the quantity to attribute). The JAX package
    checks the head for its Myerson callback alone, and the single molecule
    for neither (``ROADMAP.md`` section 3); the port checks both for both
    explainers."""
    from chemprop_tpu_torch.nn.message_passing import MulticomponentMessagePassing
    from chemprop_tpu_torch.nn.predictors import BinaryClassificationFFN, RegressionFFN

    if not hasattr(model, "predictor"):
        raise ValueError("interpretation explains single-molecule models; a mol-atom-bond "
                         "model (ROADMAP.md section 1 item 8) is refused: its predictions "
                         "are per atom and per bond")
    if isinstance(model.message_passing, MulticomponentMessagePassing):
        raise ValueError("interpretation explains single-molecule models; a multicomponent "
                         "or reaction model (ROADMAP.md section 1 item 7) is refused: its "
                         "subgraphs would need every component")
    if not isinstance(model.predictor, (RegressionFFN, BinaryClassificationFFN)):
        raise NotImplementedError(
            "Myerson explanations and MCTS rationales support regression and binary "
            f"classification heads, got {type(model.predictor).__name__}")


class MyersonExplainer:
    """Computes per-atom Myerson attributions for an :class:`MPNN`.

    Restricted (like the JAX package) to single-output-per-task heads whose
    forward yields the quantity to attribute directly: regression means and
    binary-classification probabilities. ``model`` is the port's module, in
    its compute dtype; ``device`` is where its forward runs (``None``: the
    GPU, which raises where there is none)."""

    def __init__(
        self,
        model,
        sampling_threshold: int = 20,
        n_samples: int = 200,
        graphs_per_batch: int = 256,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        self.model = model
        self.sampling_threshold = sampling_threshold
        self.n_samples = n_samples
        self.graphs_per_batch = graphs_per_batch
        self.seed = seed
        self.device = resolve_device(device)

    # ------------------------------------------------------------- model eval
    def _eval_masks(self, mg: MolGraph, masks: list[int]) -> np.ndarray:
        """Model outputs ``[len(masks), t]`` for the induced subgraphs."""
        pad = subgraph_pad(mg, len(masks), self.graphs_per_batch)
        B = pad.n_graphs
        outs = []
        with torch.no_grad():
            for c0 in range(0, len(masks), B):
                chunk = masks[c0 : c0 + B]
                bmg = batch_mol_graphs([_submolgraph(mg, m) for m in chunk], pad)
                out = self.model(bmg.to(self.device))
                outs.append(out[: len(chunk)].float().cpu().numpy())
        out = np.concatenate(outs, axis=0) if outs else np.zeros((0, 1), dtype=np.float32)
        if out.ndim == 3:  # (mean, extra-head) outputs: attribute the mean
            out = out[..., 0]
        return out

    # ------------------------------------------------------------------ exact
    def _explain_exact(self, mg: MolGraph) -> np.ndarray:
        n = mg.V.shape[0]
        nb = _neighbor_masks(mg)
        size = 1 << n

        comp_of = np.zeros(size, dtype=np.int64)  # subset -> component id
        rest = np.zeros(size, dtype=np.int64)  # subset minus that component
        comp_ids: dict[int, int] = {}
        for S in range(1, size):
            j = (S & -S).bit_length() - 1
            C = _component(S, j, nb)
            cid = comp_ids.setdefault(C, len(comp_ids))
            comp_of[S] = cid
            rest[S] = S & ~C

        f_vals = self._eval_masks(mg, list(comp_ids.keys()))  # [n_comps, t]
        t = f_vals.shape[1]

        # v(S) via component DP, vectorized by popcount level (rest always
        # has strictly fewer bits than S, so levels resolve in order)
        vhat = np.zeros((size, t))
        all_masks = np.arange(size, dtype=np.int64)
        pops = np.array([int(m).bit_count() for m in range(size)], dtype=np.int64)
        for k in range(1, n + 1):
            Sk = all_masks[pops == k]
            vhat[Sk] = f_vals[comp_of[Sk]] + vhat[rest[Sk]]

        # Shapley weights w(s) = s! (n-s-1)! / n!
        logw = np.array(
            [lgamma(s + 1) + lgamma(n - s) - lgamma(n + 1) for s in range(n)]
        )
        w = np.exp(logw)

        phi = np.zeros((n, t))
        for i in range(n):
            bit = 1 << i
            without = all_masks[(all_masks & bit) == 0]
            marg = vhat[without | bit] - vhat[without]
            phi[i] = (w[pops[without]][:, None] * marg).sum(axis=0)
        return phi

    # --------------------------------------------------------------- sampling
    def _explain_sampling(self, mg: MolGraph) -> np.ndarray:
        n = mg.V.shape[0]
        nb = _neighbor_masks(mg)
        rng = np.random.default_rng(self.seed)
        perms = [rng.permutation(n) for _ in range(self.n_samples)]

        # pass 1: record, for every permutation step, the merged component
        # and the components it absorbs — all masks are known without f
        comp_ids: dict[int, int] = {}
        steps = []  # per perm: list of (atom, new_cid, [absorbed cids])
        for perm in perms:
            comps: list[int] = []  # current component masks
            rec = []
            for a in perm:
                bit = 1 << int(a)
                adj = [c for c in comps if c & nb[a]]
                new = bit
                for c in adj:
                    new |= c
                comps = [c for c in comps if not (c & nb[a])] + [new]
                rec.append(
                    (
                        int(a),
                        comp_ids.setdefault(new, len(comp_ids)),
                        [comp_ids.setdefault(c, len(comp_ids)) for c in adj],
                    )
                )
            steps.append(rec)

        f_vals = self._eval_masks(mg, list(comp_ids.keys()))
        t = f_vals.shape[1]
        phi = np.zeros((n, t))
        for rec in steps:
            for a, new_cid, adj_cids in rec:
                marg = f_vals[new_cid] - sum((f_vals[c] for c in adj_cids), np.zeros(t))
                phi[a] += marg
        return phi / self.n_samples

    # ------------------------------------------------------------------ entry
    def explain(self, mg: MolGraph) -> np.ndarray:
        """Myerson values ``[n_atoms, t]`` for one molecule's graph."""
        n = mg.V.shape[0]
        if n == 0:
            return np.zeros((0, 1))
        if n <= self.sampling_threshold:
            return self._explain_exact(mg)
        return self._explain_sampling(mg)


# =========================================================================
# Monte Carlo Tree Search rationale extraction (Jin et al., arXiv:2002.03244)
# =========================================================================
#
# Repeatedly delete one peripheral cluster (a non-ring bond or an SSSR ring)
# from the molecule, guided by PUCT, and keep small substructures whose
# predicted property stays above a threshold ("rationales"). As in the JAX
# package, states are keyed by atom-subset bitmask, each expansion scores all
# its new children in one padded batch of induced sub-MolGraphs (the Myerson
# evaluator), subgraphs keep the parent molecule's perceived features, and
# rationale SMILES are written once at the end, for reporting only.


@dataclass
class MCTSNode:
    """One search state: an atom subset of the molecule (``mask`` bitmask).

    ``W``/``N`` are the usual total action value and visit count; ``P`` is
    the model's predicted property for this subset's induced subgraph (the
    prior in the PUCT rule, "R" in Jin et al.)."""

    mask: int
    n_atoms: int
    W: float = 0.0
    N: int = 0
    P: float = 0.0
    children: list["MCTSNode"] = field(default_factory=list)

    def Q(self) -> float:
        return self.W / self.N if self.N > 0 else 0.0

    def U(self, sibling_visits: int, c_puct: float) -> float:
        return c_puct * self.P * sqrt(sibling_visits) / (1 + self.N)


def find_deletion_clusters(mol) -> tuple[list[int], list[set[int]]]:
    """Deletion units of the Jin et al. action space, as atom bitmasks:
    every non-ring bond and every SSSR ring. Returns ``(clusters,
    atom_cls)`` where ``atom_cls[a]`` is the set of cluster indices
    containing atom ``a``."""
    n = mol.num_atoms
    if n == 1:
        return [1], [{0}]
    clusters: list[int] = []
    for b in mol.bonds:
        if not b.is_in_ring:
            clusters.append(1 << b.begin_atom_idx | 1 << b.end_atom_idx)
    for ring in mol.rings:
        m = 0
        for a in ring:
            m |= 1 << a
        clusters.append(m)
    atom_cls: list[set[int]] = [set() for _ in range(n)]
    for i, m in enumerate(clusters):
        for a in _bits(m):
            atom_cls[a].add(i)
    return clusters, atom_cls


def _bits(mask: int):
    while mask:
        b = mask & -mask
        yield b.bit_length() - 1
        mask ^= b


def subgraph_smiles(mol, mask: int) -> str | None:
    """Canonical SMILES of the induced subgraph (reporting only): rebuild
    the selected atoms and bonds as a standalone molecule, re-perceive,
    write. ``None`` when the fragment does not survive sanitization."""
    from chemprop_tpu_torch.chem.mol import Atom, Mol
    from chemprop_tpu_torch.chem.perception import sanitize
    from chemprop_tpu_torch.chem.smiles_writer import write_smiles

    try:
        sub = Mol()
        remap: dict[int, int] = {}
        for a in mol.atoms:
            if mask >> a.idx & 1:
                na = Atom(
                    atomic_num=a.atomic_num,
                    formal_charge=a.formal_charge,
                    is_aromatic=a.is_aromatic,
                    isotope=a.isotope,
                    chiral_tag=a.chiral_tag,
                )
                remap[a.idx] = sub.add_atom(na)
        for b in mol.bonds:
            if mask >> b.begin_atom_idx & 1 and mask >> b.end_atom_idx & 1:
                nb = sub.add_bond(remap[b.begin_atom_idx], remap[b.end_atom_idx], b.bond_type)
                nb.is_aromatic = b.is_aromatic
        sanitize(sub)
        return write_smiles(sub)
    except Exception:
        return None


class MCTSRationaleExplainer:
    """Extracts property rationales (small high-scoring substructures) from
    a single-molecule :class:`MPNN` by Monte Carlo Tree Search.

    ``explain(smiles)`` returns rationale dicts sorted by score
    (descending): ``{"atoms": [...], "smiles": str | None, "score": float,
    "n_atoms": int}``. ``featurizer`` makes the molecule's graph (default:
    ``SimpleMoleculeMolGraphFeaturizer()``); pass the one the model was
    trained with."""

    def __init__(
        self,
        model,
        featurizer=None,
        n_rollout: int = 10,
        max_atoms: int = 20,
        min_atoms: int = 8,
        prop_delta: float = 0.5,
        c_puct: float = 10.0,
        property_index: int = 0,
        graphs_per_batch: int = 256,
        device: str | torch.device | None = None,
    ):
        if featurizer is None:
            from chemprop_tpu_torch.featurizers.molgraph import SimpleMoleculeMolGraphFeaturizer

            featurizer = SimpleMoleculeMolGraphFeaturizer()
        self.model = model
        self.featurizer = featurizer
        self.n_rollout = n_rollout
        self.max_atoms = max_atoms
        self.min_atoms = min_atoms
        self.prop_delta = prop_delta
        self.c_puct = c_puct
        self.property_index = property_index
        self._scorer = None if model is None else MyersonExplainer(
            model, graphs_per_batch=graphs_per_batch, device=device)

    def _score_masks(self, mg: MolGraph, masks: list[int]) -> np.ndarray:
        """Predicted property ``[len(masks)]`` of the induced subgraphs, one
        padded batch per chunk (the Myerson evaluator)."""
        out = self._scorer._eval_masks(mg, masks)
        return out[:, self.property_index]

    def _rollout(self, node: MCTSNode, state_map, mg, clusters, atom_cls, nei_cls) -> float:
        if node.n_atoms <= self.min_atoms:
            return node.P
        if not node.children:
            cur = node.mask
            cur_cls = {i for i, m in enumerate(clusters) if m & cur == m}
            fresh: list[MCTSNode] = []
            for i in cur_cls:
                # leaf atoms belong to no other still-present cluster;
                # deletion rule per Jin et al.: the cluster is peripheral
                # (one present neighbor cluster), or it is a 2-atom bond
                # with exactly one leaf end
                leaf = 0
                for a in _bits(clusters[i]):
                    if atom_cls[a] & cur_cls == {i}:
                        leaf |= 1 << a
                n_leaf = leaf.bit_count()
                if not (
                    len(nei_cls[i] & cur_cls) == 1
                    or (clusters[i].bit_count() == 2 and n_leaf == 1)
                ):
                    continue
                new_mask = cur & ~leaf
                if new_mask == 0 or n_leaf == 0:
                    continue
                child = state_map.get(new_mask)
                if child is None:
                    child = MCTSNode(new_mask, new_mask.bit_count())
                    state_map[new_mask] = child
                    fresh.append(child)
                node.children.append(child)
            if not node.children:
                return node.P  # no deletable peripheral cluster
            if fresh:
                scores = self._score_masks(mg, [c.mask for c in fresh])
                for child, s in zip(fresh, scores):
                    child.P = float(s)
        total = sum(c.N for c in node.children)
        chosen = max(node.children, key=lambda c: c.Q() + c.U(total, self.c_puct))
        v = self._rollout(chosen, state_map, mg, clusters, atom_cls, nei_cls)
        chosen.W += v
        chosen.N += 1
        return v

    def explain(self, smiles: str) -> list[dict]:
        """Run the search for one molecule; returns rationales with at most
        ``max_atoms`` atoms scoring at least ``prop_delta``."""
        from chemprop_tpu_torch.chem import make_mol

        return self.explain_mol(make_mol(smiles))

    def explain_mol(self, mol) -> list[dict]:
        """Same as :meth:`explain` for an already-parsed molecule."""
        n = mol.num_atoms
        if n == 0:
            return []
        mg = self.featurizer(mol)
        clusters, atom_cls = find_deletion_clusters(mol)
        nei_cls = [
            set().union(*(atom_cls[a] for a in _bits(m))) - {i}
            for i, m in enumerate(clusters)
        ]
        full = (1 << n) - 1
        root = MCTSNode(full, n)
        root.P = float(self._score_masks(mg, [full])[0])
        state_map: dict[int, MCTSNode] = {full: root}
        for _ in range(self.n_rollout):
            self._rollout(root, state_map, mg, clusters, atom_cls, nei_cls)
        rationales = [
            node
            for node in state_map.values()
            if node.n_atoms <= self.max_atoms and node.P >= self.prop_delta
        ]
        rationales.sort(key=lambda nd: nd.P, reverse=True)
        return [
            {
                "atoms": list(_bits(nd.mask)),
                "smiles": subgraph_smiles(mol, nd.mask),
                "score": nd.P,
                "n_atoms": nd.n_atoms,
            }
            for nd in rationales
        ]
