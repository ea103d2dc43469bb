"""Datapoint records (cf. ``chemprop_tpu/data/datapoints.py``): one sample is
a molecule with its targets ``y`` (NaN encodes a missing task; a multiclass
task's target is its class id), a sample ``weight``, the bounded losses'
``lt_mask`` and ``gt_mask`` (per task: the target is an upper, or a lower,
bound) and optional extra inputs: molecule descriptors ``x_d``, extra atom
and bond features ``V_f`` and ``E_f`` (concatenated to the featurizer's
before message passing) and atom descriptors ``V_d`` (after it). NaNs in the
extra inputs become 0; targets keep them. A reaction's datapoint
(``ReactionDatapoint``) holds an atom-mapped reactant and product, and only
``x_d`` of the extra inputs."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.chem.mol import Mol


def _nan_to_zero(x: np.ndarray | None) -> np.ndarray | None:
    if x is not None:
        x = np.array(x, dtype=np.float64)
        x[np.isnan(x)] = 0
    return x


@dataclass
class MoleculeDatapoint:
    mol: Mol
    y: np.ndarray | None = None
    weight: float = 1.0
    gt_mask: np.ndarray | None = None
    lt_mask: np.ndarray | None = None
    name: str | None = None
    x_d: np.ndarray | None = None
    # the JAX package's field of phase features, which no model reads
    x_phase: list[float] | None = None
    V_f: np.ndarray | None = None
    E_f: np.ndarray | None = None
    V_d: np.ndarray | None = None

    def __post_init__(self):
        if self.mol is None:
            raise ValueError("mol is required")
        self._normalise()

    def _normalise(self) -> None:
        if self.y is not None:
            self.y = np.asarray(self.y, dtype=np.float64)
        for key in ("gt_mask", "lt_mask"):
            if getattr(self, key) is not None:
                setattr(self, key, np.asarray(getattr(self, key), dtype=bool))
        self.x_d, self.V_f, self.E_f, self.V_d = map(
            _nan_to_zero, (self.x_d, self.V_f, self.E_f, self.V_d))

    @classmethod
    def from_smi(
        cls,
        smi: str,
        *,
        keep_h: bool = False,
        add_h: bool = False,
        ignore_stereo: bool = False,
        reorder_atoms: bool = False,
        **kwargs,
    ) -> "MoleculeDatapoint":
        mol = make_mol(smi, keep_h, add_h, ignore_stereo, reorder_atoms)
        kwargs.setdefault("name", smi)
        return cls(mol=mol, **kwargs)


@dataclass
class LazyMoleculeDatapoint(MoleculeDatapoint):
    """A molecule parsed from ``smiles`` on first access of ``.mol`` and kept
    (cf. ``LazyMoleculeDatapoint`` of the JAX package), so that a large
    dataset holds strings until it is featurised."""

    mol: Mol | None = None
    smiles: str = ""
    keep_h: bool = False
    add_h: bool = False
    ignore_stereo: bool = False
    reorder_atoms: bool = False

    def __post_init__(self):
        if not self.smiles:
            raise ValueError("smiles is required")
        if self.name is None:
            self.name = self.smiles
        self._normalise()

    @classmethod
    def from_smi(cls, smi: str, **kwargs) -> "LazyMoleculeDatapoint":
        kwargs.pop("name", None)
        return cls(smiles=smi, **kwargs)


def _lazy_mol_get(self) -> Mol:
    m = self.__dict__.get("_mol")
    if m is None:
        m = make_mol(self.smiles, self.keep_h, self.add_h, self.ignore_stereo, self.reorder_atoms)
        self.__dict__["_mol"] = m
    return m


def _lazy_mol_set(self, value) -> None:
    # the dataclass __init__ assigns the field's default here; only a real
    # Mol is kept
    if value is not None and not isinstance(value, property):
        self.__dict__["_mol"] = value


# installed after the dataclass is made, so that the property is not read as
# the inherited field's default
LazyMoleculeDatapoint.mol = property(_lazy_mol_get, _lazy_mol_set)


@dataclass
class MolAtomBondDatapoint(MoleculeDatapoint):
    """A molecule with per-atom and per-bond targets beside its own (cf.
    ``MolAtomBondDatapoint`` of ``chemprop_tpu/data/datapoints.py``):
    ``atom_y`` ``[n_atoms, ta]`` and ``bond_y`` ``[n_bonds, tb]`` in the
    molecule's atom and bond order, their bounded losses' masks, bond
    descriptors ``E_d`` ``[n_bonds, d_ed]`` (NaN -> 0), and optional
    per-molecule sums ``atom_constraints`` / ``bond_constraints``, one per
    atom or bond target (NaN: that target is not constrained)."""

    E_d: np.ndarray | None = None
    atom_y: np.ndarray | None = None
    bond_y: np.ndarray | None = None
    atom_constraints: np.ndarray | None = None
    bond_constraints: np.ndarray | None = None
    atom_lt_mask: np.ndarray | None = None
    atom_gt_mask: np.ndarray | None = None
    bond_lt_mask: np.ndarray | None = None
    bond_gt_mask: np.ndarray | None = None

    def __post_init__(self):
        self.E_d = _nan_to_zero(self.E_d)
        if self.atom_y is not None:
            self.atom_y = np.asarray(self.atom_y, dtype=np.float64)
        if self.bond_y is not None:
            self.bond_y = np.asarray(self.bond_y, dtype=np.float64)
        super().__post_init__()


@dataclass
class ReactionDatapoint:
    """An atom-mapped reaction: its reactant ``rct`` and product ``pdt`` side
    (cf. ``ReactionDatapoint`` of ``chemprop_tpu/data/datapoints.py``)."""

    rct: Mol
    pdt: Mol
    y: np.ndarray | None = None
    weight: float = 1.0
    gt_mask: np.ndarray | None = None
    lt_mask: np.ndarray | None = None
    name: str | None = None
    x_d: np.ndarray | None = None
    x_phase: list[float] | None = None

    def __post_init__(self):
        if self.rct is None or self.pdt is None:
            raise ValueError("both reactant and product are required")
        self._normalise()

    def _normalise(self) -> None:
        if self.y is not None:
            self.y = np.asarray(self.y, dtype=np.float64)
        for key in ("gt_mask", "lt_mask"):
            if getattr(self, key) is not None:
                setattr(self, key, np.asarray(getattr(self, key), dtype=bool))
        self.x_d = _nan_to_zero(self.x_d)

    @classmethod
    def from_smi(
        cls,
        rxn_or_smis: str | tuple[str, str],
        *,
        keep_h: bool = False,
        add_h: bool = False,
        ignore_stereo: bool = False,
        reorder_atoms: bool = False,
        **kwargs,
    ) -> "ReactionDatapoint":
        """From a reaction SMILES ``R>A>P`` (the agents join the reactants) or
        ``R>>P``, or a pair of SMILES; the name is the reaction SMILES."""
        if isinstance(rxn_or_smis, str):
            rct_smi, pdt_smi = split_reaction(rxn_or_smis)
            name = rxn_or_smis
        elif isinstance(rxn_or_smis, tuple) and len(rxn_or_smis) == 2:
            rct_smi, pdt_smi = rxn_or_smis
            name = ">>".join(rxn_or_smis)
        else:
            raise TypeError("must provide either a reaction SMARTS string or 2 SMILES")
        rct, pdt = (make_mol(s, keep_h, add_h, ignore_stereo, reorder_atoms)
                    for s in (rct_smi, pdt_smi))
        kwargs.setdefault("name", name)
        return cls(rct, pdt, **kwargs)


def split_reaction(rxn: str) -> tuple[str, str]:
    """``(reactant, product)`` SMILES of ``R>A>P`` (agents joined to the
    reactants) or ``R>>P``."""
    parts = rxn.split(">")
    if len(parts) == 3:
        rct, agt, pdt = parts
        return (f"{rct}.{agt}" if agt else rct), pdt
    if len(parts) == 2:
        return parts[0], parts[1]
    raise ValueError(f"invalid reaction SMILES {rxn!r}")


@dataclass
class LazyReactionDatapoint(ReactionDatapoint):
    """A reaction whose two sides are parsed from ``rxn_smiles`` on first
    access and kept (cf. ``LazyReactionDatapoint`` of the JAX package)."""

    rct: Mol | None = None
    pdt: Mol | None = None
    rxn_smiles: str = ""
    keep_h: bool = False
    add_h: bool = False
    ignore_stereo: bool = False
    reorder_atoms: bool = False

    def __post_init__(self):
        if not self.rxn_smiles:
            raise ValueError("rxn_smiles is required")
        if self.name is None:
            self.name = self.rxn_smiles
        self._sides = None
        self._normalise()

    @classmethod
    def from_smi(cls, rxn_or_smis, **kwargs) -> "LazyReactionDatapoint":
        if isinstance(rxn_or_smis, tuple):
            rxn_or_smis = ">>".join(rxn_or_smis)
        kwargs.pop("name", None)
        return cls(rxn_smiles=rxn_or_smis, **kwargs)

    def _side(self, i: int) -> Mol:
        if self._sides is None:
            self._sides = tuple(
                make_mol(s, self.keep_h, self.add_h, self.ignore_stereo, self.reorder_atoms)
                for s in split_reaction(self.rxn_smiles))
        return self._sides[i]


LazyReactionDatapoint.rct = property(lambda self: self._side(0), lambda self, v: None)
LazyReactionDatapoint.pdt = property(lambda self: self._side(1), lambda self, v: None)
