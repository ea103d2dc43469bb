"""CSV -> datapoints for the command line (cf. ``chemprop_tpu/cli/parsing.py``),
with the ``csv`` module where the JAX package reads through pandas: the same
columns, targets, bounds, weights and splits; several SMILES columns and
reaction columns give one component each, and the molecule featurizers'
vectors join the first SMILES column's ``X_d``."""

from __future__ import annotations

import csv
import logging
from pathlib import Path

import numpy as np

from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.data.datapoints import MoleculeDatapoint, ReactionDatapoint
from chemprop_tpu_torch.data.datasets import (
    MoleculeDataset, MulticomponentDataset, ReactionDataset,
)
from chemprop_tpu_torch.featurizers.atom import get_multi_hot_atom_featurizer
from chemprop_tpu_torch.featurizers.bond import MultiHotBondFeaturizer, RIGRBondFeaturizer
from chemprop_tpu_torch.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.featurizers.molgraph.reaction import CondensedGraphOfReactionFeaturizer

logger = logging.getLogger(__name__)

# the cells pandas reads as missing targets in the JAX package
_MISSING = ("", "nan", "None", "NaN")

def read_table(path: str | Path, no_header_row: bool = False) -> tuple[list[str], list[list[str]]]:
    """``(column names, rows of cells)`` of a CSV; without a header row the
    columns are named ``"0"``, ``"1"``, ... as pandas names them."""
    with open(path, newline="") as f:
        rows = [row for row in csv.reader(f) if row]
    if no_header_row:
        width = max((len(r) for r in rows), default=0)
        return [str(i) for i in range(width)], rows
    return rows[0], rows[1:]


def _column(header: list[str], rows: list[list[str]], name: str) -> list[str]:
    try:
        j = header.index(name)
    except ValueError:
        raise KeyError(f"column {name!r} is not in the CSV's columns {header}") from None
    return [row[j] if j < len(row) else "" for row in rows]


def parse_csv(
    path: str | Path,
    smiles_cols: list[str] | None,
    rxn_cols: list[str] | None,
    target_cols: list[str] | None,
    ignore_cols: list[str] | None = None,
    weight_col: str | None = None,
    bounded: bool = False,
    splits_col: str | None = None,
    no_header_row: bool = False,
):
    """``(smis per column, rxns per column, Y, weights, lt_mask, gt_mask,
    splits, input_cols, target_cols)``, the JAX package's tuple: an empty or
    ``nan`` target cell is NaN; with ``bounded`` a ``<x`` (``>x``) target is x
    with its ``lt_mask`` (``gt_mask``) set, and both masks are None without
    it; the weights are ones without a weight column; the splits column is
    read lower-cased."""
    header, rows = read_table(path, no_header_row)
    if no_header_row:
        smiles_cols = smiles_cols or [header[0]]
    if smiles_cols is None and rxn_cols is None:
        smiles_cols = [header[0]]
    smiles_cols = smiles_cols or []
    rxn_cols = rxn_cols or []

    input_cols = list(smiles_cols) + list(rxn_cols)
    reserved = set(input_cols) | set(ignore_cols or []) | {weight_col, splits_col} - {None}
    if target_cols is None:
        target_cols = [c for c in header if c not in reserved]

    smis = {c: _column(header, rows, c) for c in smiles_cols}
    rxns = {c: _column(header, rows, c) for c in rxn_cols}

    raw = [_column(header, rows, c) for c in target_cols]
    shape = (len(rows), len(target_cols))
    Y = np.empty(shape, dtype=np.float64)
    lt = np.zeros(shape, dtype=bool)
    gt = np.zeros(shape, dtype=bool)
    for j, col in enumerate(raw):
        for i, cell in enumerate(col):
            v = cell.strip()
            if v in _MISSING:
                Y[i, j] = np.nan
                continue
            if bounded and v[0] in "<>":
                (lt if v[0] == "<" else gt)[i, j] = True
                v = v.lstrip("<>=")
            Y[i, j] = float(v)

    weights = (np.array([float(x) for x in _column(header, rows, weight_col)])
               if weight_col else np.ones(len(rows)))
    splits = [x.lower() for x in _column(header, rows, splits_col)] if splits_col else None
    return (smis, rxns, Y, weights, lt if bounded else None, gt if bounded else None, splits,
            input_cols, list(target_cols))


def read_columns(path: str | Path, cols: list[str], no_header_row: bool = False) -> np.ndarray:
    """``[n, len(cols)]`` float64 values of the CSV's columns ``cols`` (the
    ``--descriptors-columns``)."""
    header, rows = read_table(path, no_header_row)
    return np.array([[float(x) for x in _column(header, rows, c)] for c in cols],
                    dtype=np.float64).T.reshape(len(rows), len(cols))


def parse_indexed_paths(value) -> dict[int, Path] | None:
    """``--atom-features-path [IDX PATH ...]`` or a bare ``PATH`` (component
    0) -> ``{component_index: path}``."""
    if value is None:
        return None
    if isinstance(value, (str, Path)):
        return {0: Path(value)}
    items = [str(v) for v in value]
    if len(items) == 1:
        return {0: Path(items[0])}
    if len(items) % 2 != 0:
        raise ValueError(f"expected a single path or (index, path) pairs, got {items}")
    try:
        inds = [int(x) for x in items[::2]]
    except ValueError:
        raise ValueError(f"expected a single path or (index, path) pairs, got {items}") from None
    if len(set(inds)) != len(inds):
        raise ValueError(f"duplicate component index in {items}")
    return {i: Path(pth) for i, pth in zip(inds, items[1::2])}


def load_component_feats(value, n: int) -> dict[int, list] | None:
    """Per-component extra features: ``{component_index: per-row arrays}``."""
    paths = parse_indexed_paths(value)
    if paths is None:
        return None
    return {k: load_input_feats(pth, n) for k, pth in paths.items()}


def load_input_feats(path: str | Path | None, n: int):
    """Per-datapoint extra features from an ``.npz`` (one 2-d array of ``n``
    rows, or ``n`` arrays) or an ``.npy`` of ``n`` rows, as float64."""
    if path is None:
        return None
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as f:
            arrays = [f[k] for k in f.files]
        if len(arrays) == 1 and arrays[0].ndim == 2 and len(arrays[0]) == n:
            return [np.asarray(a, dtype=np.float64) for a in arrays[0]]
        if len(arrays) != n:
            raise ValueError(f"{path} holds {len(arrays)} arrays for {n} datapoints")
        return [np.asarray(a, dtype=np.float64) for a in arrays]
    X = np.load(path)
    if len(X) != n:
        raise ValueError(f"{path} holds {len(X)} rows for {n} datapoints")
    return [np.asarray(x, dtype=np.float64) for x in X]


def make_datapoints(
    smis: dict[str, list[str]],
    rxns: dict[str, list[str]],
    Y: np.ndarray,
    weights: np.ndarray,
    lt_mask: np.ndarray | None,
    gt_mask: np.ndarray | None,
    keep_h: bool = False,
    add_h: bool = False,
    ignore_stereo: bool = False,
    molecule_featurizers: list | None = None,
    X_d: list | None = None,
    V_fs: list | dict | None = None,
    E_fs: list | dict | None = None,
    V_ds: list | dict | None = None,
) -> list[list]:
    """One list of datapoints per input column, the SMILES columns first and
    then the reaction columns, as the JAX package orders them. The first
    SMILES column's datapoints carry ``X_d`` with each molecule featurizer's
    vector concatenated after it; a reaction's carries none. ``V_fs``,
    ``E_fs`` and ``V_ds`` are per-row lists (component 0) or
    ``{component_index: per-row lists}``; a reaction component takes none."""

    def by_comp(v):
        if v is None or isinstance(v, dict):
            return v or {}
        return {0: v}

    V_fs, E_fs, V_ds = by_comp(V_fs), by_comp(E_fs), by_comp(V_ds)
    bounds = dict(lt_mask=lt_mask, gt_mask=gt_mask)
    flags = dict(keep_h=keep_h, add_h=add_h, ignore_stereo=ignore_stereo)

    def common(i):
        return dict(y=Y[i], weight=float(weights[i]),
                    **{k: None if m is None else m[i] for k, m in bounds.items()})

    components: list[list] = []
    for c, col_smis in enumerate(smis.values()):
        dps = []
        for i, smi in enumerate(col_smis):
            x_d = None
            if c == 0:
                x_d = X_d[i] if X_d is not None else None
                if molecule_featurizers:
                    mol = make_mol(smi, keep_h, add_h, ignore_stereo)
                    fp = np.concatenate([mf(mol) for mf in molecule_featurizers])
                    x_d = fp if x_d is None else np.concatenate([x_d, fp])
            dps.append(MoleculeDatapoint.from_smi(
                smi, **flags, **common(i), x_d=x_d,
                V_f=V_fs[c][i] if c in V_fs else None,
                E_f=E_fs[c][i] if c in E_fs else None,
                V_d=V_ds[c][i] if c in V_ds else None,
            ))
        components.append(dps)
    for c, col_rxns in enumerate(rxns.values(), start=len(smis)):
        if c in V_fs or c in E_fs or c in V_ds:
            raise NotImplementedError(
                f"extra atom/bond features for REACTION component {c} are not supported "
                "(molecule components only)")
        components.append([ReactionDatapoint.from_smi(rxn, **flags, **common(i))
                           for i, rxn in enumerate(col_rxns)])
    return components


def featurizer_for(mode: str = "v2", extra_atom_fdim: int = 0,
                   extra_bond_fdim: int = 0) -> SimpleMoleculeMolGraphFeaturizer:
    """The molecule featurizer of ``--multi-hot-atom-featurizer-mode``."""
    bond_featurizer = RIGRBondFeaturizer() if mode.lower() == "rigr" else MultiHotBondFeaturizer()
    return SimpleMoleculeMolGraphFeaturizer(
        atom_featurizer=get_multi_hot_atom_featurizer(mode), bond_featurizer=bond_featurizer,
        extra_atom_fdim=extra_atom_fdim, extra_bond_fdim=extra_bond_fdim,
    )


def reaction_featurizer_for(mode: str = "v2", rxn_mode: str = "reac_diff"
                            ) -> CondensedGraphOfReactionFeaturizer:
    """The condensed graph of reaction over the featurizer mode's atom and
    bond featurizers, in ``--rxn-mode``."""
    f = featurizer_for(mode)
    return CondensedGraphOfReactionFeaturizer(atom_featurizer=f.atom_featurizer,
                                              bond_featurizer=f.bond_featurizer, mode_=rxn_mode)


def make_dataset(data: list, multi_hot_atom_featurizer_mode: str = "v2",
                 rxn_mode: str = "reac_diff") -> MoleculeDataset:
    """Datapoints -> a ``ReactionDataset`` of reactions in ``rxn_mode``, or a
    ``MoleculeDataset`` with the mode's featurizers, widened by the
    datapoints' extra atom and bond features."""
    if data and isinstance(data[0], ReactionDatapoint):
        return ReactionDataset(data, reaction_featurizer_for(multi_hot_atom_featurizer_mode,
                                                             rxn_mode))
    extra_atom_fdim = data[0].V_f.shape[1] if data and data[0].V_f is not None else 0
    extra_bond_fdim = data[0].E_f.shape[1] if data and data[0].E_f is not None else 0
    featurizer = featurizer_for(multi_hot_atom_featurizer_mode, extra_atom_fdim, extra_bond_fdim)
    return MoleculeDataset(data, featurizer)


def build_datasets(components: list[list], **kwargs):
    """Lists of datapoints, one per component -> a dataset, multicomponent
    where there is more than one."""
    if len(components) == 1:
        return make_dataset(components[0], **kwargs)
    return MulticomponentDataset([make_dataset(c, **kwargs) for c in components])
