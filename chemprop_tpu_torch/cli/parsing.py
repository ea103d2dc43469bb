"""CSV -> datapoints for the command line (cf. ``chemprop_tpu/cli/parsing.py``),
with the ``csv`` module where the JAX package reads through pandas: the same
columns, targets, bounds, weights and splits. Single-molecule data only:
reaction columns and more than one SMILES column raise (``ROADMAP.md`` §1
item 7), as do molecule featurizers (item 6)."""

from __future__ import annotations

import csv
import logging
from pathlib import Path

import numpy as np

from chemprop_tpu_torch.data.datapoints import MoleculeDatapoint
from chemprop_tpu_torch.data.datasets import MoleculeDataset
from chemprop_tpu_torch.featurizers.atom import get_multi_hot_atom_featurizer
from chemprop_tpu_torch.featurizers.bond import MultiHotBondFeaturizer, RIGRBondFeaturizer
from chemprop_tpu_torch.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer

logger = logging.getLogger(__name__)

# the cells pandas reads as missing targets in the JAX package
_MISSING = ("", "nan", "None", "NaN")

REFUSED_REACTIONS = ("reaction columns are not ported yet (ROADMAP.md section 1 item 7, "
                     "multicomponent and reaction inputs)")
REFUSED_COMPONENTS = ("more than one SMILES column is not ported yet (ROADMAP.md section 1 "
                      "item 7, multicomponent inputs)")
REFUSED_MOLECULE_FEATURIZERS = ("molecule featurizers are not ported yet (ROADMAP.md section 1 "
                                "item 6, featurizers/molecule.py)")


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
    if set(paths) - {0}:
        raise ValueError(REFUSED_COMPONENTS)
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
) -> list[list[MoleculeDatapoint]]:
    """One list of datapoints per input column: the port reads one SMILES
    column. ``V_fs``, ``E_fs`` and ``V_ds`` are per-row lists, or
    ``{0: per-row lists}``."""
    if rxns:
        raise ValueError(REFUSED_REACTIONS)
    if len(smis) != 1:
        raise ValueError(REFUSED_COMPONENTS)
    if molecule_featurizers:
        raise ValueError(REFUSED_MOLECULE_FEATURIZERS)

    def component0(v):
        if isinstance(v, dict):
            if set(v) - {0}:
                raise ValueError(REFUSED_COMPONENTS)
            return v.get(0)
        return v

    V_fs, E_fs, V_ds = component0(V_fs), component0(E_fs), component0(V_ds)
    (col_smis,) = smis.values()
    return [[
        MoleculeDatapoint.from_smi(
            smi, keep_h=keep_h, add_h=add_h, ignore_stereo=ignore_stereo, y=Y[i], weight=float(weights[i]),
            lt_mask=lt_mask[i] if lt_mask is not None else None,
            gt_mask=gt_mask[i] if gt_mask is not None else None,
            x_d=X_d[i] if X_d is not None else None,
            V_f=V_fs[i] if V_fs is not None else None,
            E_f=E_fs[i] if E_fs is not None else None,
            V_d=V_ds[i] if V_ds is not None else None,
        )
        for i, smi in enumerate(col_smis)
    ]]


def featurizer_for(mode: str = "v2", extra_atom_fdim: int = 0,
                   extra_bond_fdim: int = 0) -> SimpleMoleculeMolGraphFeaturizer:
    """The molecule featurizer of ``--multi-hot-atom-featurizer-mode``."""
    bond_featurizer = RIGRBondFeaturizer() if mode.lower() == "rigr" else MultiHotBondFeaturizer()
    return SimpleMoleculeMolGraphFeaturizer(
        atom_featurizer=get_multi_hot_atom_featurizer(mode), bond_featurizer=bond_featurizer,
        extra_atom_fdim=extra_atom_fdim, extra_bond_fdim=extra_bond_fdim,
    )


def make_dataset(data: list[MoleculeDatapoint], multi_hot_atom_featurizer_mode: str = "v2",
                 rxn_mode: str = "reac_diff") -> MoleculeDataset:
    """Datapoints -> a ``MoleculeDataset`` with the mode's featurizers, widened
    by the datapoints' extra atom and bond features. ``rxn_mode`` is accepted
    for the JAX signature's sake: reactions are not ported."""
    extra_atom_fdim = data[0].V_f.shape[1] if data and data[0].V_f is not None else 0
    extra_bond_fdim = data[0].E_f.shape[1] if data and data[0].E_f is not None else 0
    featurizer = featurizer_for(multi_hot_atom_featurizer_mode, extra_atom_fdim, extra_bond_fdim)
    return MoleculeDataset(data, featurizer)


def build_datasets(components: list[list], **kwargs) -> MoleculeDataset:
    """Lists of datapoints, one per component -> the dataset of the one
    component the port reads."""
    if len(components) != 1:
        raise ValueError(REFUSED_COMPONENTS)
    return make_dataset(components[0], **kwargs)
