"""The JAX package's parsing entry points under their names (cf.
``chemprop_tpu/cli/utils/parsing.py``), over the port's own parsing
(:mod:`chemprop_tpu_torch.cli.parsing`, :mod:`chemprop_tpu_torch.cli.mab`):
the same columns, targets, weights and extra inputs from the same files,
read with the ``csv`` module where the JAX package reads through pandas."""

from __future__ import annotations

import argparse
from pathlib import Path

from chemprop_tpu_torch.cli.parsing import (  # noqa: F401 (re-exports)
    build_datasets,
    load_input_feats,
    make_datapoints,
    make_dataset,
    parse_csv,
    read_table,
)

__all__ = [
    "build_data_from_files",
    "build_MAB_data_from_files",
    "get_column_names",
    "make_datapoints",
    "make_dataset",
    "parse_activation",
    "parse_indices",
]


def get_column_names(
    path,
    smiles_cols=None,
    rxn_cols=None,
    target_cols=None,
    ignore_cols=None,
    splits_col=None,
    weight_col=None,
    no_header_row: bool = False,
) -> tuple[list[str], list[str]]:
    """``(input columns, target columns)`` of a CSV's header: the inputs
    default to the first column, the targets to every column no other role
    takes; without a header row, ``["SMILES"]`` and ``pred_<i>`` for each
    column after the first."""
    header = read_table(path)[0]
    if no_header_row:
        return ["SMILES"], [f"pred_{i}" for i in range(len(header) - 1)]
    input_cols = list(smiles_cols or []) + list(rxn_cols or [])
    if not input_cols:
        input_cols = [header[0]]
    if target_cols is None:
        reserved = set(input_cols) | set(ignore_cols or []) | {splits_col, weight_col}
        target_cols = [c for c in header if c not in reserved]
    return input_cols, list(target_cols)


def _first_path(p):
    """A path, or component 0's of a ``{component_index: path}`` dict."""
    return p.get(0) if isinstance(p, dict) else p


def build_data_from_files(
    p_data,
    no_header_row: bool = False,
    smiles_cols=None,
    rxn_cols=None,
    target_cols=None,
    ignore_cols=None,
    splits_col=None,
    weight_col=None,
    bounded: bool = False,
    p_descriptors=None,
    p_atom_feats=None,
    p_bond_feats=None,
    p_atom_descs=None,
    **featurization_kwargs,
) -> list[list]:
    """A CSV and its optional ``.npz`` / ``.npy`` side files -> one list of
    datapoints per input column (``cli.parsing.make_datapoints``).
    ``p_atom_feats``, ``p_bond_feats`` and ``p_atom_descs`` take a path
    (component 0's) or a ``{component_index: path}`` dict, of which
    component 0's is read, as in the JAX package."""
    smis, rxns, Y, weights, lt, gt = parse_csv(
        p_data, list(smiles_cols) if smiles_cols else None,
        list(rxn_cols) if rxn_cols else None, list(target_cols) if target_cols else None,
        ignore_cols, weight_col, bounded, splits_col, no_header_row)[:6]
    n = len(Y)
    return make_datapoints(
        smis, rxns, Y, weights, lt, gt,
        X_d=load_input_feats(_first_path(p_descriptors), n),
        V_fs=load_input_feats(_first_path(p_atom_feats), n),
        E_fs=load_input_feats(_first_path(p_bond_feats), n),
        V_ds=load_input_feats(_first_path(p_atom_descs), n),
        **featurization_kwargs,
    )


def build_MAB_data_from_files(
    p_data,
    smiles_cols=None,
    target_cols=None,
    atom_target_cols=None,
    bond_target_cols=None,
    weight_col=None,
    p_constraints=None,
    constraints_cols_to_target_cols=None,
    p_descriptors=None,
    p_atom_feats=None,
    p_bond_feats=None,
    p_atom_descs=None,
    p_bond_descs=None,
    keep_h: bool = False,
    add_h: bool = False,
    ignore_stereo: bool = False,
    reorder_atoms: bool = False,
    bounded: bool = False,
    **_ignored,
) -> list:
    """A CSV of molecule targets and list-literal atom and bond targets (and
    a constraints CSV) -> ``MolAtomBondDatapoint``s
    (``cli.mab.build_MAB_datapoints``); with ``bounded`` a ``<x`` / ``>x``
    target sets its bound's mask. The JAX package's function leaves the
    loss out of the arguments it builds, so its parser raises
    ``AttributeError`` on every call (``ROADMAP.md`` section 3, faults in the
    reference itself); the port reads the targets as a loss that is not
    bounded would, unless ``bounded``."""
    from chemprop_tpu_torch.cli.mab import build_MAB_datapoints

    args = argparse.Namespace(
        data_path=Path(p_data),
        smiles_columns=list(smiles_cols) if smiles_cols else None,
        target_columns=list(target_cols) if target_cols else None,
        atom_target_columns=list(atom_target_cols) if atom_target_cols else None,
        bond_target_columns=list(bond_target_cols) if bond_target_cols else None,
        weight_column=weight_col,
        constraints_path=p_constraints,
        constraints_to_targets=constraints_cols_to_target_cols,
        descriptors_path=_first_path(p_descriptors),
        atom_features_path=_first_path(p_atom_feats),
        bond_features_path=_first_path(p_bond_feats),
        atom_descriptors_path=_first_path(p_atom_descs),
        bond_descriptors_path=_first_path(p_bond_descs),
        keep_h=keep_h,
        add_h=add_h,
        ignore_stereo=ignore_stereo,
        reorder_atoms=reorder_atoms,
        loss_function="bounded-mse" if bounded else None,
    )
    return build_MAB_datapoints(args)[0]


def parse_indices(idxs) -> list[int]:
    """``"0,1,2-4"`` -> ``[0, 1, 2, 3, 4]``; anything but a string as it is."""
    if not isinstance(idxs, str):
        return idxs
    out: list[int] = []
    for part in idxs.split(","):
        if "-" in part:
            lo, hi = map(int, part.split("-"))
            out.extend(range(lo, hi + 1))
        else:
            out.append(int(part))
    return out


def parse_activation(cls, arguments=None):
    """``cls`` made from a list of positional literals and keyword dicts, as
    :func:`~chemprop_tpu_torch.cli.utils.args.activation_function_argument`
    gives them."""
    posargs, kwargs = [], {}
    for item in arguments or ():
        if isinstance(item, dict):
            kwargs.update(item)
        else:
            posargs.append(item)
    return cls(*posargs, **kwargs)
