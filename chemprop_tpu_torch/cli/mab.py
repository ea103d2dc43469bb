"""The command line's mol-atom-bond paths (cf. ``chemprop_tpu/cli/mab.py``):
``train`` with ``--atom-target-columns`` / ``--bond-target-columns``, and
``predict`` and ``fingerprint`` of a ``MolAtomBondMPNN``. A cell of an atom
or bond target column is a list literal, one value per atom or bond of the
molecule (read with ``ast.literal_eval``; with a bounded loss each value may
carry a ``<`` or ``>`` bound); per-molecule sums constrain the atom and bond
predictions from ``--constraints-path``, a CSV whose columns are named
``<target>_constraint`` or are mapped to the targets in order by
``--constraints-to-targets``. The CSVs are read with ``csv``.

The predictions CSV has the JAX CLI's columns: ``smiles``, each molecule
target's value, then each atom and bond target's list (rounded to 6 places,
in the molecule's atom and bond order), then ``<col>_unc`` with an
uncertainty method. ``fingerprint`` writes one ``.npz`` per model holding an
array per kind, ``mol``, ``atom`` and ``bond``, as the JAX CLI does. As in
the JAX package, a mol-atom-bond ``predict`` is not calibrated, its
molecules are read with the default featurizer mode, and ``fingerprint``
reads the SMILES alone."""

from __future__ import annotations

import ast
import csv
import json
import logging
import math
from pathlib import Path

import numpy as np
import torch

from chemprop_tpu_torch.cli.common import DTYPES
from chemprop_tpu_torch.cli.parsing import (
    featurizer_for, load_component_feats, load_input_feats, read_table,
)
from chemprop_tpu_torch.data import DataLoader
from chemprop_tpu_torch.data.datapoints import MolAtomBondDatapoint
from chemprop_tpu_torch.data.datasets import MolAtomBondDataset
from chemprop_tpu_torch.models import serialize
from chemprop_tpu_torch.models.mol_atom_bond import KINDS, MolAtomBondMPNN
from chemprop_tpu_torch.nn.agg import AggregationRegistry
from chemprop_tpu_torch.nn.ffn import ConstrainerFFN
from chemprop_tpu_torch.nn.message_passing import MABAtomMessagePassing, MABBondMessagePassing
from chemprop_tpu_torch.nn.metrics import LossFunctionRegistry, MetricRegistry
from chemprop_tpu_torch.nn.predictors import PredictorRegistry, _FFNPredictorBase
from chemprop_tpu_torch.nn.transforms import GraphTransform, ScaleTransform, UnscaleTransform
from chemprop_tpu_torch.nn.utils import Dropout
from chemprop_tpu_torch.train.mab_trainer import MABTrainer, collect_mab_rows, restore_mab_order
from chemprop_tpu_torch.uncertainty import UncertaintyEstimatorRegistry
from chemprop_tpu_torch.utils.device import resolve_device
from chemprop_tpu_torch.utils.registry import Factory

logger = logging.getLogger(__name__)

_MISSING = ("", "nan", "None", "NaN")


def is_mab(args) -> bool:
    """Whether ``train``'s arguments ask for atom or bond targets."""
    return bool(args.atom_target_columns or args.bond_target_columns)


def _comp0_feats(arg, n: int):
    """Component 0's extra inputs: MAB inputs are one molecule each."""
    d = load_component_feats(arg, n)
    return d.get(0) if d else None


def _num(x) -> float:
    """A target list's element (or cell) -> float; missing is NaN, a bound
    marker is stripped."""
    if x is None:
        return float("nan")
    s = str(x).strip().lstrip("<>=")
    return float("nan") if s in _MISSING else float(s)


def _parse_list_cell(v: str) -> tuple[list[float], list[bool], list[bool]]:
    """A list cell's values and their ``<`` and ``>`` bounds; an empty cell
    is an empty list."""
    if v is None or v.strip() in _MISSING:
        return [], [], []
    out = ast.literal_eval(v)
    out = list(out) if isinstance(out, (list, tuple)) else [out]
    strs = ["" if x is None else str(x).strip() for x in out]
    return ([_num(x) for x in out], [s.startswith("<") for s in strs],
            [s.startswith(">") for s in strs])


def _per_target(cells: list[str], width: int, bounded: bool):
    """``(values [n, width], lt, gt)`` of one molecule's list cells, one
    column per target; the masks are None without a bounded loss."""
    parsed = [_parse_list_cell(c) for c in cells]
    table = [np.array(list(zip(*(p[k] for p in parsed))), dtype=float if k == 0 else bool)
             .reshape(-1, width) for k in range(3)]
    return table[0], (table[1] if bounded else None), (table[2] if bounded else None)


def _constraint_columns(path: Path, targets: list[str]) -> dict:
    """``{target: its column of the constraints CSV}``: the k-th column for
    the k-th of ``targets`` (``--constraints-to-targets``), else every
    ``<target>_constraint`` column by name."""
    header, rows = read_table(path)
    cols = {name: [r[j] if j < len(r) else "" for r in rows] for j, name in enumerate(header)}
    if targets:
        return {t: cols[header[k]] for k, t in enumerate(targets)}
    return {c[: -len("_constraint")]: v for c, v in cols.items() if c.endswith("_constraint")}


def _constraints(col_for: dict | None, names: list[str], i: int) -> np.ndarray | None:
    if col_for is None or not any(col_for.get(c) is not None for c in names):
        return None
    return np.array([np.nan if col_for.get(c) is None else _num(col_for[c][i]) for c in names])


def _extras(args, n: int) -> dict:
    return dict(
        x_d=load_input_feats(args.descriptors_path, n),
        V_f=_comp0_feats(args.atom_features_path, n), E_f=_comp0_feats(args.bond_features_path, n),
        V_d=_comp0_feats(args.atom_descriptors_path, n),
        E_d=_comp0_feats(args.bond_descriptors_path, n))


def build_MAB_datapoints(args) -> tuple[list[MolAtomBondDatapoint], list, list, list]:
    """The training CSV (and constraints CSV) -> ``(datapoints, mol_cols,
    atom_cols, bond_cols)``. An atom-mapped SMILES has its atoms reordered by
    their map numbers, as its targets are given in that order."""
    header, rows = read_table(args.data_path)
    smiles_col = header.index((args.smiles_columns or [header[0]])[0])
    mol_cols = list(args.target_columns or [])
    atom_cols = list(args.atom_target_columns or [])
    bond_cols = list(args.bond_target_columns or [])
    col_for = None
    if args.constraints_path is not None:
        col_for = _constraint_columns(args.constraints_path, args.constraints_to_targets)
    n = len(rows)
    extras = _extras(args, n)
    bounded = args.loss_function is not None and "bounded" in args.loss_function
    j = {c: header.index(c) for c in mol_cols + atom_cols + bond_cols}
    dps = []
    for i, row in enumerate(rows):
        smi = row[smiles_col]
        kw = {}
        if mol_cols:
            cells = [row[j[c]].strip() for c in mol_cols]
            kw["y"] = np.array([_num(c) for c in cells])
            if bounded:
                kw["lt_mask"] = np.array([c.startswith("<") for c in cells])
                kw["gt_mask"] = np.array([c.startswith(">") for c in cells])
            elif any(c.startswith(("<", ">")) for c in cells):
                raise ValueError(f"row {i}: a bounded target {cells} without a bounded loss")
        for kind, cols in (("atom", atom_cols), ("bond", bond_cols)):
            if cols:
                kw[f"{kind}_y"], kw[f"{kind}_lt_mask"], kw[f"{kind}_gt_mask"] = _per_target(
                    [row[j[c]] for c in cols], len(cols), bounded)
        reorder = args.reorder_atoms or (
            ":" in smi and any(ch.isdigit() for ch in smi.split(":")[-1][:3]))
        dps.append(MolAtomBondDatapoint.from_smi(
            smi, keep_h=args.keep_h, add_h=args.add_h, ignore_stereo=args.ignore_stereo,
            reorder_atoms=reorder, atom_constraints=_constraints(col_for, atom_cols, i),
            bond_constraints=_constraints(col_for, bond_cols, i),
            weight=float(row[header.index(args.weight_column)]) if args.weight_column else 1.0,
            **{k: None if v is None else v[i] for k, v in extras.items()}, **kw))
    return dps, mol_cols, atom_cols, bond_cols


def normalize_MAB_inputs(train_dset, val_dset, args):
    """Fit the extra inputs' scalers on train, apply them to train and
    validation: ``(X_d_transform, V_d_transform, E_d_transform,
    graph_transform)``, the transforms that scale them in the model at
    evaluation."""
    transforms = {}
    for key, width, off in (("X_d", "d_xd", args.no_descriptor_scaling),
                            ("V_d", "d_vd", args.no_atom_descriptor_scaling),
                            ("E_d", "d_ed", args.no_bond_descriptor_scaling),
                            ("V_f", "d_vf", args.no_atom_feature_scaling),
                            ("E_f", "d_ef", args.no_bond_feature_scaling)):
        if getattr(train_dset, width) <= 0 or off:
            continue
        scaler = train_dset.normalize_inputs(key)
        if scaler is None:
            continue
        if val_dset is not None:
            val_dset.normalize_inputs(key, scaler)
        pad = {"V_f": train_dset.featurizer.atom_fdim - train_dset.d_vf,
               "E_f": train_dset.featurizer.bond_fdim - train_dset.d_ef}.get(key, 0)
        transforms[key] = ScaleTransform.from_standard_scaler(scaler, pad=pad)
    graph_t = None
    if "V_f" in transforms or "E_f" in transforms:
        graph_t = GraphTransform(transforms.get("V_f"), transforms.get("E_f"))
    return transforms.get("X_d"), transforms.get("V_d"), transforms.get("E_d"), graph_t


def build_MAB_model(args, train_dset, output_transforms, input_transforms=(None,) * 4
                    ) -> MolAtomBondMPNN:
    """The model the arguments describe: MAB message passing (atom messages
    with ``--atom-messages``) in ``--dtype``, a head per kind of target, the
    molecule head's readout, and a constrainer per kind whose datapoints
    carry constraints. ``--atom-ffn-*`` / ``--bond-ffn-*`` and the
    constrainers' options override the shared ``--ffn-*`` ones; a head's
    criterion is ``--loss-function``'s, else its default."""
    mol_t, atom_t, bond_t = output_transforms
    X_d_t, V_d_t, E_d_t, graph_t = input_transforms
    data = train_dset.data
    n_mol, n_atom, n_bond = (len(getattr(args, f"{k}_columns") or []) for k in (
        "target", "atom_target", "bond_target"))
    d_vd = data[0].V_d.shape[1] if data and data[0].V_d is not None else None
    d_ed = data[0].E_d.shape[1] if data and data[0].E_d is not None else None
    d_v, d_e = train_dset.featurizer.shape
    mp_cls = MABAtomMessagePassing if args.atom_messages else MABBondMessagePassing
    mp = mp_cls(
        d_v=d_v, d_e=d_e, d_h=args.message_hidden_dim, bias=args.message_bias, depth=args.depth,
        dropout=args.dropout, activation=args.activation, undirected=args.undirected,
        compute_dtype=DTYPES[args.dtype], d_vd=d_vd, d_ed=d_ed, V_d_transform=V_d_t,
        E_d_transform=E_d_t, graph_transform=graph_t,
        return_vertex_embeddings=bool(n_mol or n_atom), return_edge_embeddings=bool(n_bond))
    vertex_dim = args.message_hidden_dim + (d_vd or 0)
    edge_dim = args.message_hidden_dim + (d_ed or 0)
    d_xd = data[0].x_d.shape[0] if data and data[0].x_d is not None else 0
    agg = (Factory.build(AggregationRegistry[args.aggregation], norm=args.aggregation_norm,
                         output_size=vertex_dim) if n_mol else None)

    def option(kind, name, default):
        v = getattr(args, f"{kind}_{name}", None)
        return default if v is None else v

    def head(kind, n_tasks, input_dim, transform):
        if not n_tasks:
            return None
        weights = option(kind, "task_weights", args.task_weights)
        n_classes = option(kind, "multiclass_num_classes", args.multiclass_num_classes)
        criterion = None
        if args.loss_function is not None:
            criterion = Factory.build(
                LossFunctionRegistry[args.loss_function], task_weights=weights or 1.0,
                v_kl=args.v_kl, eps=getattr(args, "eps", 1e-8), alpha=getattr(args, "alpha", 0.1),
                threshold=args.threshold, n_classes=n_classes)
        predictor = Factory.build(
            PredictorRegistry[args.task_type], criterion=criterion, input_dim=input_dim,
            n_tasks=n_tasks, hidden_dim=option(kind, "ffn_hidden_dim", args.ffn_hidden_dim),
            n_layers=option(kind, "ffn_num_layers", args.ffn_num_layers), dropout=args.dropout,
            activation=args.activation, task_weights=weights, threshold=args.threshold,
            n_classes=n_classes)
        if transform is not None:
            predictor.output_transform = transform
        return predictor

    def constrainer(kind, n_constraints, fp_dim):
        if not any(getattr(d, f"{kind}_constraints") is not None for d in data):
            return None
        return ConstrainerFFN(
            n_constraints=n_constraints, fp_dim=fp_dim,
            hidden_dim=option(kind, "constrainer_ffn_hidden_dim", args.ffn_hidden_dim),
            n_layers=option(kind, "constrainer_ffn_num_layers", 1))

    return MolAtomBondMPNN(
        mp, agg, mol_predictor=head("mol", n_mol, vertex_dim + d_xd, mol_t),
        atom_predictor=head("atom", n_atom, vertex_dim, atom_t),
        bond_predictor=head("bond", n_bond, 2 * edge_dim, bond_t),
        atom_constrainer=constrainer("atom", n_atom, vertex_dim),
        bond_constrainer=constrainer("bond", n_bond, 2 * edge_dim),
        batch_norm=args.batch_norm, X_d_transform=X_d_t)


def _tracking(args) -> tuple[str, str, dict]:
    """``(monitor, mode, val_metrics)`` of ``--tracking-metric``: the summed
    ``val_loss``, one head's ``val_loss-<kind>``, or a metric of one head
    (``rmse-atom``)."""
    tracking = getattr(args, "tracking_metric", None) or "val_loss"
    if tracking == "val_loss":
        return "val_loss", "min", {}
    base, _, kind = tracking.rpartition("-")
    if tracking.startswith("val_loss-") and kind in KINDS:
        return f"val_loss-{kind}", "min", {}
    if base and kind in KINDS:
        metric = Factory.build(MetricRegistry[base], n_classes=args.multiclass_num_classes,
                               assume_logits=False)
        return f"val_{tracking}", "max" if metric.higher_is_better else "min", {tracking: metric}
    raise ValueError(f"MAB tracking metric {tracking!r} must be 'val_loss' or suffixed with "
                     "-mol/-atom/-bond (e.g. 'rmse-atom')")


def main_MAB(args) -> int:
    """``train`` of a mol-atom-bond model: the JAX CLI's splits, per-kind
    target scaling, ensembles and replicates, and its artefacts
    (``splits.json``; per model ``best.ckpt``, ``checkpoints/``,
    ``history.json``, ``test_predictions.csv``; ``test_scores.json``)."""
    from chemprop_tpu_torch.cli.train import _draw_first_batch, build_splits

    device = resolve_device(args.device)  # raises where there is no GPU
    out_dir = args.output_dir or Path(f"chemprop_tpu_training/{args.data_path.stem}")
    out_dir.mkdir(parents=True, exist_ok=True)
    dps, mol_cols, atom_cols, bond_cols = build_MAB_datapoints(args)
    splits = build_splits(args, [dps])
    if splits is None:
        raise ValueError("--splits-column is not read for mol-atom-bond training; give "
                         "--splits-file or --split")
    trains, vals, tests = splits
    with open(out_dir / "splits.json", "w") as f:
        json.dump([{"train": list(map(int, t)), "val": list(map(int, v)),
                    "test": list(map(int, s))} for t, v, s in zip(trains, vals, tests)], f)

    all_scores = []
    for rep, (tr_i, va_i, te_i) in enumerate(zip(trains, vals, tests)):
        train_dset = MolAtomBondDataset([dps[i] for i in tr_i])
        val_dset = MolAtomBondDataset([dps[i] for i in va_i]) if len(va_i) else None
        test_dset = MolAtomBondDataset([dps[i] for i in te_i]) if len(te_i) else None
        input_transforms = normalize_MAB_inputs(train_dset, val_dset, args)
        transforms = [None, None, None]
        if args.task_type.startswith("regression"):
            for k, (kind, cols) in enumerate(zip(KINDS, (mol_cols, atom_cols, bond_cols))):
                if not cols:
                    continue
                scaler = train_dset.normalize_targets(kind)
                if scaler is not None:
                    if val_dset is not None:
                        val_dset.normalize_targets(kind, scaler)
                    transforms[k] = UnscaleTransform.from_standard_scaler(scaler)
        if not args.no_cache:
            for d in (train_dset, val_dset):
                if d is not None:
                    d.cache = True
        train_loader = DataLoader(train_dset, batch_size=args.batch_size, shuffle=True,
                                  seed=args.data_seed)
        val_loader = DataLoader(val_dset, batch_size=args.batch_size) if val_dset else None

        rep_dir = out_dir / (f"replicate_{rep}" if len(trains) > 1 else ".")
        for member in range(args.ensemble_size):
            model_dir = rep_dir / (f"model_{member}" if args.ensemble_size > 1 else ".")
            model_dir.mkdir(parents=True, exist_ok=True)
            model = build_MAB_model(args, train_dset, transforms, input_transforms)
            monitor, mode, val_metrics = _tracking(args)
            trainer = MABTrainer(
                model, monitor=monitor, mode=mode, val_metrics=val_metrics,
                min_delta=args.min_delta, max_epochs=args.epochs,
                warmup_epochs=args.warmup_epochs, init_lr=args.init_lr, max_lr=args.max_lr,
                final_lr=args.final_lr, grad_clip=args.grad_clip, patience=args.patience,
                checkpoint_dir=model_dir / "checkpoints", seed=args.seed + member, log_every=1,
                device=device)
            _draw_first_batch(train_loader)  # the JAX trainer's fit draws one
            trainer.fit(train_loader, val_loader)
            serialize.save_checkpoint(
                model_dir / "best.ckpt", model, serialize.to_jax_params(trainer.best_variables),
                {"output_columns": mol_cols + atom_cols + bond_cols})
            with open(model_dir / "history.json", "w") as f:
                json.dump(trainer.history, f, indent=2)
            if test_dset is not None and len(test_dset):
                preds = trainer.predict(DataLoader(test_dset, batch_size=args.batch_size))
                scores = _score_MAB(preds, test_dset, mol_cols, atom_cols, bond_cols)
                all_scores.append(scores)
                logger.info(f"replicate {rep} model {member} test scores: {scores}")
                write_MAB_preds(model_dir / "test_predictions.csv", test_dset, preds, mol_cols,
                                atom_cols, bond_cols)
    if all_scores:
        with open(out_dir / "test_scores.json", "w") as f:
            json.dump(all_scores, f, indent=2)
        print(json.dumps(all_scores[-1]))
    return 0


def _rmse(preds, targets) -> float:
    mask = np.isfinite(targets)
    if not mask.any():
        return float("nan")
    return float(np.sqrt(np.mean((preds[mask] - targets[mask]) ** 2)))


def _point(p: np.ndarray) -> np.ndarray:
    return p[..., 0] if p.ndim == 3 else p


def _score_MAB(preds, dset, mol_cols, atom_cols, bond_cols) -> dict:
    """The test set's RMSE per kind, on the point predictions."""
    scores = {}
    for kind, p, cols in zip(KINDS, preds, (mol_cols, atom_cols, bond_cols)):
        if p is None or not cols:
            continue
        if kind == "mol":
            Y = np.array([d.y for d in dset.data], dtype=float)
        else:
            Y = np.concatenate([getattr(d, f"{kind}_y") for d in dset.data], axis=0)
        scores[f"{kind}_rmse"] = _rmse(_point(p), Y)
    return scores


def _cell(v) -> str:
    """A molecule-level cell as pandas writes it: a float's repr, NaN empty,
    a row of several values as its list."""
    if np.ndim(v):
        return str(np.asarray(v).tolist())
    return "" if math.isnan(v) else repr(float(v))


def write_MAB_preds(path, dset, preds, mol_cols, atom_cols, bond_cols, uncs=None) -> None:
    """The predictions CSV: ``smiles``, the molecule columns' values, the
    atom and bond columns' lists (one per molecule, in its atom and bond
    order), and with ``uncs`` (a (mol, atom, bond) triple) each column's
    ``_unc``."""
    columns: dict[str, list[str]] = {"smiles": [d.name for d in dset.data]}
    counts = {"atom": [d.mol.num_atoms for d in dset.data],
              "bond": [d.mol.num_bonds for d in dset.data]}

    def put(kind, P, cols, suffix=""):
        P = np.asarray(P)
        cols = cols or [f"{kind}_{j}" for j in range(P.shape[1])]
        if kind == "mol":
            for j, c in enumerate(cols):
                columns[c + suffix] = [_cell(v) for v in P[:, j]]
            return
        offs = np.cumsum([0] + counts[kind])
        for j, c in enumerate(cols):
            columns[c + suffix] = [str([round(float(v), 6) for v in P[offs[i]: offs[i + 1], j]])
                                   for i in range(len(dset.data))]

    for kind, p, cols in zip(KINDS, preds, (mol_cols, atom_cols, bond_cols)):
        if p is not None:
            put(kind, _point(p), cols)
    for kind, u, cols in zip(KINDS, uncs or (None,) * 3, (mol_cols, atom_cols, bond_cols)):
        if u is not None:
            put(kind, u, cols, "_unc")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(columns))
        w.writerows(zip(*columns.values()))


def output_columns_of(model: MolAtomBondMPNN, cols) -> tuple:
    """The (mol, atom, bond) output column names: a reference checkpoint
    stores the triple, a ``CPTPU001`` file of ``train`` one flat list that
    the heads' task counts cut."""
    cols = cols or []
    if (isinstance(cols, (list, tuple)) and len(cols) == 3
            and all(c is None or isinstance(c, (list, tuple)) for c in cols)
            and any(isinstance(c, (list, tuple)) for c in cols)):
        return tuple(list(c) if c else None for c in cols)
    n_mol, n_atom = (0 if p is None else p.n_tasks for p in model.predictors[:2])
    return (list(cols[:n_mol]) or None, list(cols[n_mol: n_mol + n_atom]) or None,
            list(cols[n_mol + n_atom:]) or None)


def override_dropout(model: MolAtomBondMPNN, p: float) -> MolAtomBondMPNN:
    """``model`` with every dropout rate set to ``p`` (none changed for
    ``p = 0``), the heads' and the constrainers' included."""
    if p:
        for module in model.modules():
            if isinstance(module, Dropout):
                module.rate = float(p)
            elif isinstance(module, (_FFNPredictorBase, ConstrainerFFN)):
                module.dropout = float(p)
    return model


def predict_MAB(args, models: list[MolAtomBondMPNN], output_columns, device) -> int:
    """``predict`` of mol-atom-bond ``models`` (an ensemble's mean): the SMILES
    CSV with its extra inputs and constraints -> the predictions CSV, with
    the ensemble's, Monte-Carlo dropout's or a head's uncertainty."""
    header, rows = read_table(args.data_path)
    smiles_col = header.index((args.smiles_columns or [header[0]])[0])
    n = len(rows)
    mol_cols, atom_cols, bond_cols = output_columns_of(models[0], output_columns)
    col_for = None
    if args.constraints_path is not None:
        col_for = _constraint_columns(args.constraints_path, args.constraints_to_targets)
    extras = _extras(args, n)
    dps = [MolAtomBondDatapoint.from_smi(
        row[smiles_col], keep_h=args.keep_h, add_h=args.add_h, ignore_stereo=args.ignore_stereo,
        reorder_atoms=args.reorder_atoms,
        atom_constraints=_constraints(col_for, atom_cols or [], i),
        bond_constraints=_constraints(col_for, bond_cols or [], i),
        **{k: None if v is None else v[i] for k, v in extras.items()})
        for i, row in enumerate(rows)]
    V_f, E_f = extras["V_f"], extras["E_f"]
    if V_f is not None or E_f is not None:
        dset = MolAtomBondDataset(dps, featurizer_for(
            extra_atom_fdim=V_f[0].shape[-1] if V_f is not None else 0,
            extra_bond_fdim=E_f[0].shape[-1] if E_f is not None else 0))
    else:
        dset = MolAtomBondDataset(dps)
    loader = DataLoader(dset, batch_size=args.batch_size)

    dropout = args.uncertainty_method == "dropout"
    per_model, mc_uncs = [], []
    for model in models:
        trainer = MABTrainer(override_dropout(model, args.uncertainty_dropout_p) if dropout
                             else model, device=device)
        trainer.init_state(keep_parameters=True)
        if dropout:
            mc = trainer.predict_mc_dropout(loader, sampling_size=args.dropout_sampling_size)
            per_model.append(tuple(None if s is None else s.mean(0) for s in mc))
            mc_uncs.append(tuple(None if s is None else (s[..., 0] if s.ndim == 4 else s).var(0)
                                 for s in mc))
        else:
            per_model.append(trainer.predict(loader))
    stacks = tuple(None if per_model[0][k] is None else np.stack([m[k] for m in per_model])
                   for k in range(3))
    preds = tuple(None if s is None else s.mean(0) for s in stacks)
    uncs = None
    if dropout:
        uncs = tuple(None if mc_uncs[0][k] is None else np.stack([u[k] for u in mc_uncs]).mean(0)
                     for k in range(3))
    elif args.uncertainty_method != "none":
        estimator = UncertaintyEstimatorRegistry[args.uncertainty_method]()
        uncs = tuple(None if s is None else estimator(s) for s in stacks)
    out = args.output or args.data_path.with_name(args.data_path.stem + "_preds.csv")
    out.parent.mkdir(parents=True, exist_ok=True)
    write_MAB_preds(out, dset, preds, mol_cols, atom_cols, bond_cols, uncs=uncs)
    print(f"wrote {out}")
    return 0


def fingerprint_MAB(args, models: list[MolAtomBondMPNN], device) -> int:
    """``fingerprint`` of mol-atom-bond ``models``: for each, one ``.npz`` of
    the fingerprints by kind (``mol``: the readout with ``X_d``, ``atom``:
    one row per atom, ``bond``: each bond's ``[H_e ; H_e[rev]]`` on its
    primary edge), of the SMILES alone."""
    header, rows = read_table(args.data_path)
    smiles_col = header.index((args.smiles_columns or [header[0]])[0])
    dset = MolAtomBondDataset([MolAtomBondDatapoint.from_smi(
        row[smiles_col], keep_h=args.keep_h, add_h=args.add_h, ignore_stereo=args.ignore_stereo)
        for row in rows])
    loader = DataLoader(dset, batch_size=args.batch_size)
    for k, model in enumerate(models):
        chunks = ([], [], [])
        with torch.inference_mode():
            for host in loader:
                b = host.to(device)
                fps = model.fingerprint(b.bmg, b.V_d, b.E_d, b.X_d, is_training=False)
                collect_mab_rows(host, *(None if x is None else x.float().cpu().numpy()
                                         for x in fps), *chunks)
        # rows in dataset order where the loader set oversized molecules apart
        tables = restore_mab_order(loader, *(np.concatenate(c, 0) if c else None for c in chunks))
        arrays = {kind: t for kind, t in zip(KINDS, tables) if t is not None}
        base = args.output or args.data_path.with_name(args.data_path.stem + "_fingerprint.npz")
        if len(models) > 1:
            base = base.with_name(f"{base.stem}_model_{k}{base.suffix}")
        base.parent.mkdir(parents=True, exist_ok=True)
        np.savez(base.with_suffix(".npz"), **arrays)
        print(f"wrote {base.with_suffix('.npz')} "
              + str({kind: a.shape for kind, a in arrays.items()}))
    return 0
