"""``predict``: SMILES in a CSV -> predictions in a CSV (cf.
``chemprop_tpu/cli/predict.py``), averaged over an ensemble, with the JAX
CLI's uncertainty, calibration and evaluation.

    python -m chemprop_tpu_torch.cli predict -i in.csv -o out.csv \\
        --model-paths A.pt B.ckpt DIR ... [--device cpu] [--dtype float32|bfloat16] \\
        [--uncertainty-method ensemble|mve|dropout|...] \\
        [--calibration-method zscaling|isotonic|... --cal-path cal.csv] \\
        [--evaluation-methods nll-regression spearman ...]

``--model-paths`` takes reference v1 and v2 ``.pt`` / ``.ckpt`` files and
``CPTPU001`` files of the JAX package or of the port's ``train``, told apart
by their contents, and directories (``cli.common.find_models``: a training
output directory gives its ``best.ckpt``). The input is read with the
shared options of ``cli.common.add_common_args`` (``--smiles-columns``,
``--reaction-columns`` and ``--rxn-mode``, ``--no-header-row``, ``--add-h`` /
``--keep-h`` / ``--ignore-stereo``, ``--multi-hot-atom-featurizer-mode``,
``--molecule-featurizers``) and the extra inputs (``--descriptors-path``,
``--descriptors-columns``, ``--atom-features-path``,
``--bond-features-path``, ``--atom-descriptors-path``); a first model whose
``W_i`` takes another width than the chosen featurizer gives switches to the
featurizer mode that fits it (the 133-wide v1 atom features of a v1 file),
and a multicomponent model's blocks get the input's components in their
order (:func:`reorder_components`). A multicomponent row's name is the tuple
of its inputs, as the JAX CLI writes it.
``--uncertainty-method dropout`` runs ``Trainer.predict_mc_dropout`` with
every dropout rate set to ``--uncertainty-dropout-p``. ``--edge-partition
[N]`` predicts each molecule that a plan over N shards takes with its edge
table cut across them (``parallel.partitioned_mp.PartitionedInference``, one
plan shared by the ensemble and by the calibration set's own session) and
the others on the dense path; it refuses mol-atom-bond models and
``--uncertainty-method dropout``, as the JAX CLI does.

The output has the JAX CLI's columns: ``name`` (the SMILES), then for each
task, named by the checkpoint's output columns or ``pred_<j>``, its point
value (channel 0 of an MVE, evidential, quantile or Dirichlet head); a
multiclass head writes the task's class label and ``<task>_prob``, its class
probabilities as ``%.6f`` joined by commas; then each task's ``<task>_unc``
(a conformal set's memberships joined by commas). With
``--evaluation-methods`` the evaluations against the input's own targets
are printed as one JSON line. With no ``--device`` it runs on the GPU, and
raises where there is none. A mol-atom-bond model (``MolAtomBondMPNN``)
goes to ``cli.mab.predict_MAB``, which also reads ``--bond-descriptors-path``,
``--constraints-path`` and ``--constraints-to-targets``. ``--callback
myerson|mcts`` then explains every input molecule with each model
(:func:`run_callback`). What the port does
not have yet is refused (``REFUSED``), each with the ``ROADMAP.md`` item
that will port it; so is a ``.pkl`` output, which the JAX package writes
with pandas."""

from __future__ import annotations

import argparse
import csv
import json
import logging
from pathlib import Path

import numpy as np
import torch

from chemprop_tpu_torch.callbacks import MCTSRationaleCallback, MyersonExplainerCallback
from chemprop_tpu_torch.cli.common import DTYPES, add_common_args, check_devices, find_models
from chemprop_tpu_torch.cli.mab import predict_MAB
from chemprop_tpu_torch.cli.parsing import (
    build_datasets,
    featurizer_for,
    load_component_feats,
    load_input_feats,
    make_datapoints,
    parse_csv,
    read_columns,
    reaction_featurizer_for,
)
from chemprop_tpu_torch.cli.utils.command import Subcommand
from chemprop_tpu_torch.data import DataLoader
from chemprop_tpu_torch.data.datapoints import ReactionDatapoint
from chemprop_tpu_torch.featurizers.molecule import MoleculeFeaturizerRegistry
from chemprop_tpu_torch.featurizers.molgraph import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.interpret import check_explainable
from chemprop_tpu_torch.models.load import load_model
from chemprop_tpu_torch.models.model import MPNN
from chemprop_tpu_torch.models.mol_atom_bond import MolAtomBondMPNN
from chemprop_tpu_torch.nn.message_passing import MulticomponentMessagePassing
from chemprop_tpu_torch.nn.predictors import MulticlassClassificationFFN, MulticlassDirichletFFN
from chemprop_tpu_torch.nn.utils import Dropout
from chemprop_tpu_torch.train import Trainer
from chemprop_tpu_torch.uncertainty import (
    CalibratorRegistry,
    UncertaintyEstimatorRegistry,
    UncertaintyEvaluatorRegistry,
)
from chemprop_tpu_torch.utils.device import resolve_device
from chemprop_tpu_torch.utils.registry import Factory

logger = logging.getLogger(__name__)

UNCERTAINTY_METHODS = ["none", "ensemble", "mve", "evidential-total", "evidential-epistemic",
                       "evidential-aleatoric", "classification", "classification-dirichlet",
                       "multiclass-dirichlet", "quantile-regression", "dropout"]
CALIBRATION_METHODS = ["none", "zscaling", "zelikman-interval", "mve-weighting", "platt",
                       "isotonic", "conformal-regression", "conformal-multilabel",
                       "conformal-multiclass", "conformal-adaptive", "isotonic-multiclass"]


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    add_common_args(parser)
    g = parser.add_argument_group("Predict args")
    g.add_argument("-o", "--output", "--preds-path", type=Path, default=None,
                   help="output CSV (default <input>_preds.csv)")
    g.add_argument("--model-paths", "--model-path", nargs="+", type=Path, required=True,
                   help="reference v1/v2 .pt/.ckpt, CPTPU001 files, or directories")
    g.add_argument("--drop-extra-columns", action="store_true")
    g.add_argument("--edge-partition", type=int, nargs="?", const=0, default=None, metavar="N",
                   help="edge-partitioned inference over N shards (N local shards, or one "
                   "per rank under torchrun; 0/omitted: the world size)")
    g.add_argument("--constraints-path", type=Path, default=None,
                   help="per-molecule sums of a mol-atom-bond model's atom and bond targets")
    g.add_argument("--constraints-to-targets", nargs="+", default=None)
    g.add_argument("--uncertainty-method", choices=UNCERTAINTY_METHODS, default="none")
    g.add_argument("--uncertainty-dropout-p", type=float, default=0.1,
                   help="every dropout rate of Monte-Carlo dropout")
    g.add_argument("--dropout-sampling-size", type=int, default=10,
                   help="stochastic forward passes of Monte-Carlo dropout")
    g.add_argument("--calibration-interval-percentile", type=float, default=95,
                   help="percentile of the interval calibration methods, in (1, 100)")
    g.add_argument("--conformal-alpha", type=float, default=0.1,
                   help="target error rate of conformal prediction, in (0, 1)")
    g.add_argument("--cal-path", type=Path, help="calibration set CSV")
    g.add_argument("--cal-descriptors-path", type=Path,
                   help="extra descriptors (.npz) of the calibration set")
    g.add_argument("--cal-atom-features-path", nargs="+",
                   help="extra atom features (.npz) of the calibration set: PATH, or IDX PATH pairs")
    g.add_argument("--cal-atom-descriptors-path", nargs="+",
                   help="atom descriptors (.npz) of the calibration set: PATH, or IDX PATH pairs")
    g.add_argument("--cal-bond-features-path", nargs="+",
                   help="extra bond features (.npz) of the calibration set: PATH, or IDX PATH pairs")
    g.add_argument("--cal-bond-descriptors-path", nargs="+",
                   help="bond descriptors of the calibration set (a mol-atom-bond "
                   "predict is not calibrated, as in the JAX package)")
    g.add_argument("--cal-constraints-path", type=Path,
                   help="constraints of the calibration set (a mol-atom-bond predict is not "
                   "calibrated, as in the JAX package)")
    g.add_argument("--test-path", dest="data_path", type=Path,
                   help="alias for -i/--data-path")
    g.add_argument("--calibration-method", choices=CALIBRATION_METHODS, default="none")
    g.add_argument("--evaluation-methods", "--evaluation-method", nargs="+")
    g.add_argument("--callback", choices=["myerson", "mcts"],
                   help="interpretation run after the predictions: 'myerson' per-atom "
                   "attributions (<output stem>_myerson_explanation[_i].npz or .json), "
                   "'mcts' substructure rationales (<output stem>_mcts_rationales[_i].json); "
                   "regression and binary classification heads of single-molecule models")
    g.add_argument("--callback-params", type=json.loads, default={},
                   help='JSON keyword arguments of the callback\'s explainer, e.g. '
                   '\'{"sampling_threshold": 12, "save_as_json": true}\'')
    return parser


# what the port refuses, by the argument that asks for it; each message names
# the ROADMAP.md item that will port it. INPUT_REFUSED is shared with
# fingerprint
INPUT_REFUSED = ()
REFUSED = INPUT_REFUSED + (
    (lambda a: a.output is not None and a.output.suffix == ".pkl",
     "a .pkl output is not written: the JAX package writes it with pandas, which the port "
     "does not use; write a .csv"),
)


def refuse_unported(args, refused=REFUSED) -> None:
    """Raise for the first option that asks for what the port does not have."""
    for asks, message in refused:
        if asks(args):
            raise ValueError(message)
    check_devices(args)


def match_featurizer(args, model: MPNN) -> None:
    """Switch ``--multi-hot-atom-featurizer-mode`` to the first mode whose
    atom and bond widths make the width ``model``'s ``W_i`` takes (the v1
    mode for a v1 file), as the JAX CLI does. A multicomponent model of
    molecules needs a mode that fits every block's ``W_i`` (the v1 mode for
    a v1 file of several molecules), where the JAX CLI leaves its mode as
    given."""
    if args.reaction_columns:
        return  # a reaction's widths depend on its mode
    mp = model.message_passing
    blocks = mp.blocks if isinstance(mp, MulticomponentMessagePassing) else [mp]
    d_ins = sorted({b.W_i.in_features for b in blocks})
    d_in = ", ".join(map(str, d_ins))

    def fits(mode):
        atom, bond = featurizer_for(mode).shape
        return all(d in (atom + bond, atom) for d in d_ins)

    if fits(args.multi_hot_atom_featurizer_mode):
        return
    for mode in ("v2", "v1", "organic", "rigr"):
        if fits(mode):
            logger.warning(f"model expects {d_in}-dim W_i input; switching atom featurizer mode "
                           f"{args.multi_hot_atom_featurizer_mode!r} -> {mode!r}")
            args.multi_hot_atom_featurizer_mode = mode
            return
    logger.warning(f"model W_i input dim {d_in} matches no known featurizer mode "
                   "(extra atom/bond features?); proceeding unchanged")


def reorder_components(components: list[list], model: MPNN, args) -> list[list]:
    """The JAX CLI's component-order fix: where the blocks of a
    multicomponent ``model`` take other ``W_i`` widths than the input's
    components give in their order, but a permutation of the components
    gives them, the components are permuted to the model's order (the
    reference's ``rxn+mol`` model has its blocks as (molecule, reaction))."""
    mp = model.message_passing
    if (not isinstance(mp, MulticomponentMessagePassing) or len(mp.blocks) < 2
            or len(mp.blocks) != len(components)):
        return components

    def width(comp) -> int:
        if comp and isinstance(comp[0], ReactionDatapoint):
            f = reaction_featurizer_for(args.multi_hot_atom_featurizer_mode, args.rxn_mode)
        else:
            f = featurizer_for(args.multi_hot_atom_featurizer_mode)
        return sum(f.shape)

    want = [b.W_i.in_features for b in mp.blocks]
    have = [width(c) for c in components]
    if have == want:
        return components
    perm: list[int] = []
    for w in want:
        match = next((i for i, h in enumerate(have) if h == w and i not in perm), None)
        if match is None:
            return components  # no permutation fits; the model's error will say so
        perm.append(match)
    logger.warning(f"input component order (dims {have}) does not match the checkpoint's "
                   f"block order (dims {want}); reordering components {perm}")
    return [components[i] for i in perm]


def build_loader(args, path: Path, with_targets: bool = False, model: MPNN | None = None):
    """``(loader, dataset, targets)`` of a CSV and its extra inputs; the
    targets are the CSV's other columns with ``with_targets``, else none.
    The first SMILES column's molecules get the ``--molecule-featurizers``'
    vectors after their ``X_d``; with ``model`` the components are put in
    its blocks' order (:func:`reorder_components`)."""
    descriptors_cols = list(args.descriptors_columns or [])
    smis, rxns, Y, weights, lt, gt = parse_csv(
        path, args.smiles_columns, args.reaction_columns,
        target_cols=None if with_targets else [],
        ignore_cols=descriptors_cols if with_targets else None,
        no_header_row=args.no_header_row,
    )[:6]
    n = len(next(iter(smis.values()), next(iter(rxns.values()), [])))
    X_d = load_input_feats(args.descriptors_path, n)
    if descriptors_cols:
        col_X = read_columns(path, descriptors_cols, args.no_header_row)
        X_d = list(col_X) if X_d is None else [np.concatenate([a, b]) for a, b in zip(X_d, col_X)]
    components = make_datapoints(
        smis, rxns, Y if Y.size else np.full((n, 1), np.nan), weights, lt, gt,
        keep_h=args.keep_h, add_h=args.add_h, ignore_stereo=args.ignore_stereo,
        molecule_featurizers=[MoleculeFeaturizerRegistry[name]()
                              for name in (args.molecule_featurizers or [])],
        X_d=X_d,
        V_fs=load_component_feats(args.atom_features_path, n),
        E_fs=load_component_feats(args.bond_features_path, n),
        V_ds=load_component_feats(args.atom_descriptors_path, n),
    )
    if model is not None:
        components = reorder_components(components, model, args)
    dset = build_datasets(components, multi_hot_atom_featurizer_mode=
                          args.multi_hot_atom_featurizer_mode, rxn_mode=args.rxn_mode)
    return DataLoader(dset, batch_size=args.batch_size), dset, Y


def override_dropout(model: MPNN, p: float) -> MPNN:
    """``model`` with every dropout rate set to ``p`` (none changed for
    ``p = 0``), as the JAX CLI rebuilds its model: the masks of Monte-Carlo
    dropout are drawn only where a rate is above 0."""
    if p:
        for module in model.modules():
            if isinstance(module, Dropout):
                module.rate = float(p)
        model.predictor.dropout = float(p)
    return model


def trainer_for(model: MPNN, device: torch.device) -> Trainer:
    """A ``Trainer`` over ``model``'s own parameters, for prediction."""
    trainer = Trainer(model, device=device)
    trainer.init_state(keep_parameters=True)
    return trainer


def run_models(models: list[MPNN], loader, args, device) -> tuple[np.ndarray, np.ndarray | None]:
    """Each member's predictions over ``loader``, stacked ``[m, n, ...]``,
    and with ``dropout`` the members' mean Monte-Carlo variance. With
    ``--edge-partition`` one partitioned session serves every member."""
    if args.edge_partition is not None:
        from chemprop_tpu_torch.parallel.partitioned_mp import PartitionedInference

        dset = loader.dataset
        session = PartitionedInference(models[0], [dset[i] for i in range(len(dset))],
                                       n_shards=args.edge_partition or None, device=device)
        return np.stack([session.run(m) for m in models]), None
    preds, variances = [], []
    for model in models:
        trainer = trainer_for(model, device)
        if args.uncertainty_method == "dropout":
            mc = trainer.predict_mc_dropout(loader, sampling_size=args.dropout_sampling_size)
            preds.append(mc.mean(axis=0))
            variances.append((mc[..., 0] if mc.ndim == 4 else mc).var(axis=0))
        else:
            preds.append(trainer.predict(loader))
    return np.stack(preds), (np.stack(variances).mean(axis=0) if variances else None)


def point(preds: np.ndarray) -> np.ndarray:
    """Point predictions: channel 0 of a head with several outputs per task."""
    return preds[..., 0] if preds.ndim == 3 else preds


def estimate_uncertainty(method: str, stacked: np.ndarray, model: MPNN) -> np.ndarray | None:
    """``[m, n, t(, u)]`` outputs -> ``[n, t]`` (or ``[n, t, c]``) uncertainties."""
    if method == "none":
        return None
    if method == "classification" and isinstance(model.predictor, MulticlassDirichletFFN):
        stacked = stacked[..., :-1]  # the Dirichlet u channel
    return UncertaintyEstimatorRegistry[method]()(stacked)


def targets_and_mask(Y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return np.nan_to_num(Y).astype(np.float32), np.isfinite(Y)


def main(args: argparse.Namespace) -> int:
    refuse_unported(args)
    device = resolve_device(args.device)  # raises where there is no GPU
    dtype = DTYPES[args.dtype]
    model_paths = find_models(args.model_paths)
    models, output_columns = [], None
    for path in model_paths:
        model, cols = load_model(path, device, dtype)
        models.append(model)
        output_columns = cols or output_columns
    if args.callback is not None:  # before anything is written
        for model in models:
            check_explainable(model)
    if args.edge_partition is not None:
        if isinstance(models[0], MolAtomBondMPNN):
            raise ValueError("--edge-partition predict does not support MAB models")
        if args.uncertainty_method == "dropout":
            raise ValueError(
                "--edge-partition predict does not support --uncertainty-method dropout")
    if isinstance(models[0], MolAtomBondMPNN):  # the first model's columns, as in JAX
        return predict_MAB(args, models, load_model(model_paths[0], "cpu", dtype)[1], device)
    if args.uncertainty_method == "dropout":
        models = [override_dropout(m, args.uncertainty_dropout_p) for m in models]
    if not (args.atom_features_path or args.bond_features_path):
        match_featurizer(args, models[0])
    loader, dset, _ = build_loader(args, args.data_path, model=models[0])

    stacked, mc_uncs = run_models(models, loader, args, device)
    mean_preds = stacked.mean(0)
    uncs = (mc_uncs if args.uncertainty_method == "dropout"
            else estimate_uncertainty(args.uncertainty_method, stacked, models[-1]))
    if uncs is not None and args.calibration_method != "none" and args.cal_path:
        # the calibration set carries its own extra-input files
        cal_args = argparse.Namespace(**vars(args))
        cal_args.descriptors_path = args.cal_descriptors_path
        cal_args.atom_features_path = args.cal_atom_features_path
        cal_args.atom_descriptors_path = args.cal_atom_descriptors_path
        cal_args.bond_features_path = args.cal_bond_features_path
        cal_args.descriptors_columns = []
        cal_loader, _, cal_Y = build_loader(cal_args, args.cal_path, with_targets=True,
                                            model=models[0])
        cal_stack, cal_mc = run_models(models, cal_loader, args, device)
        cal_uncs = (cal_mc if args.uncertainty_method == "dropout"
                    else estimate_uncertainty(args.uncertainty_method, cal_stack, models[-1]))
        calibrator = Factory.build(CalibratorRegistry[args.calibration_method],
                                   p=args.calibration_interval_percentile / 100,
                                   alpha=args.conformal_alpha)
        calibrator.fit(point(cal_stack.mean(0)), cal_uncs, *targets_and_mask(cal_Y))
        uncs = calibrator.apply(uncs)

    if args.evaluation_methods and uncs is not None:
        # against the input CSV's own targets
        eval_Y = parse_csv(args.data_path, args.smiles_columns, args.reaction_columns, None,
                           list(args.descriptors_columns or []),
                           no_header_row=args.no_header_row)[2]
        evaluations = {}
        for name in args.evaluation_methods:
            vals = UncertaintyEvaluatorRegistry[name]().evaluate(
                point(mean_preds), uncs, *targets_and_mask(eval_Y))
            evaluations[name] = np.asarray(vals).tolist()
            logger.info(f"uncertainty evaluation {name}: {evaluations[name]}")
        print(json.dumps({"uncertainty_evaluations": evaluations}))

    header, rows = columns(models[-1], mean_preds, output_columns, uncs)
    out = args.output or args.data_path.with_name(args.data_path.stem + "_preds.csv")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", *header])
        for name, row in zip(dset.names, rows):
            w.writerow([name, *row])
    logger.info(f"wrote predictions for {len(rows)} rows to {out}")
    print(f"wrote {out}")
    if args.callback is not None:
        run_callback(args, models, dset, out, device)
    return 0


def run_callback(args, models: list[MPNN], dset, out: Path, device: torch.device) -> None:
    """``--callback`` over every input molecule, one file per model (``_i``
    after the stem for an ensemble's ``i``-th), as the JAX CLI writes them:
    ``myerson`` the attributions ``[n_atoms]`` (``[n_atoms, t]`` for several
    tasks) of each molecule to ``<stem>_myerson_explanation[_i].npz`` (or
    ``.json`` with ``save_as_json``); ``mcts`` each molecule's rationales to
    ``<stem>_mcts_rationales[_i].json``. MCTS takes the dataset's own
    featurizer, the one :func:`match_featurizer` settled on."""
    params = dict(args.callback_params)
    params.setdefault("device", device)
    suffixes = [""] if len(models) == 1 else [f"_{i}" for i in range(len(models))]
    if args.callback == "mcts":
        for model, suffix in zip(models, suffixes):
            rationales = MCTSRationaleCallback(**params).explain(model, dset)
            dst = out.parent / f"{out.stem}_mcts_rationales{suffix}.json"
            with open(dst, "w") as f:
                json.dump(rationales, f, indent=2)
            logger.info(f"MCTS rationales saved to {dst}")
        return
    save_as_json = params.pop("save_as_json", False)
    logger.warning("the 'myerson' callback is computationally expensive on large inputs")
    for model, suffix in zip(models, suffixes):
        explanations = [phi[:, 0] if phi.shape[-1] == 1 else phi
                        for phi in MyersonExplainerCallback(**params).explain(model, dset)]
        base = out.parent / f"{out.stem}_myerson_explanation{suffix}"
        if save_as_json:
            with open(base.with_suffix(".json"), "w") as f:
                json.dump([e.tolist() for e in explanations], f, indent=4)
        else:
            np.savez_compressed(base.with_suffix(".npz"), *explanations)
        logger.info(f"Myerson explanations saved to {base}")


def columns(
    model: MPNN, preds: np.ndarray, output_columns: list[str] | None,
    uncs: np.ndarray | None = None,
) -> tuple[list[str], list[list[str]]]:
    """The JAX CLI's columns for ``model``'s head: its header and each row's
    cells, with ``<task>_unc`` after them where there are uncertainties."""
    pred = model.predictor
    if isinstance(pred, MulticlassClassificationFFN):
        probs = preds[..., :-1] if isinstance(pred, MulticlassDirichletFFN) else preds
        labels = probs.argmax(axis=-1)
        cols = (output_columns or [f"pred_{j}" for j in range(labels.shape[1])])[: labels.shape[1]]
        header = [name for c in cols for name in (c, f"{c}_prob")]
        rows = [[cell for j in range(len(cols))
                 for cell in (str(int(lab[j])), ",".join(f"{p:.6f}" for p in prob[j]))]
                for lab, prob in zip(labels, probs)]
    else:
        values = point(preds)
        cols = (output_columns or [f"pred_{j}" for j in range(values.shape[1])])[: values.shape[1]]
        header = list(cols)
        rows = [[repr(float(x)) for x in row[: len(cols)]] for row in values]
    if uncs is not None:
        unc_cols = cols[: uncs.shape[1]]
        header += [f"{c}_unc" for c in unc_cols]
        for row, u in zip(rows, uncs):
            row += [",".join(f"{x:g}" for x in u[j]) if uncs.ndim == 3 else repr(float(u[j]))
                    for j in range(len(unc_cols))]
    return header, rows


def predict(
    model: MPNN, smiles: list[str], device: torch.device, batch_size: int = 64
) -> np.ndarray:
    """``[len(smiles), n_tasks(, k)]`` float32 predictions of a model that
    reads the default featurizer's graphs alone."""
    from chemprop_tpu_torch.chem import make_mol
    from chemprop_tpu_torch.data.collate import batch_mol_graphs

    featurizer = SimpleMoleculeMolGraphFeaturizer()
    check_plain_inputs(model, featurizer)
    preds = []
    for i in range(0, len(smiles), batch_size):
        mgs = [featurizer(make_mol(s)) for s in smiles[i : i + batch_size]]
        bmg = batch_mol_graphs(mgs).to(device)
        with torch.inference_mode():
            preds.append(model(bmg)[: len(mgs)].float().cpu().numpy())
    return np.concatenate(preds, 0)


def check_plain_inputs(model: MPNN, featurizer: SimpleMoleculeMolGraphFeaturizer) -> None:
    """Raise where ``model`` takes more than ``featurizer``'s graphs. ``serve``
    reads one SMILES per row and no extra inputs, as the JAX package's
    ``serve`` does: its ``ModelService`` applies a model to one graph and
    passes no descriptors or extra features (``chemprop_tpu/cli/serve.py``),
    so such a model fails there at its first request; the port refuses it
    where it loads. A mol-atom-bond model's three heads are ``predict``'s."""
    mp = model.message_passing
    if not hasattr(model, "predictor"):
        raise ValueError("the model is a mol-atom-bond model; serve returns one prediction per "
                         "molecule, as the JAX package's serve does: use predict")
    if isinstance(mp, MulticomponentMessagePassing):
        raise ValueError(f"the model takes {mp.n_components} components per row; serve takes "
                         "one SMILES per row, as the JAX package's serve does: use predict")
    if (mp.d_vd or model.predictor.input_dim != mp.output_dim
            or (mp.d_v, mp.d_e) != featurizer.shape):
        raise ValueError("the model takes extra inputs (descriptors or extra atom or bond "
                         "features), which serve does not read: the JAX package's serve "
                         "passes none either; use predict")


add_predict_args = add_args  # the JAX package's name


class PredictSubcommand(Subcommand):
    """``predict`` on the command line: :func:`add_args` and :func:`main`."""

    COMMAND = "predict"
    HELP = "predict with trained models"
    add_args = staticmethod(add_args)
    func = staticmethod(main)
