"""``train``: CSV -> splits -> trained models and their artefacts (cf.
``chemprop_tpu/cli/train.py``), for molecules, reactions and several
components, with every task head of the port, on the GPU unless
``--device`` says otherwise.

    python -m chemprop_tpu_torch.cli train -i data.csv -o out [--device cpu]
        [--dtype float32|bfloat16] [--split scaffold_balanced] [--epochs N] ...

The flags are the JAX package's, under its names, plus ``--device`` and
``--dtype`` (float32 by default, as the JAX model's ``compute_dtype``). One
to three ``-i`` files: one is split into train, validation and test; with
two, the second is the test set; three are fixed train, validation and test
sets. The splits come from ``--split`` (``data.splitting``), a
``--splits-column`` or a ``--splits-file``, for each of
``--num-replicates``; each replicate trains ``--ensemble-size`` models. The
output directory gets ``config.json`` (the parsed arguments), ``splits.json``
and, for each model (``replicate_<r>/model_<m>`` where there are several),
``best.ckpt`` (``CPTPU001``, which the JAX package's ``load_model`` reads),
``checkpoints/`` (``best.ckpt`` and ``last.ckpt`` after every epoch, unless
``--remove-checkpoints``), ``history.json``, and with a test set
``test_predictions.csv``; the run writes ``test_scores.json`` and prints the
last model's scores. ``--checkpoint`` warm-starts the parameters and
batch-norm statistics from a ``CPTPU001`` file, ``--resume`` continues from a
``last.ckpt``; ``--freeze-encoder`` and ``--frzn-ffn-layers`` freeze by the
JAX package's paths. ``--tensorboard`` and ``--profile`` write TensorBoard
events and a ``torch.profiler`` trace under each model's directory.
``--atom-messages`` builds atom message passing, ``--aggregation attentive``
the attentive readout over one component's output width. Several
``--smiles-columns`` and ``--reaction-columns`` (condensed graphs of
reaction in ``--rxn-mode``) give a ``MulticomponentMPNN``, one block per
component or one for all with ``--mpn-shared``; a single reaction column
gives an ``MPNN`` over its graphs. ``--molecule-featurizers`` append their
vectors to the first SMILES column's ``X_d``; the extra atom and bond inputs
take ``IDX PATH`` pairs, one per molecule component.

Atom and bond targets (``--atom-target-columns``, ``--bond-target-columns``)
train a mol-atom-bond model (``cli.mab.main_MAB``). ``--split kmeans``
clusters Morgan bits without scikit-learn (``data.kmeans``), and
``--use-cuikmolmaker-featurization`` fills the datasets' caches through the
native C++ featurizer (``featurizers.native``; where it does not serve the
featurizer, the run warns and takes the Python one). ``--devices N``
trains data-parallel over N ranks launched by ``torchrun --nproc-per-node N
-m chemprop_tpu_torch.cli train ...`` (one GPU each; ``--device cpu``: gloo
ranks on the CPU): each rank trains on its whole-graph shard of every batch
(``parallel/shard_train.py``) and only rank 0 writes the run's files.
``--edge-partition [N]`` trains one molecule per step, its edge table cut
into N shards with their halo exchange (:func:`_train_edge_partitioned`,
``parallel/partitioned_mp.py``): N local shards in one process, or one per
rank under torchrun (``partitioned_mp.shard_layout``). ``--from-foundation PATH`` seeds each member's message
passing from a local v2 ``.pt``, v1 ``.pt`` or ``CPTPU001`` file (nothing is
downloaded). A batch holding a molecule of
more than 128 directed edges has no tile table: the kernels that take a
split table do, the others take their forms without a table, and the run
logs how many such calls there were (``ops.UNSERVED``)."""

from __future__ import annotations

import argparse
import csv
import json
import logging
import shutil
from pathlib import Path

import numpy as np
import torch

from chemprop_tpu_torch.cli.common import DTYPES, add_common_args, check_devices, select_mesh
from chemprop_tpu_torch.cli.mab import is_mab, main_MAB
from chemprop_tpu_torch.cli.parsing import (
    build_datasets,
    load_component_feats,
    load_input_feats,
    make_datapoints,
    parse_csv,
    read_columns,
)
from chemprop_tpu_torch.cli.utils.command import Subcommand
from chemprop_tpu_torch.data import DataLoader
from chemprop_tpu_torch.data.datapoints import ReactionDatapoint
from chemprop_tpu_torch.data.datasets import MulticomponentDataset
from chemprop_tpu_torch.data.splitting import make_split_indices, split_data_by_indices
from chemprop_tpu_torch.models import serialize
from chemprop_tpu_torch.models.load import load_model
from chemprop_tpu_torch.featurizers.molecule import MoleculeFeaturizerRegistry
from chemprop_tpu_torch.models.model import MPNN
from chemprop_tpu_torch.models.multi import MulticomponentMPNN
from chemprop_tpu_torch.nn.agg import AggregationRegistry
from chemprop_tpu_torch.nn.message_passing import (
    AtomMessagePassing, BondMessagePassing, MulticomponentMessagePassing,
)
from chemprop_tpu_torch.nn.metrics import LossFunctionRegistry, MetricRegistry
from chemprop_tpu_torch.nn.predictors import PredictorRegistry
from chemprop_tpu_torch.nn.transforms import GraphTransform, ScaleTransform, UnscaleTransform
from chemprop_tpu_torch.ops.build import UNSERVED
from chemprop_tpu_torch.train import Trainer
from chemprop_tpu_torch.utils.device import resolve_device
from chemprop_tpu_torch.utils.registry import Factory

logger = logging.getLogger(__name__)


def add_train_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    add_common_args(parser)
    g = parser.add_argument_group("Train args")
    g.add_argument("-o", "--output-dir", "--save-dir", type=Path, default=None)
    g.add_argument("--target-columns", nargs="+")
    g.add_argument("--ignore-columns", nargs="+")
    g.add_argument("--weight-column")
    g.add_argument(
        "-t",
        "--task-type",
        default="regression",
        choices=sorted(PredictorRegistry.keys()),
    )
    g.add_argument("-l", "--loss-function", choices=sorted(LossFunctionRegistry.keys()))
    g.add_argument("--metrics", "--metric", nargs="+", choices=sorted(MetricRegistry.keys()))
    g.add_argument("--task-weights", nargs="+", type=float)
    g.add_argument(
        "--v-kl",
        "--evidential-regularization",
        type=float,
        default=0.0,
        help="evidential-loss regularization weight (reference default 0.0)",
    )
    g.add_argument("--eps", type=float, default=1e-8, help="evidential regularization epsilon")
    g.add_argument(
        "--alpha", type=float, default=0.1, help="target error bounds for quantile interval loss"
    )
    g.add_argument("--threshold", type=float)
    g.add_argument("--multiclass-num-classes", type=int, default=3)
    g.add_argument(
        "--tracking-metric",
        default="val_loss",
        help="metric tracked for early stopping/checkpointing ('val_loss' or any "
        "metric name; MAB runs may suffix '-mol'/'-atom'/'-bond')",
    )
    g.add_argument("--show-individual-scores", action="store_true")

    # message passing
    g.add_argument("--message-hidden-dim", type=int, default=300)
    g.add_argument("--message-bias", action="store_true")
    g.add_argument("--depth", type=int, default=3)
    g.add_argument("--undirected", action="store_true")
    g.add_argument("--dropout", type=float, default=0.0)
    g.add_argument("--activation", default="relu")
    g.add_argument("--atom-messages", action="store_true")
    # the default is "norm" (sum / 100), as in the reference
    g.add_argument("--aggregation", "--agg", default="norm",
                   choices=sorted(AggregationRegistry.keys()))
    g.add_argument("--aggregation-norm", type=float, default=100.0)
    g.add_argument("--batch-norm", action="store_true")
    g.add_argument("--mpn-shared", action="store_true")

    # FFN (--ffn-hidden-dim takes one width, or one per layer)
    g.add_argument("--ffn-hidden-dim", type=int, nargs="+", default=300)
    g.add_argument("--ffn-num-layers", type=int, default=1)

    # training
    g.add_argument("--epochs", type=int, default=50)
    g.add_argument("--warmup-epochs", type=int, default=2)
    g.add_argument("--init-lr", type=float, default=1e-4)
    g.add_argument("--max-lr", type=float, default=1e-3)
    g.add_argument("--final-lr", type=float, default=1e-4)
    g.add_argument("--grad-clip", type=float)
    g.add_argument("--patience", type=int, default=None)
    g.add_argument(
        "--min-delta",
        type=float,
        default=0.0,
        help="minimum tracked-metric change that counts as improvement",
    )
    g.add_argument("--class-balance", action="store_true")
    g.add_argument("--seed", "--pytorch-seed", type=int, default=0)
    g.add_argument("--data-seed", type=int, default=0)
    g.add_argument(
        "--remove-checkpoints",
        action="store_true",
        help="delete the per-epoch checkpoints/ dir after training",
    )
    g.add_argument(
        "--profile",
        action="store_true",
        help="write a torch.profiler Chrome trace of the first few training steps "
        "into <model-dir>/profile/trace.json",
    )
    g.add_argument(
        "--tensorboard",
        action="store_true",
        help="also log per-epoch scalars as tfevents into "
        "<model-dir>/tensorboard (history.json is always written)",
    )

    # splits
    g.add_argument(
        "--split",
        "--split-type",
        default="random",
        choices=["random", "scaffold_balanced", "random_with_repeated_smiles", "kennard_stone", "kmeans"],
    )
    g.add_argument("--split-sizes", nargs=3, type=float, default=[0.8, 0.1, 0.1])
    g.add_argument(
        "--split-key-molecule",
        type=int,
        default=0,
        help="index of the component used for constrained splits (scaffold etc.)",
    )
    g.add_argument("--splits-column")
    g.add_argument("--splits-file", type=Path)
    g.add_argument("--num-replicates", type=int, default=1)
    g.add_argument(
        "-k",
        "--num-folds",
        help="[removed in v2.1.0 of the reference — use --num-replicates]",
    )
    g.add_argument("--save-smiles-splits", action="store_true")
    g.add_argument("--save-data-splits", action="store_true")
    g.add_argument("--ensemble-size", type=int, default=1)

    g.add_argument("--no-batch-norm", action="store_true", help=argparse.SUPPRESS)
    g.add_argument("--no-cache", action="store_true")
    g.add_argument(
        "--edge-partition",
        type=int,
        nargs="?",
        const=0,
        default=None,
        metavar="N",
        help="edge-partitioned training: each molecule's edge table cut into N "
        "contiguous shards with their halo exchange (N local shards, or one per rank "
        "under torchrun; 0/omitted: the world size) — for molecules too large for one "
        "device's batch slice; one molecule per step",
    )

    # transfer learning and resuming
    g.add_argument("--checkpoint", type=Path, help="warm-start weights from a checkpoint")
    g.add_argument(
        "--model-frzn",
        type=Path,
        help="[deprecated in the reference; = --checkpoint + --freeze-encoder]",
    )
    g.add_argument(
        "--from-foundation",
        help="warm-start the message passing from a local checkpoint: a v2 .pt, a v1 .pt "
        "or a CPTPU001 file",
    )
    g.add_argument("--freeze-encoder", action="store_true")
    g.add_argument("--frzn-ffn-layers", type=int, default=0)
    g.add_argument("--resume", type=Path, help="resume a run from a last.ckpt")

    # mol+atom+bond multi-head targets (a mol-atom-bond model, cli/mab.py)
    g.add_argument(
        "--mol-target-columns",
        nargs="+",
        help="molecule-level target columns when atom/bond targets are also given "
        "(alias of --target-columns in MAB runs)",
    )
    g.add_argument("--atom-target-columns", nargs="+")
    g.add_argument("--bond-target-columns", nargs="+")
    g.add_argument(
        "--constraints-path",
        type=Path,
        help="CSV of per-molecule sum constraints; either columns named "
        "'<target>_constraint' or raw columns mapped via --constraints-to-targets",
    )
    g.add_argument(
        "--constraints-to-targets",
        nargs="+",
        help="atom/bond target column names corresponding to each constraints-CSV column",
    )
    # per-head FFN widths of mol-atom-bond models
    g.add_argument("--atom-task-weights", nargs="+", type=float)
    g.add_argument("--bond-task-weights", nargs="+", type=float)
    g.add_argument("--atom-ffn-hidden-dim", type=int, nargs="+", default=None)
    g.add_argument("--atom-ffn-num-layers", type=int, default=None)
    g.add_argument("--bond-ffn-hidden-dim", type=int, nargs="+", default=None)
    g.add_argument("--bond-ffn-num-layers", type=int, default=None)
    g.add_argument("--atom-multiclass-num-classes", type=int, default=3)
    g.add_argument("--bond-multiclass-num-classes", type=int, default=3)
    g.add_argument("--atom-constrainer-ffn-hidden-dim", type=int, nargs="+", default=None)
    g.add_argument("--atom-constrainer-ffn-num-layers", type=int, default=None)
    g.add_argument("--bond-constrainer-ffn-hidden-dim", type=int, nargs="+", default=None)
    g.add_argument("--bond-constrainer-ffn-num-layers", type=int, default=None)
    g.add_argument(
        "--activation-args",
        nargs="+",
        type=float,
        help="positional args for the activation, accepted as in the JAX package, "
        "which reads them from the name (leakyrelu:0.1)",
    )
    return parser


def process_train_args(args) -> None:
    """Normalise the parsed arguments in place, as the JAX package does."""
    paths = getattr(args, "data_paths", None) or (
        [args.data_path] if getattr(args, "data_path", None) else []
    )
    args.data_paths = [Path(p) for p in paths]
    if len(args.data_paths) > 1:
        if is_mab(args):
            raise ValueError(
                "multiple -i files are not supported for atom/bond-target (MAB) training")
        for name in ("descriptors_path", "atom_features_path", "bond_features_path",
                     "atom_descriptors_path"):
            if getattr(args, name, None):
                raise ValueError(
                    f"--{name.replace('_', '-')} is not supported with multiple -i files "
                    "(per-file extra-feature tables would be required)"
                )
        if len(args.data_paths) == 3 and args.num_replicates > 1:
            logger.warning(
                "num_replicates is fixed to 1 when train, val, test data are "
                "supplied in 3 separate files"
            )
            args.num_replicates = 1
    if getattr(args, "num_folds", None) is not None:
        raise ValueError(
            "the -k/--num-folds argument was removed in reference v2.1.0 — "
            "use --num-replicates instead"
        )
    if getattr(args, "model_frzn", None) is not None:
        if args.checkpoint is not None:
            raise ValueError("--checkpoint and --model-frzn cannot be used together")
        args.checkpoint = args.model_frzn
        args.freeze_encoder = True
    if getattr(args, "from_foundation", None) is not None and args.checkpoint is not None:
        raise ValueError("--checkpoint and --from-foundation are mutually exclusive")
    if args.frzn_ffn_layers and args.checkpoint is None and args.from_foundation is None:
        raise ValueError(
            "--frzn-ffn-layers requires --checkpoint (or --model-frzn/--from-foundation)"
        )
    if getattr(args, "mol_target_columns", None):
        if args.target_columns:
            raise ValueError("--mol-target-columns and --target-columns are aliases; give one")
        args.target_columns = args.mol_target_columns
    # per-layer FFN widths: a single value stays scalar, a list implies n_layers
    for stem in ("ffn", "atom_ffn", "bond_ffn", "atom_constrainer_ffn", "bond_constrainer_ffn"):
        dims = getattr(args, f"{stem}_hidden_dim", None)
        if isinstance(dims, list):
            if len(dims) == 1:
                setattr(args, f"{stem}_hidden_dim", dims[0])
            else:
                setattr(args, f"{stem}_num_layers", len(dims))


def refuse_unported(args) -> None:
    """Raise, before any data is read, for what neither package can do: a
    ``--from-foundation`` that is not a local path (a named foundation model
    is never fetched, as in the JAX package: ``FileNotFoundError``), or a
    device count ``check_devices`` refuses."""
    path = getattr(args, "from_foundation", None)
    if path is not None and not Path(path).exists():
        raise FileNotFoundError(
            f"--from-foundation expects a local checkpoint path in this build "
            f"(no network access to fetch named foundation models); got {path}")
    check_devices(args)


def build_model(args, train_dset, output_transform=None, X_d_transform=None, V_d_transform=None,
                graph_transform=None) -> MPNN:
    """The model the arguments describe, for ``train_dset``'s featurizers,
    targets and extra inputs; the regression heads unscale by
    ``output_transform``. A ``MulticomponentDataset`` gives a
    ``MulticomponentMPNN`` with one block per component, or one block for
    all with ``--mpn-shared``, each block at its component's input widths
    with its component's transforms (lists, one per component)."""
    multi = isinstance(train_dset, MulticomponentDataset)
    datasets = train_dset.datasets if multi else [train_dset]
    n_blocks = 1 if args.mpn_shared else len(datasets)
    V_d_ts = V_d_transform if isinstance(V_d_transform, list) else [V_d_transform] * n_blocks
    graph_ts = (graph_transform if isinstance(graph_transform, list)
                else [graph_transform] * n_blocks)
    mp_cls = AtomMessagePassing if args.atom_messages else BondMessagePassing
    blocks = []
    for k in range(n_blocks):
        d_v, d_e = datasets[k].featurizer.shape
        blocks.append(mp_cls(
            d_v=d_v, d_e=d_e, d_h=args.message_hidden_dim, bias=args.message_bias,
            depth=args.depth, dropout=args.dropout, activation=args.activation,
            undirected=args.undirected, compute_dtype=DTYPES[args.dtype],
            d_vd=datasets[k].d_vd or None, V_d_transform=V_d_ts[k], graph_transform=graph_ts[k],
        ))
    mp = (MulticomponentMessagePassing(blocks, len(datasets), args.mpn_shared) if multi
          else blocks[0])
    # the attentive readout's W takes one component's node table
    agg = Factory.build(AggregationRegistry[args.aggregation], norm=args.aggregation_norm,
                        output_size=blocks[0].output_dim)
    # the criterion is always built here, so that the loss's own arguments
    # (--v-kl, --eps, --alpha, ...) reach the default loss too
    loss_cls = (LossFunctionRegistry[args.loss_function] if args.loss_function is not None
                else PredictorRegistry[args.task_type]._T_default_criterion)
    criterion = Factory.build(
        loss_cls, task_weights=args.task_weights or 1.0, v_kl=args.v_kl,
        eps=getattr(args, "eps", 1e-8), alpha=getattr(args, "alpha", 0.1),
        threshold=args.threshold, n_classes=args.multiclass_num_classes,
    )
    predictor = Factory.build(
        PredictorRegistry[args.task_type], input_dim=mp.output_dim + train_dset.d_xd,
        n_tasks=train_dset.t, hidden_dim=args.ffn_hidden_dim, n_layers=args.ffn_num_layers,
        dropout=args.dropout, activation=args.activation, criterion=criterion,
        task_weights=args.task_weights, threshold=args.threshold,
        n_classes=args.multiclass_num_classes,
    )
    if output_transform is not None:
        predictor.output_transform = output_transform
    return (MulticomponentMPNN if multi else MPNN)(
        mp, agg, predictor, batch_norm=args.batch_norm, X_d_transform=X_d_transform)


def build_splits(args, components):
    """``(trains, vals, tests)``, one index list per replicate, from
    ``--splits-file`` or ``--split``; None with a ``--splits-column``."""
    if args.splits_column is not None:
        return None  # handled by the caller with the parsed column
    if args.splits_file is not None:
        with open(args.splits_file) as f:
            splits = json.load(f)
        return ([s.get("train", []) for s in splits], [s.get("val", []) for s in splits],
                [s.get("test", []) for s in splits])
    key = min(getattr(args, "split_key_molecule", 0), len(components) - 1)
    mols = [dp.rct if isinstance(dp, ReactionDatapoint) else dp.mol for dp in components[key]]
    return make_split_indices(
        mols, args.split, tuple(args.split_sizes), args.data_seed, args.num_replicates
    )


def normalize_inputs(train_dset, val_dset, args):
    """Fit the extra inputs' scalers on train, apply them to train and
    validation, and return the transforms that scale them in the model at
    evaluation: ``(X_d_transform, V_d_transform, graph_transform)``. A
    multicomponent dataset's ``X_d`` is component 0's, and its atom
    descriptors and extra features are scaled per component (a reaction's
    have none): the last two are then lists, one per component."""
    multi = isinstance(train_dset, MulticomponentDataset)
    datasets = train_dset.datasets if multi else [train_dset]
    val_datasets = ([None] * len(datasets) if val_dset is None
                    else val_dset.datasets if multi else [val_dset])

    def fit(d, vd, key):
        scaler = d.normalize_inputs(key)
        if vd is not None:
            vd.normalize_inputs(key, scaler)
        return scaler

    X_d_transform = None
    if datasets[0].d_xd > 0 and not args.no_descriptor_scaling:
        X_d_transform = ScaleTransform.from_standard_scaler(fit(datasets[0], val_datasets[0],
                                                                "X_d"))
    V_d_ts, graph_ts = [], []
    for d, vd in zip(datasets, val_datasets):
        V_d_t = graph_t = None
        if d.d_vd > 0 and not args.no_atom_descriptor_scaling:
            V_d_t = ScaleTransform.from_standard_scaler(fit(d, vd, "V_d"))
        # the extra atom and bond features scale the featurizer's last columns
        feats = {}
        for key, width, off, fdim in (
                ("V_f", d.d_vf, args.no_atom_feature_scaling, d.featurizer.atom_fdim),
                ("E_f", d.d_ef, args.no_bond_feature_scaling, d.featurizer.bond_fdim)):
            if width > 0 and not off:
                feats[key] = ScaleTransform.from_standard_scaler(fit(d, vd, key),
                                                                 pad=fdim - width)
        if feats:
            graph_t = GraphTransform(feats.get("V_f"), feats.get("E_f"))
        V_d_ts.append(V_d_t)
        graph_ts.append(graph_t)
    if not multi:
        return X_d_transform, V_d_ts[0], graph_ts[0]
    return X_d_transform, V_d_ts, graph_ts


def _read_inputs(args, path, descriptors_cols, with_side_files: bool):
    """One ``-i`` file's parsed CSV and its datapoints."""
    ignore_cols = list(args.ignore_columns or [])
    parsed = parse_csv(
        path, args.smiles_columns, args.reaction_columns, args.target_columns,
        ignore_cols + descriptors_cols, args.weight_column,
        bounded=args.loss_function is not None and "bounded" in args.loss_function,
        splits_col=args.splits_column if with_side_files else None,
        no_header_row=args.no_header_row,
    )
    smis, rxns, Y, weights, lt, gt = parsed[:6]
    n = len(Y)
    X_d = load_input_feats(args.descriptors_path, n) if with_side_files else None
    if descriptors_cols:
        col_X = read_columns(path, descriptors_cols, args.no_header_row)
        X_d = list(col_X) if X_d is None else [np.concatenate([a, b]) for a, b in zip(X_d, col_X)]
    side = {}
    if with_side_files:
        side = dict(V_fs=load_component_feats(args.atom_features_path, n),
                    E_fs=load_component_feats(args.bond_features_path, n),
                    V_ds=load_component_feats(args.atom_descriptors_path, n))
    components = make_datapoints(
        smis, rxns, Y, weights, lt, gt, keep_h=args.keep_h, add_h=args.add_h,
        ignore_stereo=args.ignore_stereo, X_d=X_d, **side,
        molecule_featurizers=[MoleculeFeaturizerRegistry[name]()
                              for name in (args.molecule_featurizers or [])],
    )
    return parsed, components


def _draw_first_batch(loader: DataLoader) -> None:
    """Draw one batch, as the JAX package does to initialise a state (in its
    ``Trainer.fit``, and in its command line before a warm start or a
    resume): each draw of a shuffled loader reshuffles, so the port draws
    where it does, and both train on the same batches in every epoch."""
    next(iter(loader))


def graft_message_passing(model: MPNN, path) -> None:
    """``--from-foundation``: the message-passing parameters of a local v2
    ``.pt``, v1 ``.pt`` or ``CPTPU001`` file over ``model``'s (its transforms
    stay the model's, as the JAX package grafts parameters alone)."""
    source = dict(load_model(path, "cpu")[0].message_passing.named_parameters())
    target = dict(model.message_passing.named_parameters())
    shapes = {k: tuple(v.shape) for k, v in source.items()}
    if shapes != {k: tuple(v.shape) for k, v in target.items()}:
        raise ValueError(f"{path}'s message passing {shapes} does not fit the model's "
                         f"{ {k: tuple(v.shape) for k, v in target.items()} }")
    with torch.no_grad():
        for k, p in target.items():
            p.copy_(source[k])


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


def _freeze_predicate(args):
    """The JAX package's freeze rule on a parameter's JAX path, or None."""
    if not (args.freeze_encoder or args.frzn_ffn_layers):
        return None
    frzn_blocks = {f"block{i}" for i in range(args.frzn_ffn_layers)}

    def freeze(path: str) -> bool:
        if args.freeze_encoder and path.startswith("message_passing"):
            return True
        parts = path.split("/")
        return len(parts) > 2 and parts[-2] in frzn_blocks and "ffn" in parts

    return freeze


def main(args) -> int:
    process_train_args(args)
    refuse_unported(args)
    if is_mab(args):
        return main_MAB(args)
    device = resolve_device(args.device)  # raises where there is no GPU
    mesh = select_mesh(args, device)
    try:
        return _main(args, device if mesh is None else mesh.device, mesh)
    finally:
        if mesh is not None:
            from chemprop_tpu_torch.parallel import distributed

            distributed.shutdown()


def _main(args, device, mesh) -> int:
    """``main`` on ``device``, over ``mesh`` (None: one process); only
    rank 0 writes the run's files."""
    writes = mesh is None or mesh.rank == 0
    unserved_before = dict(UNSERVED)

    out_dir = args.output_dir or Path(f"chemprop_tpu_training/{args.data_path.stem}")
    out_dir.mkdir(parents=True, exist_ok=True)

    descriptors_cols = list(getattr(args, "descriptors_columns", None) or [])
    parsed, components = _read_inputs(args, args.data_path, descriptors_cols, True)
    smis, rxns, Y, _, _, _, splits_col_values, _, target_cols = parsed
    n = len(Y)

    # extra -i files join the pool of datapoints at known index ranges: with
    # two files the second is the test set; three are fixed train/val/test
    extra_ns = []
    for p in args.data_paths[1:]:
        parsed2, comps2 = _read_inputs(args, p, descriptors_cols, False)
        for c, extra in zip(components, comps2):
            c.extend(extra)
        for col in smis:
            smis[col].extend(parsed2[0][col])
        for col in rxns:
            rxns[col].extend(parsed2[1][col])
        Y = np.concatenate([Y, parsed2[2]], axis=0)
        extra_ns.append(len(parsed2[2]))

    if writes:
        with open(out_dir / "config.json", "w") as f:
            json.dump({k: _jsonable(v) for k, v in vars(args).items() if k != "func"}, f,
                      indent=2)

    if len(args.data_paths) == 3:
        n1, n2 = extra_ns
        split_idxs = ([list(range(n))], [list(range(n, n + n1))],
                      [list(range(n + n1, n + n1 + n2))])
    elif splits_col_values is not None:
        split_idxs = tuple([[i for i, s in enumerate(splits_col_values) if s == name]]
                           for name in ("train", "val", "test"))
    else:
        # splits are computed over the first file's rows only
        split_idxs = build_splits(args, [c[:n] for c in components])
    if len(args.data_paths) == 2:
        # the second file is the test set (its rows sit at [n, n + n1))
        trains_, vals_, _ = split_idxs
        split_idxs = (trains_, vals_, [list(range(n, n + extra_ns[0])) for _ in trains_])
    trains, vals, tests = split_idxs

    if writes:
        with open(out_dir / "splits.json", "w") as f:
            json.dump([{"train": list(map(int, t)), "val": list(map(int, v)),
                        "test": list(map(int, s))} for t, v, s in zip(trains, vals, tests)], f)

    multi = len(components) > 1
    all_scores = []
    for rep, (tr_i, va_i, te_i) in enumerate(zip(trains, vals, tests)):
        (train_data,), (val_data,), (test_data,) = split_data_by_indices(
            components if multi else components[0], [tr_i], [va_i], [te_i])

        def mk(data):
            return build_datasets(data if multi else [data], multi_hot_atom_featurizer_mode=
                                  args.multi_hot_atom_featurizer_mode, rxn_mode=args.rxn_mode)

        train_dset = mk(train_data)
        val_dset = mk(val_data) if len(va_i) else None
        test_dset = mk(test_data) if len(te_i) else None
        _log_data_summary(rep, train_dset, val_dset, test_dset, target_cols)

        rep_dir = out_dir / (f"replicate_{rep}" if len(trains) > 1 else ".")
        if (args.save_smiles_splits or args.save_data_splits) and writes:
            rep_dir.mkdir(parents=True, exist_ok=True)
            _save_split_csvs(rep_dir, args, (tr_i, va_i, te_i), {**smis, **rxns}, Y,
                             target_cols)

        X_d_t, V_d_t, graph_t = normalize_inputs(train_dset, val_dset, args)
        output_transform = None
        if args.task_type.startswith("regression"):
            scaler = train_dset.normalize_targets()
            if val_dset is not None:
                val_dset.normalize_targets(scaler)
            output_transform = UnscaleTransform.from_standard_scaler(scaler)
            logger.info(f"train target μ={scaler.mean_} σ={scaler.scale_}")

        if args.edge_partition is not None:
            scores = _train_edge_partitioned(args, train_dset, val_dset, test_dset,
                                             output_transform, X_d_t, V_d_t, graph_t, rep_dir,
                                             target_cols, device, mesh)
            if scores is not None:
                all_scores.append(scores)
            continue

        if not args.no_cache:
            for d in (train_dset, val_dset):
                if d is None:
                    continue
                if args.use_cuikmolmaker_featurization and hasattr(d, "populate_cache_native"):
                    if not d.populate_cache_native(keep_h=args.keep_h):
                        logger.warning("the native featurizer does not serve this featurizer; "
                                       "falling back to the Python featurization cache")
                        d.cache = True
                else:
                    d.cache = True
        # over a mesh every rank draws the same batches and collates its shard
        shards = {} if mesh is None else {"n_shards": mesh.size, "shard_index": mesh.rank}
        train_loader = DataLoader(train_dset, batch_size=args.batch_size,
                                  shuffle=not args.class_balance,
                                  class_balance=args.class_balance, seed=args.data_seed,
                                  **shards)
        val_loader = (DataLoader(val_dset, batch_size=args.batch_size, **shards)
                      if val_dset is not None else None)

        for member in range(args.ensemble_size):
            model_dir = rep_dir / (f"model_{member}" if args.ensemble_size > 1 else ".")
            model_dir.mkdir(parents=True, exist_ok=True)
            model = build_model(args, train_dset, output_transform, X_d_t, V_d_t, graph_t)
            monitor, mode, val_metrics = "val_loss", "min", {}
            tracking = getattr(args, "tracking_metric", "val_loss")
            if tracking and tracking != "val_loss":
                tm = Factory.build(MetricRegistry[tracking], n_classes=args.multiclass_num_classes)
                val_metrics[tracking] = tm
                monitor = f"val_{tracking}"
                mode = "max" if tm.higher_is_better else "min"
            trainer = Trainer(
                model, max_epochs=args.epochs, warmup_epochs=args.warmup_epochs,
                init_lr=args.init_lr, max_lr=args.max_lr, final_lr=args.final_lr,
                grad_clip=args.grad_clip, patience=args.patience, min_delta=args.min_delta,
                monitor=monitor, mode=mode, val_metrics=val_metrics,
                profile_dir=(model_dir / "profile") if args.profile else None,
                tensorboard_dir=(model_dir / "tensorboard") if args.tensorboard else None,
                checkpoint_dir=model_dir / "checkpoints", seed=args.seed + member,
                log_every=1, freeze=_freeze_predicate(args), device=device, mesh=mesh,
            )
            if args.from_foundation is not None:
                _draw_first_batch(train_loader)
                trainer.init_state(None, len(train_loader))
                graft_message_passing(model, args.from_foundation)
            if args.checkpoint is not None:
                # the file's parameters and batch-norm statistics over a fresh
                # state: Adam starts from zero moments
                _draw_first_batch(train_loader)
                _, warm = serialize.read_checkpoint(args.checkpoint)
                trainer.init_state(None, len(train_loader))
                serialize.load_variables(model, warm)
            if args.resume is not None:
                _draw_first_batch(train_loader)
                trainer.start_epoch = trainer.resume_from(args.resume, None, len(train_loader))
            _draw_first_batch(train_loader)  # the JAX trainer's fit draws one too
            trainer.fit(train_loader, val_loader)
            if writes:
                serialize.save_checkpoint(
                    model_dir / "best.ckpt", model,
                    serialize.to_jax_params(trainer.best_variables),
                    {"output_columns": target_cols})
                with open(model_dir / "history.json", "w") as f:
                    json.dump(trainer.history, f, indent=2)
                if args.remove_checkpoints:
                    shutil.rmtree(model_dir / "checkpoints", ignore_errors=True)

            if test_dset is not None and len(test_dset):
                # every rank's rows, gathered on every rank
                preds = trainer.predict(DataLoader(test_dset, batch_size=args.batch_size))
                scores = _score_test(preds, test_dset, args, target_cols)
                all_scores.append(scores)
                logger.info(f"replicate {rep} model {member} test scores: {scores}")
                if writes:
                    _save_preds(model_dir / "test_predictions.csv", test_dset, preds,
                                target_cols)

    unserved = {k: v - unserved_before.get(k, 0) for k, v in UNSERVED.items()
                if v != unserved_before.get(k, 0)}
    if unserved:
        logger.warning(f"calls without a tile table (a molecule of more than 128 directed "
                       f"edges in the batch), by kernel: {unserved}")
    if all_scores and writes:
        with open(out_dir / "test_scores.json", "w") as f:
            json.dump(all_scores, f, indent=2)
        print(json.dumps(all_scores[-1]))
    return 0


def _train_edge_partitioned(args, train_dset, val_dset, test_dset, output_transform, X_d_t,
                            V_d_t, graph_t, out_dir: Path, target_cols, device, mesh):
    """Edge-partitioned training (cf. the JAX CLI's ``_train_edge_partitioned``):
    one molecule per step, its edge table cut across the shards with the halo
    exchange (``parallel/partitioned_mp.py``); the JAX package's loop. The
    molecules fall into power-of-two buckets of padded dims; those that no
    plan over the shards takes (a halo wider than a shard's owned range) take
    a dense batched step of the model's own forward, with the same
    parameters and Adam state, so mixed datasets train in one run. With a
    validation split, each epoch's validation loss picks the best parameters
    and drives ``--patience``. Writes a standard ``best.ckpt`` (the model
    predicts on the single-device path too), ``history.json``, the test
    predictions and returns the test scores."""
    from chemprop_tpu_torch.data.collate import PadSpec, collate_batch
    from chemprop_tpu_torch.nn.init import init_parameters
    from chemprop_tpu_torch.parallel import partitioned_mp as pm
    from chemprop_tpu_torch.parallel.shard_train import rank_generator
    from chemprop_tpu_torch.parallel.sharding import replicate
    from chemprop_tpu_torch.train.schedulers import noam_lr
    from chemprop_tpu_torch.train.trainer import TrainState, _targets, adam_update

    writes = mesh is None or mesh.rank == 0
    n_shards, where = pm.shard_layout(args.edge_partition or None, mesh)
    exchange = pm.exchange_for(where)
    model = build_model(args, train_dset, output_transform, X_d_t, V_d_t, graph_t)
    pm.check_partitionable(model)
    out_dir.mkdir(parents=True, exist_ok=True)

    def data(dset):
        return [dset[i] for i in range(len(dset))] if dset is not None else []

    train, vals, tests = data(train_dset), data(val_dset), data(test_dset)
    if not train:
        raise ValueError("--edge-partition training needs a non-empty train split")
    all_data = train + vals + tests
    keys, graphs, bucket_dims = pm.plan_buckets(all_data, n_shards)
    n_tr, n_va = len(train), len(vals)
    dense_sel = [k is None for k in keys]
    placed = [None if g is None else pm.place(g, bucket_dims[k], exchange, device)
              for g, k in zip(graphs[: n_tr + n_va], keys[: n_tr + n_va])]
    logger.info(
        f"edge-partitioned training over {n_shards} shards: {len(bucket_dims)} dim bucket(s) "
        + ", ".join(f"[P≤{k}: {sum(1 for x in keys if x == k)} mols"
                    f"{' 1-phase halo' if bucket_dims[k].single_phase else ''}]"
                    for k in sorted(bucket_dims))
        + (f" + {sum(dense_sel)} dense-path molecules" if any(dense_sel) else "")
        + f", {n_tr} molecules/epoch")

    init_parameters(model, "lecun", torch.Generator().manual_seed(args.seed))
    model.to(device)
    if mesh is not None:
        replicate(list(model.state_dict().values()), mesh)
    x_ds = [None if d.x_d is None else
            torch.as_tensor(np.asarray(d.x_d, np.float32).reshape(1, -1), device=device)
            for d in all_data]
    dense_train = [i for i in range(n_tr) if dense_sel[i]]
    part_train = [i for i in range(n_tr) if not dense_sel[i]]
    dense_bs = max(1, min(args.batch_size, max(1, len(dense_train))))
    dense_pad = (PadSpec.for_graphs([d.mg for d, s in zip(all_data, dense_sel) if s],
                                    n_graphs=dense_bs) if any(dense_sel) else None)
    n_dense_batches = -(-len(dense_train) // dense_bs) if dense_train else 0
    steps = max(1, len(part_train) + n_dense_batches)
    sched = (args.warmup_epochs * steps, max(1, (args.epochs - args.warmup_epochs) * steps),
             args.init_lr, args.max_lr, args.final_lr)

    def lr(step: int) -> float:
        return noam_lr(step, *sched)

    params = dict(model.named_parameters())
    rank = 0 if mesh is None else mesh.rank
    state = TrainState(params, {}, [torch.zeros_like(p) for p in params.values()],
                       [torch.zeros_like(p) for p in params.values()], 0,
                       rng=torch.Generator(device=device).manual_seed(args.seed),
                       shard_rng=rank_generator(args.seed + 1, rank, device))
    step_fns = {k: pm.make_partitioned_train_step(model, exchange, dims, lr=lr)
                for k, dims in bucket_dims.items()}
    val_fns = {k: pm.make_partitioned_apply(model, exchange, dims, train_space=True)
               for k, dims in bucket_dims.items()}
    criterion = model.criterion

    def update(st, preds, Y, w):
        mask = torch.isfinite(Y)
        no = torch.zeros_like(mask)
        return criterion.update_state(st, preds, torch.nan_to_num(Y), mask, w, no, no)

    def dense_step(batch):
        b = batch.to(device)
        names, ps = list(state.params), list(state.params.values())
        with torch.enable_grad():
            preds = model.train_step_preds(b.bmg, b.V_d, b.X_d, is_training=True,
                                           generator=state.rng)
            mask, targets, _, _ = _targets(b)
            no = torch.zeros_like(mask)
            loss = criterion.compute(criterion.update_state(
                criterion.init_state(), preds, targets, mask, b.w[:, 0], no, no))
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]
        adam_update(ps, grads, state.mu, state.nu, state.step, lr(state.step))
        state.step += 1
        return loss.detach()

    def target(d):
        return (torch.as_tensor(np.asarray(d.y, np.float32), device=device)[None],
                torch.tensor([float(d.weight)], device=device))

    val_dense = []
    dense_val = [d for d, k in zip(vals, keys[n_tr : n_tr + n_va]) if k is None]
    for j in range(0, len(dense_val), dense_bs):
        chunk = dense_val[j : j + dense_bs]
        val_dense.append((collate_batch(chunk, dense_pad).to(device), len(chunk)))

    @torch.inference_mode()
    def val_loss() -> float:
        st = criterion.init_state()
        for i in range(n_tr, n_tr + n_va):
            if keys[i] is not None:
                y, w = target(all_data[i])
                st = update(st, val_fns[keys[i]](placed[i], x_ds[i]), y, w)
        for b, n in val_dense:
            preds = model.train_step_preds(b.bmg, b.V_d, b.X_d, is_training=False)[:n]
            st = update(st, preds, b.Y[:n], b.w[:n, 0])
        return float(criterion.compute(st))

    rng = np.random.default_rng(args.data_seed)
    history, best_val, best = [], float("inf"), None
    patience = args.patience if (vals and args.patience) else None
    bad_epochs = 0
    for epoch in range(args.epochs):
        # partitioned molecules and dense batches in one shuffled work list
        d_order = rng.permutation(len(dense_train)) if dense_train else np.array([], int)
        work: list = [("p", i) for i in part_train]
        for j in range(0, len(d_order), dense_bs):
            work.append(("d", [dense_train[t] for t in d_order[j : j + dense_bs]]))
        work = [work[t] for t in rng.permutation(len(work))]
        losses = []
        for kind, payload in work:
            if kind == "p":
                i = int(payload)
                y, w = target(train[i])
                losses.append(step_fns[keys[i]](state, placed[i], y, w, x_ds[i]))
            else:
                losses.append(dense_step(collate_batch([train[i] for i in payload], dense_pad)))
        rec = {"epoch": epoch, "train_loss": float(torch.stack(losses).float().mean())}
        if vals:
            rec["val_loss"] = val_loss()
            if rec["val_loss"] < best_val:
                best_val, bad_epochs = rec["val_loss"], 0
                best = {k: v.detach().clone() for k, v in params.items()}
            else:
                bad_epochs += 1
        history.append(rec)
        logger.info(f"epoch={epoch} train_loss={rec['train_loss']:.5g}"
                    + (f" val_loss={rec['val_loss']:.5g}" if vals else ""))
        if patience is not None and bad_epochs >= patience:
            logger.info(f"early stopping at epoch {epoch} (patience={patience})")
            break

    if best is not None:
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(best[k])
    if writes:
        serialize.save_checkpoint(out_dir / "best.ckpt", model,
                                  serialize.to_jax_params(dict(params)),
                                  {"output_columns": target_cols})
        with open(out_dir / "history.json", "w") as f:
            json.dump(history, f, indent=2)
    if not tests:
        return None
    session = pm.PartitionedInference(
        model, tests, plan=(keys[n_tr + n_va :], graphs[n_tr + n_va :], bucket_dims),
        mesh=where, dense_batch_size=dense_bs, device=device)
    preds = session.run(model)
    scores = _score_test(preds, test_dset, args, target_cols)
    logger.info(f"edge-partitioned test scores: {scores}")
    if writes:
        _save_preds(out_dir / "test_predictions.csv", test_dset, preds, target_cols)
    return scores


def _log_data_summary(rep, train_dset, val_dset, test_dset, target_cols) -> None:
    """Each split's size and each task's target statistics."""
    sizes = {"train": len(train_dset), "val": len(val_dset) if val_dset is not None else 0,
             "test": len(test_dset) if test_dset is not None else 0}
    logger.info(f"replicate {rep} split sizes: " + "  ".join(f"{k}={v}" for k, v in sizes.items()))
    Y = np.asarray(train_dset._Y, dtype=np.float64)
    lines = []
    for j, col in enumerate(target_cols[: Y.shape[1]]):
        y = Y[:, j]
        y = y[np.isfinite(y)]
        if y.size:
            lines.append(f"  {col}: n={y.size} mean={y.mean():.4g} std={y.std():.4g} "
                         f"min={y.min():.4g} max={y.max():.4g}")
    if lines:
        logger.info("train target summary:\n" + "\n".join(lines))


def _cell(v: float) -> str:
    """A float as pandas writes it: the shortest repr, empty for NaN."""
    return "" if np.isnan(v) else repr(float(v))


def _save_split_csvs(split_dir, args, split_idxs, smis, Y, target_cols) -> None:
    """``{train,val,test}_smiles.csv`` (``--save-smiles-splits``) and
    ``{train,val,test}_full.csv`` with the targets (``--save-data-splits``);
    ``smis`` holds every input column, the SMILES columns' and then the
    reaction columns'."""
    input_cols = list(smis)
    for name, idxs in zip(("train", "val", "test"), split_idxs):
        idxs = list(map(int, idxs))
        if not idxs:
            continue
        tables = []
        if args.save_smiles_splits:
            tables.append((f"{name}_smiles.csv", input_cols,
                           [[smis[c][i] for c in input_cols] for i in idxs]))
        if args.save_data_splits:
            tables.append((f"{name}_full.csv", input_cols + list(target_cols),
                           [[smis[c][i] for c in input_cols]
                            + [_cell(Y[i, j]) for j in range(len(target_cols))] for i in idxs]))
        for fname, header, rows in tables:
            with open(split_dir / fname, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(header)
                w.writerows(rows)


def _score_test(preds: np.ndarray, test_dset, args, target_cols) -> dict:
    """Each of ``--metrics`` (or the task's defaults) on the test set's raw
    targets and the inference-space predictions; a failing metric is NaN."""
    Y = test_dset._Y.astype(np.float32)
    mask = np.isfinite(Y)
    preds_for_metric = preds
    if preds.ndim == 3:
        if (args.task_type.startswith("regression")
                or args.task_type == "classification-dirichlet"):
            # (mean, ...) of the multi-target heads, or (p, u): channel 0
            preds_for_metric = preds[..., 0]
        elif args.task_type == "multiclass-dirichlet":
            preds_for_metric = preds[..., :-1]  # the uncertainty channel u = c / S

    def one(metric, p, y, m) -> float:
        if metric.needs_collection:
            return float(metric.compute_from_arrays(np.asarray(p), y, m))
        m = torch.from_numpy(m)
        no_bounds = torch.zeros_like(m)
        state = metric.update_state(metric.init_state(), torch.from_numpy(np.asarray(p)),
                                    torch.from_numpy(np.nan_to_num(y)), m, torch.ones(len(y)),
                                    no_bounds, no_bounds)
        return float(metric.compute(state))

    scores = {}
    for name in args.metrics or _default_metrics(args.task_type):
        metric = Factory.build(MetricRegistry[name], n_classes=args.multiclass_num_classes)
        try:
            scores[name] = one(metric, preds_for_metric, Y, mask)
        except Exception as e:  # scoring must never kill a finished run
            logger.warning(f"metric {name} failed: {e}")
            scores[name] = float("nan")
        if args.show_individual_scores and Y.shape[1] > 1:
            for j, col in enumerate(target_cols[: Y.shape[1]]):
                try:
                    p_j = np.asarray(preds_for_metric)[:, j : j + 1]
                    scores[f"{name}_{col}"] = one(metric, p_j, Y[:, j : j + 1], mask[:, j : j + 1])
                except Exception:
                    scores[f"{name}_{col}"] = float("nan")
    return scores


def _default_metrics(task_type: str) -> list[str]:
    if task_type.startswith("regression"):
        return ["rmse", "mae"]
    if task_type.startswith("multiclass"):
        return ["multiclass-mcc"]
    if task_type == "spectral":
        return ["sid"]
    return ["roc"]


def _save_preds(path, test_dset, preds: np.ndarray, target_cols) -> None:
    """``name`` and ``pred_<task>`` per test row (channel 0 of a two- or
    four-channel head, every channel of another, flattened)."""
    if preds.ndim == 3:
        preds = preds[..., 0] if preds.shape[-1] in (2, 4) else preds.reshape(len(preds), -1)
    cols = target_cols if preds.shape[1] == len(target_cols) else range(preds.shape[1])
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", *(f"pred_{c}" for c in cols)])
        for name, row in zip(test_dset.names, preds):
            w.writerow([name, *(str(np.float32(x)) for x in row)])


add_args = add_train_args


class TrainSubcommand(Subcommand):
    """``train`` on the command line: :func:`add_args` and :func:`main`."""

    COMMAND = "train"
    HELP = "train a model from a CSV"
    add_args = staticmethod(add_args)
    func = staticmethod(main)
