"""``fingerprint``: SMILES in a CSV -> the learned representations of
trained models (cf. ``chemprop_tpu/cli/fingerprint.py``).

    python -m chemprop_tpu_torch.cli fingerprint -i in.csv -o fps.csv \\
        --model-paths A.pt [B.ckpt ...] [--ffn-block-index -1] [--device cpu] ...

Each model's ``MPNN.encoding``: the fingerprint through its FFN's blocks
``[:i]`` for ``--ffn-block-index i`` (``-1``, the default: all but the last;
``0``: the fingerprint itself). The input options and extra inputs are
``predict``'s (several SMILES columns, reaction columns, the molecule
featurizers), and so are the featurizer mode's switch and the component
order's fix to fit the first model. The output is a CSV of ``name`` and
``fp_0``, ``fp_1``, ..., or with an ``.npz`` suffix one array ``fps``; with
several models, one file for each,
``<output>_model_<k>``. A mol-atom-bond model writes one ``.npz`` of its
fingerprints by kind (``cli.mab.fingerprint_MAB``). ``--edge-partition
[N]`` encodes each molecule a plan over N shards takes with its edge table
cut across them, the others on the dense path, one plan for the ensemble
(``parallel.partitioned_mp.PartitionedInference``); a mol-atom-bond model
is refused there, as in the JAX CLI. The inputs ``predict`` refuses are
refused (``predict.INPUT_REFUSED``)."""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import torch

from chemprop_tpu_torch.cli.common import DTYPES, add_common_args, find_models
from chemprop_tpu_torch.cli.predict import (
    INPUT_REFUSED, build_loader, match_featurizer, refuse_unported,
)
from chemprop_tpu_torch.cli.mab import fingerprint_MAB
from chemprop_tpu_torch.cli.utils.command import Subcommand
from chemprop_tpu_torch.models.load import load_model
from chemprop_tpu_torch.models.mol_atom_bond import MolAtomBondMPNN
from chemprop_tpu_torch.train.trainer import _restore_order
from chemprop_tpu_torch.utils.device import resolve_device


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    add_common_args(parser)
    g = parser.add_argument_group("Fingerprint args")
    g.add_argument("-o", "--output", type=Path, default=None,
                   help="output .csv or .npz (default <input>_fingerprint.csv)")
    g.add_argument("--model-paths", "--model-path", nargs="+", type=Path, required=True)
    g.add_argument("--ffn-block-index", type=int, default=-1,
                   help="use the predictor FFN's blocks [:i] on top of the fingerprint")
    g.add_argument("--edge-partition", type=int, nargs="?", const=0, default=None, metavar="N",
                   help="edge-partitioned fingerprinting over N shards (N local shards, or "
                   "one per rank under torchrun; 0/omitted: the world size)")
    return parser


def encodings(model, loader, device: torch.device, i: int) -> np.ndarray:
    """``[n, width]`` float32 encodings over ``loader`` in dataset order."""
    chunks = []
    with torch.inference_mode():
        for host in loader:
            b = host.to(device)
            enc = model.encoding(b.bmg, b.V_d, b.X_d, i)
            chunks.append(enc.float().cpu().numpy()[host.pad_mask])
    return _restore_order(np.concatenate(chunks, 0), loader)


def main(args: argparse.Namespace) -> int:
    refuse_unported(args, INPUT_REFUSED)
    device = resolve_device(args.device)  # raises where there is no GPU
    model_paths = find_models(args.model_paths)
    models = [load_model(p, device, DTYPES[args.dtype])[0] for p in model_paths]
    if isinstance(models[0], MolAtomBondMPNN):
        if args.edge_partition is not None:
            raise ValueError("--edge-partition fingerprint does not support MAB models")
        return fingerprint_MAB(args, models, device)
    if not (args.atom_features_path or args.bond_features_path):
        match_featurizer(args, models[0])
    loader, dset, _ = build_loader(args, args.data_path, model=models[0])
    session = None
    if args.edge_partition is not None:
        from chemprop_tpu_torch.parallel.partitioned_mp import PartitionedInference

        session = PartitionedInference(models[0], [dset[i] for i in range(len(dset))],
                                       n_shards=args.edge_partition or None,
                                       encode_index=args.ffn_block_index, device=device)
    for k, model in enumerate(models):
        fps = (session.run(model) if session is not None
               else encodings(model, loader, device, args.ffn_block_index))
        out = args.output or args.data_path.with_name(args.data_path.stem + "_fingerprint.csv")
        if len(models) > 1:
            out = out.with_name(f"{out.stem}_model_{k}{out.suffix}")
        out.parent.mkdir(parents=True, exist_ok=True)
        if out.suffix == ".npz":
            np.savez(out, fps=fps)
        else:
            with open(out, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["name", *(f"fp_{i}" for i in range(fps.shape[1]))])
                for name, row in zip(dset.names, fps):
                    w.writerow([name, *(repr(float(x)) for x in row)])
        print(f"wrote {out} {fps.shape}")
    return 0


add_fingerprint_args = add_args  # the JAX package's name


class FingerprintSubcommand(Subcommand):
    """``fingerprint`` on the command line: :func:`add_args` and :func:`main`."""

    COMMAND = "fingerprint"
    HELP = "compute the learned representations of trained models"
    add_args = staticmethod(add_args)
    func = staticmethod(main)
