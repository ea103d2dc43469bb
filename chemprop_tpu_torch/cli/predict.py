"""``predict``: SMILES in a CSV -> predictions in a CSV (cf.
``chemprop_tpu/cli/predict.py``), for one checkpoint of any head: a reference
``.pt``/``.ckpt`` or a ``CPTPU001`` file of the JAX package or of the port's
``Trainer``, told apart by its magic bytes. A model that takes extra inputs
(descriptors, extra atom or bond features) is refused: the options that read
them are not ported yet.

    python -m chemprop_tpu_torch.cli predict --model-path X.pt -i in.csv -o out.csv \\
        [--device cpu] [--dtype float32|bfloat16] [--batch-size N]

The output has the JAX CLI's columns: ``name`` (the SMILES), then for each
task, named by the checkpoint's output columns or ``pred_<j>``, its point
value (channel 0 of an MVE, evidential, quantile or Dirichlet head); a
multiclass head writes the task's class label and ``<task>_prob``, its class
probabilities as ``%.6f`` joined by commas (a Dirichlet head's uncertainty
left out). Uncertainty columns are not ported yet. With no ``--device`` it
runs on the GPU, and raises where there is none."""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import torch

from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.cli.common import DTYPES, add_device_args
from chemprop_tpu_torch.data.collate import batch_mol_graphs
from chemprop_tpu_torch.featurizers.molgraph import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.models.load import load_model
from chemprop_tpu_torch.models.model import MPNN
from chemprop_tpu_torch.nn.predictors import MulticlassClassificationFFN, MulticlassDirichletFFN
from chemprop_tpu_torch.utils.device import resolve_device



def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--model-path", type=Path, required=True,
                        help="reference .pt/.ckpt, or a CPTPU001 checkpoint")
    parser.add_argument("-i", "--data-path", type=Path, required=True, help="input CSV")
    parser.add_argument("-o", "--output", type=Path, help="output CSV (default <input>_preds.csv)")
    add_device_args(parser)
    parser.add_argument("-b", "--batch-size", type=int, default=64)
    return parser


def read_smiles(path: Path) -> list[str]:
    """The first column of a CSV with a header row."""
    with open(path, newline="") as f:
        return [row[0] for row in list(csv.reader(f))[1:]]


def predict(
    model: MPNN, smiles: list[str], device: torch.device, batch_size: int = 64
) -> np.ndarray:
    """``[len(smiles), n_tasks(, k)]`` float32 predictions."""
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
    """Raise where ``model`` takes more than ``featurizer``'s graphs."""
    mp = model.message_passing
    if (mp.d_vd or model.predictor.input_dim != mp.output_dim
            or (mp.d_v, mp.d_e) != featurizer.shape):
        raise ValueError("the model takes extra inputs (descriptors or extra atom or bond "
                         "features), which predict and serve do not read yet")


def main(args: argparse.Namespace) -> int:
    device = resolve_device(args.device)
    model, output_columns = load_model(args.model_path, device, DTYPES[args.dtype])
    smiles = read_smiles(args.data_path)
    preds = predict(model, smiles, device, args.batch_size)
    header, rows = columns(model, preds, output_columns)
    out = args.output or args.data_path.with_name(args.data_path.stem + "_preds.csv")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", *header])
        for smi, row in zip(smiles, rows):
            w.writerow([smi, *row])
    print(f"wrote {out}")
    return 0


def columns(
    model: MPNN, preds: np.ndarray, output_columns: list[str] | None
) -> tuple[list[str], list[list[str]]]:
    """The JAX CLI's prediction columns for ``model``'s head: its header and
    each row's cells."""
    pred = model.predictor
    if isinstance(pred, MulticlassClassificationFFN):
        probs = preds[..., :-1] if isinstance(pred, MulticlassDirichletFFN) else preds
        labels = probs.argmax(axis=-1)
        cols = (output_columns or [f"pred_{j}" for j in range(labels.shape[1])])[: labels.shape[1]]
        header = [name for c in cols for name in (c, f"{c}_prob")]
        rows = [[cell for j in range(len(cols))
                 for cell in (str(int(lab[j])), ",".join(f"{p:.6f}" for p in prob[j]))]
                for lab, prob in zip(labels, probs)]
        return header, rows
    point = preds[..., 0] if preds.ndim == 3 else preds
    cols = (output_columns or [f"pred_{j}" for j in range(point.shape[1])])[: point.shape[1]]
    return cols, [[repr(float(x)) for x in row[: len(cols)]] for row in point]
