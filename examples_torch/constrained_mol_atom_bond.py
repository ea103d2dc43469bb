"""Constrained atom/bond property prediction: per-atom (and per-bond)
predictions whose molecular sums are pinned to known totals. The
ConstrainerFFN redistributes ``constraint - sum(preds)`` over the atoms with
learned softmax weights, so that conservation laws (total charge, molecular
mass, ...) hold exactly at inference. The port's twin of
``examples/constrained_mol_atom_bond.py`` (reference ``chemprop/nn/ffn.py:72``
ConstrainerFFN).

Run: python examples_torch/constrained_mol_atom_bond.py [--device cuda] [--quick]
"""

import ast
import csv

import numpy as np

from _common import DATA, epochs, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("constrained_mab")
    mab = DATA / "mol_atom_bond"
    train_csv = mab / "constrained_regression.csv"
    constraints_csv = mab / "constrained_regression_constraints.csv"

    # the constraints CSV has one row per molecule; its column names
    # (atom_y1_constraint, ...) map each constraint to a target
    run_cli([
        "train", "-i", train_csv,
        "--target-columns", "mol_y",
        "--atom-target-columns", "atom_y1", "atom_y2",
        "--bond-target-columns", "bond_y1", "bond_y2",
        "--constraints-path", constraints_csv,
        "--keep-h", "--epochs", epochs(2, args.quick), "--batch-size", "8", "-o", out,
    ], args.device)

    preds = out / "preds.csv"
    run_cli([
        "predict", "-i", train_csv, "--keep-h",
        "--constraints-path", constraints_csv,
        "--constraints-to-targets", "atom_y1", "atom_y2", "bond_y2",
        "--model-paths", next(out.rglob("best.ckpt")), "-o", preds,
    ], args.device)

    rows = list(csv.DictReader(open(preds)))
    cons = list(csv.DictReader(open(constraints_csv)))
    # the per-atom predictions for a constrained target sum EXACTLY to the
    # molecule's constraint (here atom_y2's constraint is the molecular mass)
    for row, con in list(zip(rows, cons))[:5]:
        atom_preds = np.asarray(ast.literal_eval(row["atom_y2"]), float)
        target_sum = float(con["atom_y2_constraint"])
        print(
            f"{row['smiles']:>12}  sum(atom_y2 preds) = {atom_preds.sum():.4f}"
            f"  constraint = {target_sum:.4f}"
        )
        np.testing.assert_allclose(atom_preds.sum(), target_sum, rtol=1e-3, atol=1e-3)


if __name__ == "__main__":
    main()
