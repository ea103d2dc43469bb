"""Prediction uncertainty: an MVE head (mean + learned variance) trained end
to end, plus Monte-Carlo dropout on a plain regression model, through the
port's command line. The port's twin of ``examples/uncertainty.py``
(reference ``chemprop/uncertainty/estimator.py``).

Run: python examples_torch/uncertainty.py [--device cuda] [--quick]
"""

import csv

import numpy as np

from _common import DATA, epochs, head, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("uncertainty")
    mol_csv = head(DATA / "regression" / "mol" / "mol.csv", out, args.quick)

    # 1) mean-variance estimation: the head predicts (mean, var) per task
    run_cli([
        "train", "-i", mol_csv, "--task-type", "regression-mve",
        "--epochs", epochs(2, args.quick), "--batch-size", "64", "-o", out / "mve",
    ], args.device)
    preds = out / "mve_preds.csv"
    run_cli([
        "predict", "-i", mol_csv, "--model-paths", out / "mve",
        "--uncertainty-method", "mve", "-o", preds,
    ], args.device)
    rows = list(csv.DictReader(open(preds)))
    unc_col = next(c for c in rows[0] if c.endswith("_unc"))
    uncs = np.asarray([float(r[unc_col]) for r in rows])
    print(f"MVE: {len(rows)} predictions, mean predicted variance {uncs.mean():.3f}")
    assert (uncs >= 0).all()

    # 2) MC-dropout on a plain regression model: stochastic forward passes
    run_cli([
        "train", "-i", mol_csv, "--epochs", epochs(2, args.quick), "--batch-size", "64",
        "-o", out / "plain",
    ], args.device)
    preds2 = out / "dropout_preds.csv"
    run_cli([
        "predict", "-i", mol_csv, "--model-paths", out / "plain",
        "--uncertainty-method", "dropout",
        "--uncertainty-dropout-p", "0.2", "--dropout-sampling-size", "5",
        "-o", preds2,
    ], args.device)
    rows2 = list(csv.DictReader(open(preds2)))
    unc2 = np.asarray([float(r[unc_col]) for r in rows2])
    print(f"MC-dropout: mean sample variance {unc2.mean():.4f}")
    assert (unc2 > 0).all()


if __name__ == "__main__":
    main()
