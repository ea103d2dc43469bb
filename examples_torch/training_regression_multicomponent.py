"""Multicomponent regression: solute + solvent SMILES columns, one message
passing block per component, concatenated embeddings into one head, through
the port's command line. The port's twin of
``examples/training_regression_multicomponent.py`` (reference
``chemprop/models/multi.py:16``).

Run: python examples_torch/training_regression_multicomponent.py [--device cuda] [--quick]
"""

import csv

import numpy as np

from _common import DATA, epochs, head, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("multicomponent")
    csv_in = head(DATA / "regression" / "mol+mol" / "mol+mol.csv", out, args.quick)
    run_cli([
        "train", "-i", csv_in,
        "--smiles-columns", "smiles", "solvent",
        "--target-columns", "peakwavs_max",
        "--epochs", epochs(2, args.quick), "--batch-size", "16", "-o", out,
    ], args.device)
    preds = out / "preds.csv"
    run_cli([
        "predict", "-i", csv_in,
        "--smiles-columns", "smiles", "solvent",
        "--model-paths", out, "-o", preds,
    ], args.device)
    rows = list(csv.DictReader(open(preds)))
    print(f"predicted peak wavelengths for {len(rows)} solute/solvent pairs")
    assert np.isfinite([float(r["peakwavs_max"]) for r in rows]).all()


if __name__ == "__main__":
    main()
