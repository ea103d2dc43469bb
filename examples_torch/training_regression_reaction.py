"""Train on reaction SMILES with the Condensed Graph of Reaction (CGR)
featurizer and predict activation energies, through the port's command line.
The port's twin of ``examples/training_regression_reaction.py`` (reference
``chemprop/featurizers/molgraph/reaction.py:45``).

Run: python examples_torch/training_regression_reaction.py [--device cuda] [--quick]
"""

import csv

import numpy as np

from _common import DATA, epochs, head, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("reaction")
    csv_in = head(DATA / "regression" / "rxn" / "rxn.csv", out, args.quick)
    run_cli([
        "train", "-i", csv_in, "--reaction-columns", "smiles",
        "--target-columns", "ea",
        "--epochs", epochs(2, args.quick), "--batch-size", "16", "-o", out,
    ], args.device)
    preds = out / "preds.csv"
    run_cli([
        "predict", "-i", csv_in, "--reaction-columns", "smiles",
        "--model-paths", out, "-o", preds,
    ], args.device)
    rows = list(csv.DictReader(open(preds)))
    vals = [float(r["ea"]) for r in rows]
    print(f"predicted ea for {len(rows)} reactions, mean {np.mean(vals):.2f}")
    assert np.isfinite(vals).all()


if __name__ == "__main__":
    main()
