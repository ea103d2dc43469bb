"""Extract learned fingerprints (hidden encodings) from a trained model
through the port's ``fingerprint`` subcommand. The port's twin of
``examples/mpnn_fingerprints.py`` (reference
``chemprop/models/model.py:136-140``).

Run: python examples_torch/mpnn_fingerprints.py [--device cuda] [--quick]
"""

import csv

import numpy as np

from _common import DATA, epochs, head, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("fingerprints")
    mol_csv = head(DATA / "regression" / "mol" / "mol.csv", out, args.quick)
    run_cli([
        "train", "-i", mol_csv, "--epochs", epochs(2, args.quick), "--batch-size", "64",
        "-o", out,
    ], args.device)
    fps_csv = out / "fps.csv"
    run_cli([
        "fingerprint", "-i", mol_csv, "--model-paths", out, "-o", fps_csv,
    ], args.device)
    rows = list(csv.reader(open(fps_csv)))
    n_fp = len(rows[1]) - 1  # minus the name column
    print(f"{len(rows) - 1} molecules x {n_fp}-dim learned fingerprints")
    assert n_fp >= 300
    assert np.isfinite(np.asarray(rows[1][1:], float)).all()


if __name__ == "__main__":
    main()
