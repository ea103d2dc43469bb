"""Import a reference (PyTorch) chemprop checkpoint and predict with it on
the GPU. The port's twin of ``examples/convert_reference_checkpoint.py``
(``examples/convert_v1_to_v2.ipynb`` and the reference ``chemprop convert``
subcommand, ``cli/convert.py:13``): both v1 and v2 checkpoints convert to the
``CPTPU001`` format, which the port and the JAX package both read.

Run: python examples_torch/convert_reference_checkpoint.py [--device cuda] [--quick]
"""

import csv

import numpy as np

from _common import DATA, head, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("convert")
    ckpt = out / "regression_mol.ckpt"
    run_cli([
        "convert", "-i", DATA / "example_model_v2_regression_mol.pt", "-o", ckpt,
    ], None)  # convert reads and writes files: no device
    preds = out / "preds.csv"
    run_cli([
        "predict", "-i", head(DATA / "smis.csv", out, args.quick), "--model-paths", ckpt,
        "-o", preds,
    ], args.device)
    rows = list(csv.DictReader(open(preds)))
    col = [c for c in rows[0] if c != "name"][0]
    vals = [float(r[col]) for r in rows]
    print(f"reference checkpoint predicted {len(vals)} molecules, mean {np.mean(vals):.3f}")
    assert np.isfinite(vals).all()

    # a v1-era checkpoint converts the same way
    ckpt_v1 = out / "regression_mol_v1.ckpt"
    run_cli([
        "convert", "-i", DATA / "example_model_v1_regression_mol.pt", "-o", ckpt_v1,
    ], None)
    print(f"v1 checkpoint converted to {ckpt_v1.name}")


if __name__ == "__main__":
    main()
