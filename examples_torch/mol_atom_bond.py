"""Triple-head MolAtomBond training: molecule-, atom- and bond-level targets
predicted jointly from one message-passing trunk, through the port's command
line. The port's twin of ``examples/mol_atom_bond.py`` (reference
``chemprop/models/mol_atom_bond.py:21``).

Run: python examples_torch/mol_atom_bond.py [--device cuda] [--quick]
"""

import ast
import csv

import numpy as np

from _common import DATA, epochs, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("mol_atom_bond")
    csv_in = DATA / "mol_atom_bond" / "regression.csv"
    run_cli([
        "train", "-i", csv_in,
        "--mol-target-columns", "mol_y1", "mol_y2",
        "--atom-target-columns", "atom_y1", "atom_y2",
        "--bond-target-columns", "bond_y1", "bond_y2",
        "--keep-h",
        "--epochs", epochs(2, args.quick), "--batch-size", "8", "-o", out,
    ], args.device)
    preds = out / "preds.csv"
    run_cli([
        "predict", "-i", csv_in, "--keep-h",
        "--model-paths", next(out.rglob("best.ckpt")), "-o", preds,
    ], args.device)
    rows = list(csv.DictReader(open(preds)))
    # per-atom predictions come back as list-valued cells, in input order
    atom_col = next(c for c in rows[0] if c.startswith("atom_"))
    first = ast.literal_eval(rows[0][atom_col])
    print(f"{len(rows)} molecules; first molecule has {len(first)} per-atom predictions")
    assert np.isfinite(np.asarray(first, float)).all()


if __name__ == "__main__":
    main()
