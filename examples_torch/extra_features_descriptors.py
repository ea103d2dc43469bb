"""Condition a model on extra molecule-level descriptors: the full 217-value
RDKit ``Descriptors.descList`` vector (``rdkit_2d``), Morgan fingerprints, or
net charge, computed by the port's own chemistry. The port's twin of
``examples/extra_features_descriptors.py`` (reference
``chemprop/featurizers/molecule.py:15-106``).

Run: python examples_torch/extra_features_descriptors.py [--device cuda] [--quick]
"""

import csv

import numpy as np

from _common import DATA, epochs, head, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("descriptors")
    mol_csv = head(DATA / "regression" / "mol" / "mol.csv", out, args.quick)
    run_cli([
        "train", "-i", mol_csv, "--molecule-featurizers", "rdkit_2d",
        "--epochs", epochs(2, args.quick), "--batch-size", "64", "-o", out,
    ], args.device)
    preds = out / "preds.csv"
    run_cli([
        "predict", "-i", mol_csv, "--molecule-featurizers", "rdkit_2d",
        "--model-paths", out, "-o", preds,
    ], args.device)
    rows = list(csv.DictReader(open(preds)))
    print(f"217-descriptor-conditioned model predicted {len(rows)} molecules")
    assert np.isfinite([float(r["lipo"]) for r in rows]).all()

    # the descriptor vectors themselves, from the library API
    from chemprop_tpu_torch.chem import make_mol
    from chemprop_tpu_torch.featurizers.molecule import MoleculeFeaturizerRegistry

    mol = make_mol("CC(=O)Oc1ccccc1C(=O)O")  # aspirin
    for name in ("rdkit_2d", "morgan_binary", "charge"):
        f = MoleculeFeaturizerRegistry[name]()
        x = f(mol)
        print(f"  {name}: {len(f)} values, {int(np.count_nonzero(x))} nonzero")


if __name__ == "__main__":
    main()
