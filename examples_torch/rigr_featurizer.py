"""Train with the RIGR resonance-invariant featurizer: atoms and bonds that
differ only by resonance structure featurize identically. The port's twin of
``examples/rigr_featurizer.py`` (reference ``chemprop/featurizers/atom.py:204``
RIGRAtomFeaturizer).

Run: python examples_torch/rigr_featurizer.py [--device cuda] [--quick]
"""

import json

import numpy as np

from _common import DATA, epochs, head, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("rigr")
    run_cli([
        "train", "-i", head(DATA / "regression" / "mol" / "mol.csv", out, args.quick),
        "--multi-hot-atom-featurizer-mode", "rigr",
        "--epochs", epochs(2, args.quick), "--batch-size", "64", "-o", out,
    ], args.device)
    scores = json.load(open(next(out.rglob("test_scores.json"))))
    print(f"RIGR-featurized test scores: {scores[-1]}")

    # the two kekule forms of an amidinium featurize identically under RIGR
    from chemprop_tpu_torch.chem import make_mol
    from chemprop_tpu_torch.featurizers.atom import get_multi_hot_atom_featurizer

    f = get_multi_hot_atom_featurizer("rigr")
    ma, mb = make_mol("C(N)=[NH2+]"), make_mol("C(=N)[NH3+]")
    same = np.array_equal(f.featurize(ma, ma.atoms[0]), f.featurize(mb, mb.atoms[0]))
    print("resonance-invariant central carbon:", same)


if __name__ == "__main__":
    main()
