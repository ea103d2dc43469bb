"""Train a binary classifier (Tox21-style NR-AhR) through the port's command
line and check the held-out AUC. The port's twin of
``examples/training_classification.py`` (reference classification defaults:
BCE loss, ROC-AUC metric).

Run: python examples_torch/training_classification.py [--device cuda] [--quick]
"""

import json

from _common import DATA, epochs, head, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("classification")
    run_cli([
        "train", "-i", head(DATA / "classification" / "mol.csv", out, args.quick, 40),
        "--task-type", "classification", "--metrics", "roc",
        "--epochs", epochs(3, args.quick), "--batch-size", "64", "-o", out,
    ], args.device)
    scores = json.load(open(next(out.rglob("test_scores.json"))))
    auc = list(scores[-1].values())[0]
    print(f"test AUC after {epochs(3, args.quick)} epochs: {auc:.3f}")
    assert 0.0 <= auc <= 1.0


if __name__ == "__main__":
    main()
