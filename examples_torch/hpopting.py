"""Hyperparameter optimization: a random search over model hyperparameters,
the best configuration re-trained through ``--config-path``, on the port's
command line. The port's twin of ``examples/hpopting.py`` (reference
``chemprop hpopt``, ``cli/hpopt.py:440-533``).

Run: python examples_torch/hpopting.py [--device cuda] [--quick]
"""

import json

from _common import DATA, epochs, head, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("hpopt")
    mol_csv = head(DATA / "regression" / "mol" / "mol.csv", out, args.quick)
    run_cli([
        "hpopt", "-i", mol_csv, "--epochs", epochs(2, args.quick),
        "--num-trials", "2" if args.quick else "3",
        "--batch-size", "16",
        "--search-parameter-keywords", "depth", "ffn_num_layers",
        "--hpopt-save-dir", out,
    ], args.device)
    best_path = next(out.rglob("best_config.json"))
    best = json.load(open(best_path))
    print(f"best config: {best}")

    # retrain with the winning hyperparameters
    run_cli([
        "train", "-i", mol_csv, "--config-path", best_path,
        "--epochs", epochs(2, args.quick), "--batch-size", "16", "-o", out / "retrain",
    ], args.device)
    scores = json.load(open(next((out / "retrain").rglob("test_scores.json"))))
    print(f"retrained test scores: {scores[-1]}")


if __name__ == "__main__":
    main()
