"""Multitask regression: 12 QM targets predicted jointly, with a NaN-masked
loss so that partially labeled rows still train, through the port's command
line. The port's twin of ``examples/multi_task.py`` (reference NaN-mask
semantics, ``chemprop/models/model.py:152-153``).

Run: python examples_torch/multi_task.py [--device cuda] [--quick]
"""

import json

from _common import DATA, epochs, head, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("multitask")
    run_cli([
        "train", "-i", head(DATA / "regression" / "mol_multitask.csv", out, args.quick),
        "--epochs", epochs(2, args.quick), "--batch-size", "64", "-o", out,
    ], args.device)
    scores = json.load(open(next(out.rglob("test_scores.json"))))
    print(f"12-task model test scores: {scores[-1]}")


if __name__ == "__main__":
    main()
