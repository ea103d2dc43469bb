"""Transfer learning: warm-start from a trained checkpoint and fine-tune only
the head with the encoder frozen, through the port's command line. The
port's twin of ``examples/transfer_learning.py`` (reference ``--checkpoint``
+ ``--freeze-encoder``, ``cli/train.py:1826-1833``).

Run: python examples_torch/transfer_learning.py [--device cuda] [--quick]
"""

import json

from _common import DATA, epochs, head, out_dir, parse_args, run_cli


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("transfer")
    mol_csv = head(DATA / "regression" / "mol" / "mol.csv", out, args.quick)
    # pretrain
    run_cli([
        "train", "-i", mol_csv, "--epochs", epochs(3, args.quick), "--batch-size", "64",
        "-o", out / "pretrain",
    ], args.device)
    # fine-tune the head only, encoder frozen
    run_cli([
        "train", "-i", mol_csv,
        "--checkpoint", next((out / "pretrain").rglob("best.ckpt")),
        "--freeze-encoder",
        "--epochs", epochs(2, args.quick), "--batch-size", "64", "-o", out / "finetune",
    ], args.device)
    scores = json.load(open(next((out / "finetune").rglob("test_scores.json"))))
    print(f"fine-tuned (frozen encoder) test scores: {scores[-1]}")


if __name__ == "__main__":
    main()
