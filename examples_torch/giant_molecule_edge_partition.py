"""Train and predict on GIANT molecules with edge-partitioned message passing
on one GPU.

Molecules too large for one batch slice (polymers, peptides) can be cut into
contiguous edge slices, shards of one molecule: every message-passing
iteration exchanges only the boundary (halo) rows between neighbouring
shards while the bulk segment sums and products stay local, and the
gradients are exact against the single-shard model. The port's twin of
``examples/giant_molecule_edge_partition.py``: where the JAX script spreads
the shards over a virtual 8-device mesh, this one runs ``train`` and
``predict --edge-partition 4``, four shards on the one card, their halo sums
and gathers through the port's segment-sum and row-gather kernels.

The saved checkpoint is a standard MPNN checkpoint: a plain ``predict`` loads
it, and ``predict`` / ``fingerprint`` accept ``--edge-partition`` too.

Run: python examples_torch/giant_molecule_edge_partition.py [--device cuda] [--quick]
"""

import csv

from _common import epochs, out_dir, parse_args, run_cli

SHARDS = "4"


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("edge_partition")

    # a tiny dataset of linked-cyclohexane polymers (~240-290 heavy atoms
    # each, >1600 directed edges, larger than the message kernels' widest
    # single-molecule window) plus small molecules to show mixed routing
    data_csv = out / "giant.csv"
    rows = [["smiles", "logS"]]
    for k in range(6):
        rows.append(["C1(CCCCC1)" * (40 + 4 * k), f"{0.1 * k:.2f}"])
    for k in range(6):
        rows.append(["C1(CCCCC1)" * 3, f"{0.3 + 0.1 * k:.2f}"])
    with open(data_csv, "w", newline="") as f:
        csv.writer(f).writerows(rows)

    # --edge-partition N: giant molecules are cut into N shards, the small
    # ones route through the dense batched step in the same run
    run_cli([
        "train", "-i", data_csv, "--edge-partition", SHARDS,
        "--epochs", epochs(4, args.quick), "--patience", "3",
        "--message-hidden-dim", "64", "--ffn-hidden-dim", "64",
        "--split-sizes", "0.5", "0.25", "0.25",
        "-o", out / "model",
    ], args.device)

    # partitioned inference with the trained checkpoint (dense predict on
    # the same checkpoint gives matching numbers)
    run_cli([
        "predict", "-i", data_csv,
        "--model-paths", out / "model" / "best.ckpt",
        "--edge-partition", SHARDS, "-o", out / "preds.csv",
    ], args.device)
    preds = list(csv.DictReader(open(out / "preds.csv")))
    print(f"predicted {len(preds)} molecules; first: {preds[0]['logS']}")


if __name__ == "__main__":
    main()
