"""Uncertainty-driven active learning: start from a small labeled pool,
train, score the unlabeled pool with MC-dropout uncertainty, acquire the most
uncertain molecules, retrain, on the port's command line. The port's twin of
``examples/active_learning.py`` (the reference's
``examples/active_learning.ipynb``), with ``--uncertainty-method dropout``.

Run: python examples_torch/active_learning.py [--device cuda] [--quick]
"""

import csv

import numpy as np

from _common import DATA, epochs, out_dir, parse_args, run_cli


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["smiles", "lipo"])
        w.writerows(rows)


def main(argv=None):
    args = parse_args(__doc__, argv)
    out = out_dir("active_learning")
    all_rows = [
        (r["smiles"], r["lipo"])
        for r in csv.DictReader(open(DATA / "regression" / "mol" / "mol.csv"))
    ]
    labeled, pool, test = all_rows[:20], all_rows[20:80], all_rows[80:]
    n_acquire, n_rounds = 10, 1 if args.quick else 2

    test_csv = out / "test.csv"
    _write_csv(test_csv, test)

    for rnd in range(n_rounds):
        train_csv = out / f"train_r{rnd}.csv"
        pool_csv = out / f"pool_r{rnd}.csv"
        _write_csv(train_csv, labeled)
        _write_csv(pool_csv, pool)
        model_dir = out / f"model_r{rnd}"
        run_cli([
            "train", "-i", train_csv, "--epochs", epochs(3, args.quick), "--batch-size", "16",
            "--split-sizes", "0.9", "0.1", "0.0", "-o", model_dir,
        ], args.device)

        # score the pool: MC-dropout predictive variance per molecule
        pool_preds = out / f"pool_preds_r{rnd}.csv"
        run_cli([
            "predict", "-i", pool_csv,
            "--model-paths", next(model_dir.rglob("best.ckpt")),
            "--uncertainty-method", "dropout",
            "--uncertainty-dropout-p", "0.2", "--dropout-sampling-size", "5",
            "-o", pool_preds,
        ], args.device)
        uncs = np.array(
            [float(r["lipo_unc"]) for r in csv.DictReader(open(pool_preds))]
        )
        assert (uncs > 0).all()

        # acquire the most uncertain molecules into the labeled set
        pick = np.argsort(-uncs)[:n_acquire]
        picked = [pool[i] for i in pick]
        labeled = labeled + picked
        pool = [p for i, p in enumerate(pool) if i not in set(pick.tolist())]
        print(
            f"round {rnd}: labeled {len(labeled) - n_acquire} -> {len(labeled)}, "
            f"max pool uncertainty {uncs.max():.3f}, "
            f"acquired mean uncertainty {uncs[pick].mean():.3f}"
        )

    # held-out check with the final model
    test_preds = out / "test_preds.csv"
    run_cli([
        "predict", "-i", test_csv,
        "--model-paths", next((out / f"model_r{n_rounds - 1}").rglob("best.ckpt")),
        "-o", test_preds,
    ], args.device)
    y = np.array([float(v) for _, v in test])
    yhat = np.array([float(r["lipo"]) for r in csv.DictReader(open(test_preds))])
    rmse = float(np.sqrt(np.mean((y - yhat) ** 2)))
    print(f"held-out RMSE after {n_rounds} acquisition rounds: {rmse:.3f}")
    assert np.isfinite(rmse)


if __name__ == "__main__":
    main()
