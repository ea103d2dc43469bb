"""The command line's multi-GPU flags against the JAX CLI's, on the CPU:

* ``train --edge-partition 2`` on 30 rows of mol.csv plus two giant
  molecules (``"C1(CCCCC1)" * 180`` and ``* 120``): the JAX CLI's splits,
  routing (dim buckets and dense-path molecules), files and history keys;
  the run's own initial parameters differ (each package draws its own), so
  its test predictions are held against the JAX CLI's dense ``predict`` of
  the port's ``best.ckpt``;
* ``predict --edge-partition 2`` (an ensemble of two, with z-scaling
  calibration on the CSV itself) and ``fingerprint --edge-partition 2`` of
  that checkpoint, against the JAX CLI's on the same files;
* ``torchrun --nproc-per-node 2 -m chemprop_tpu_torch.cli train --devices 2
  --device cpu`` (two gloo ranks, batch norm) against the same run in one
  process: the same splits, every epoch's losses and the test predictions.

Each run of several processes has its own time limit. Small size: d_h 48."""

from __future__ import annotations

import csv
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu_torch.cli.main import main as port_main

REPO = Path(__file__).resolve().parent.parent
GIANTS = ["C1(CCCCC1)" * 180, "C1(CCCCC1)" * 120]
SMALL = ["--message-hidden-dim", "48", "--ffn-hidden-dim", "32", "--split-sizes", "0.8", "0.1",
         "0.1", "--data-seed", "1"]
TORCHRUN_LIMIT_S = 180
# f32 on both sides, partitioned sums against dense ones in other orders
PRED_TOL = 1e-4


@pytest.fixture(scope="module")
def giant_csv(data_dir, tmp_path_factory):
    rows = list(csv.reader(open(data_dir / "regression" / "mol" / "mol.csv")))
    path = tmp_path_factory.mktemp("giant") / "giant.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(rows[0])
        w.writerows(rows[1:31])
        w.writerows([[GIANTS[0], "1.5"], [GIANTS[1], "0.5"]])
    return path


@pytest.fixture(scope="module")
def runs(giant_csv, tmp_path_factory):
    """One ``train --edge-partition 2`` of each package."""
    root = tmp_path_factory.mktemp("ep_train")
    flags = ["train", "-i", str(giant_csv), "--epochs", "2", "--edge-partition", "2", *SMALL]
    assert port_main(flags + ["-o", str(root / "port"), "--device", "cpu"]) == 0
    assert jax_main(flags + ["-o", str(root / "jax")]) == 0
    return root / "port", root / "jax"


def _table(path: Path):
    rows = list(csv.reader(open(path)))
    return rows[0], [r[0] for r in rows[1:]], np.array([[float(x) for x in r[1:]]
                                                        for r in rows[1:]])


def test_train_edge_partition_matches_jax(runs, giant_csv, tmp_path):
    port, jax_dir = runs
    assert sorted(p.name for p in port.iterdir()) == sorted(p.name for p in jax_dir.iterdir())
    assert json.loads((port / "splits.json").read_text()) == json.loads(
        (jax_dir / "splits.json").read_text())
    hp, hj = (json.loads((d / "history.json").read_text()) for d in (port, jax_dir))
    assert [sorted(r) for r in hp] == [sorted(r) for r in hj] and len(hp) == 2
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in hp)
    assert set(json.loads((port / "test_scores.json").read_text())[0]) == {"rmse", "mae"}
    # the port's checkpoint in the JAX CLI's dense predict: its partitioned
    # test predictions (a giant molecule is in the test split)
    header, names, got = _table(port / "test_predictions.csv")
    assert GIANTS[1] in names
    test_csv = tmp_path / "test.csv"
    split = json.loads((port / "splits.json").read_text())[0]["test"]
    rows = list(csv.reader(open(giant_csv)))
    with open(test_csv, "w", newline="") as f:
        csv.writer(f).writerows([rows[0]] + [rows[1 + i] for i in split])
    assert jax_main(["predict", "-i", str(test_csv), "--model-paths", str(port / "best.ckpt"),
                     "-o", str(tmp_path / "jax_dense.csv")]) == 0
    _, jnames, want = _table(tmp_path / "jax_dense.csv")
    assert jnames == names
    np.testing.assert_allclose(got, want, rtol=PRED_TOL, atol=PRED_TOL)


def test_train_routes_like_jax(giant_csv, tmp_path, capsys):
    """The routing log line: the same buckets and dense-path molecules."""
    import re

    flags = ["train", "-i", str(giant_csv), "--epochs", "1", "--edge-partition", "2", *SMALL]
    port_main(flags + ["-o", str(tmp_path / "p"), "--device", "cpu"])
    port_log = capsys.readouterr().err
    jax_main(flags + ["-o", str(tmp_path / "j")])
    jax_log = capsys.readouterr().err

    def routing(log):
        return re.search(r"over 2 \w+: (\d+ dim bucket.*)$", log, re.M).group(1)

    assert routing(port_log) == routing(jax_log)


@pytest.mark.parametrize("sub", ["predict", "fingerprint"])
def test_predict_and_fingerprint_edge_partition_match_jax(runs, giant_csv, tmp_path, sub, capsys):
    port, _ = runs
    ckpt = str(port / "best.ckpt")
    flags = [sub, "-i", str(giant_csv), "--edge-partition", "2"]
    if sub == "predict":
        flags += ["--model-paths", ckpt, ckpt, "--uncertainty-method", "ensemble",
                  "--calibration-method", "zscaling", "--cal-path", str(giant_csv)]
    else:
        flags += ["--model-paths", ckpt, "--ffn-block-index", "1"]
    assert port_main(flags + ["-o", str(tmp_path / "port.csv"), "--device", "cpu"]) == 0
    assert jax_main(flags + ["-o", str(tmp_path / "jax.csv")]) == 0
    hp, np_, got = _table(tmp_path / "port.csv")
    hj, nj, want = _table(tmp_path / "jax.csv")
    assert hp == hj and np_ == nj and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=PRED_TOL, atol=PRED_TOL)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_torchrun_devices_2_matches_one_process(data_dir, tmp_path):
    """Two gloo ranks under torchrun against one process: the sharded step
    is the single-device step up to summation order."""
    flags = ["-m", "chemprop_tpu_torch.cli", "train", "-i",
             str(data_dir / "regression" / "mol" / "mol.csv"), "--epochs", "2", "--batch-norm",
             "-b", "32", "--device", "cpu", *SMALL]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    one = subprocess.run([sys.executable, *flags, "-o", str(tmp_path / "one")], env=env,
                         capture_output=True, text=True, timeout=TORCHRUN_LIMIT_S, cwd=REPO)
    assert one.returncode == 0, one.stderr[-3000:]
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--nnodes", "1",
         "--master-addr", "localhost", "--master-port", str(_free_port()), *flags,
         "-o", str(tmp_path / "two"), "--devices", "2"],
        env=env, capture_output=True, text=True, timeout=TORCHRUN_LIMIT_S, cwd=REPO)
    assert two.returncode == 0, two.stderr[-3000:]
    a, b = tmp_path / "one", tmp_path / "two"
    assert json.loads((a / "splits.json").read_text()) == json.loads(
        (b / "splits.json").read_text())
    ha, hb = (json.loads((d / "history.json").read_text()) for d in (a, b))
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose([r[key] for r in hb], [r[key] for r in ha], rtol=1e-4)
    _, na, pa = _table(a / "test_predictions.csv")
    _, nb, pb = _table(b / "test_predictions.csv")
    assert na == nb
    np.testing.assert_allclose(pb, pa, rtol=1e-3, atol=1e-4)
    assert json.loads((b / "config.json").read_text())["devices"] == "2"
