"""The port's command line on the CPU, and what its entry points do where
there is no GPU."""

from __future__ import annotations

import csv

import numpy as np
import pytest
import torch

from chemprop_tpu.data import MoleculeDatapoint
from chemprop_tpu.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.models.torch_convert import convert_model
from chemprop_tpu_torch.cli.main import main
from chemprop_tpu_torch.models import load_model
from chemprop_tpu_torch.utils import resolve_device

CKPT = "example_model_v2_regression_mol.pt"


def _jax_preds(path, smis, batch_size=64):
    model, variables, _ = convert_model(path)
    feat = SimpleMoleculeMolGraphFeaturizer()
    out = []
    for i in range(0, len(smis), batch_size):
        mgs = [feat(MoleculeDatapoint.from_smi(s).mol) for s in smis[i : i + batch_size]]
        bmg = batch_mol_graphs(mgs, PadSpec.for_graphs(mgs), sort_edges=True)
        preds = model.apply(variables, bmg, None, None, is_training=False)
        out.append(np.asarray(preds)[: len(mgs)])
    return np.concatenate(out)


@pytest.mark.parametrize("batch_size", [64, 17])
def test_predict_csv_matches_jax(data_dir, tmp_path, batch_size):
    in_csv = data_dir / "regression" / "mol" / "mol.csv"
    out_csv = tmp_path / "preds.csv"
    rc = main([
        "predict", "--model-path", str(data_dir / CKPT), "-i", str(in_csv), "-o", str(out_csv),
        "--device", "cpu", "--batch-size", str(batch_size),
    ])
    assert rc == 0
    with open(in_csv) as f:
        smis = [row[0] for row in csv.reader(f)][1:]
    with open(out_csv) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["name", "pred_0"]  # the JAX CLI's columns for this model
    assert [r[0] for r in rows[1:]] == smis
    got = np.array([[float(r[1])] for r in rows[1:]], np.float32)
    np.testing.assert_allclose(got, _jax_preds(data_dir / CKPT, smis), rtol=1e-5, atol=1e-5)


def test_predict_bf16_cpu_runs(data_dir, tmp_path):
    in_csv = data_dir / "regression" / "mol" / "mol.csv"
    out_csv = tmp_path / "preds.csv"
    argv = ["predict", "--model-path", str(data_dir / CKPT), "-i", str(in_csv), "-o", str(out_csv),
            "--device", "cpu", "--dtype", "bfloat16"]
    assert main(argv) == 0
    with open(out_csv) as f:
        vals = np.array([float(r[1]) for r in list(csv.reader(f))[1:]])
    assert vals.shape == (100,) and np.isfinite(vals).all()


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_no_device_without_gpu_raises(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_refuse_to_fall_back_to_cpu(no_gpu, data_dir, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(data_dir / CKPT)
    in_csv = data_dir / "regression" / "mol" / "mol.csv"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["predict", "--model-path", str(data_dir / CKPT), "-i", str(in_csv),
              "-o", str(tmp_path / "p.csv")])
    assert not (tmp_path / "p.csv").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "-i", str(in_csv), "-o", str(tmp_path / "train"), "--epochs", "1"])
    assert not (tmp_path / "train").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--model-paths", str(data_dir / CKPT), "--port", "0"])
