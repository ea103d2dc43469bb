"""The port's ``fingerprint`` against the JAX package's CLI on the CPU
(float32): ``--ffn-block-index`` -1, 0 and 1 of the reference regression
checkpoint on 20 rows of mol.csv within rtol 1e-5 / atol 1e-5, the ``.npz``
output, one file per model of an ensemble, and ``MPNN.encoding`` against
the predictions it ends in."""

from __future__ import annotations

import csv

import numpy as np
import pytest
import torch

from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu_torch.cli.main import main as port_main
from chemprop_tpu_torch.data.collate import batch_mol_graphs
from chemprop_tpu_torch.featurizers.molgraph import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.models import load_model

CKPT = "example_model_v2_regression_mol.pt"


@pytest.fixture(scope="module")
def env(data_dir, tmp_path_factory):
    root = tmp_path_factory.mktemp("fingerprint")
    with open(data_dir / "regression/mol/mol.csv", newline="") as f:
        rows = list(csv.reader(f))[:21]
    in_csv = root / "in.csv"
    with open(in_csv, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    jax_ckpt = root / "model.jax.ckpt"
    assert jax_main(["convert", "-i", str(data_dir / CKPT), "-o", str(jax_ckpt)]) in (0, None)
    return root, in_csv, jax_ckpt, data_dir / CKPT


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.array([[float(x) for x in r[1:]]
                                                        for r in rows[1:]])


@pytest.mark.parametrize("index,width", [(-1, 300), (0, 300), (1, 300)])
def test_fingerprint_matches_the_jax_cli(env, index, width):
    root, in_csv, jax_ckpt, ckpt = env
    port, jax_ = root / f"p{index}.csv", root / f"j{index}.csv"
    assert port_main(["fingerprint", "-i", str(in_csv), "--model-paths", str(ckpt), "-o",
                      str(port), "--ffn-block-index", str(index), "--device", "cpu"]) == 0
    assert jax_main(["fingerprint", "-i", str(in_csv), "--model-paths", str(jax_ckpt), "-o",
                     str(jax_), "--ffn-block-index", str(index)]) in (0, None)
    (ph, pn, pv), (jh, jn, jv) = _read(port), _read(jax_)
    assert ph == jh == ["name", *(f"fp_{i}" for i in range(width))]
    assert pn == jn and pv.shape == (20, width)
    np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-5)


def test_npz_output_and_one_file_per_model(env):
    root, in_csv, jax_ckpt, ckpt = env
    out = root / "fps.npz"
    assert port_main(["fingerprint", "-i", str(in_csv), "--model-paths", str(ckpt),
                      str(jax_ckpt), "-o", str(out), "--device", "cpu"]) == 0
    a, b = (np.load(root / f"fps_model_{k}.npz")["fps"] for k in (0, 1))
    assert not out.exists() and a.shape == (20, 300)
    # the reference checkpoint and its JAX conversion: the same weights
    np.testing.assert_array_equal(a, b)


def test_encoding_ends_in_the_predictions(data_dir):
    """The FFN's last block and the unscaling after ``encoding(..., i=-1)``
    give the predictions; ``i=0`` is the fingerprint itself."""
    model, _ = load_model(data_dir / CKPT, "cpu")
    feat = SimpleMoleculeMolGraphFeaturizer()
    bmg = batch_mol_graphs([feat(make_mol(s)) for s in ("CCO", "c1ccccc1O", "CC(=O)N")])
    with torch.inference_mode():
        assert torch.equal(model.encoding(bmg, i=0), model.fingerprint(bmg))
        hidden = model.encoding(bmg, i=-1)
        act, _, last = model.predictor.ffn[-1]
        out = model.predictor.output_transform(last(act(hidden)))
        torch.testing.assert_close(out, model(bmg), rtol=0, atol=0)
