"""The seven reference checkpoints whose heads are not regression ones, and
``CPTPU001`` files of every head, in both packages on the CPU (float32; the
JAX package's plain CPU path):

* each checkpoint loaded by each package its own way: equal predictions on
  the first rows of tests/data/smis.csv (rtol 1e-5, atol 1e-5);
* the port's ``cli predict`` writes the JAX CLI's columns for the multiclass
  Dirichlet checkpoint (labels, ``<task>_prob`` with the uncertainty left
  out) and the point value of a binary Dirichlet one;
* a ``CPTPU001`` file of each head, with a criterion, ``task_weights`` and
  ``threshold``, written by the JAX package and read by the port, and the
  reverse: the same head, criterion and arguments, equal predictions."""

from __future__ import annotations

import csv
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu.cli.main import main as jax_cli
from chemprop_tpu.data import MoleculeDatapoint as JaxDatapoint
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.models import serialize as jserialize
from chemprop_tpu.models.torch_convert import convert_model
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import SumAggregation as JaxSum
from chemprop_tpu.nn import metrics as jm
from chemprop_tpu.nn import predictors as jp
from chemprop_tpu_torch.cli.main import main as port_cli
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.models import MPNN, from_jax_params, load_model, serialize
from chemprop_tpu_torch.nn import BondMessagePassing, SumAggregation
from chemprop_tpu_torch.nn import metrics as tm
from chemprop_tpu_torch.nn import predictors as tp

CHECKPOINTS = [
    "example_model_v2_classification_mol.pt",
    "example_model_v2_classification_mol_multiclass.pt",
    "example_model_v2_classification_dirichlet_mol.pt",
    "example_model_v2_multiclass_dirichlet_mol.pt",
    "example_model_v2_regression_mve_mol.pt",
    "example_model_v2_regression_evidential_mol.pt",
    "example_model_v2_regression_quantile_mol.pt",
]
N_SMIS = 16


@pytest.fixture(scope="module")
def batches(smis):
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(JaxDatapoint.from_smi(s).mol) for s in smis[:N_SMIS]]
    pad = PadSpec.for_graphs(mgs)
    return jax_batch(mgs, JaxPadSpec(*pad), sort_edges=True), batch_mol_graphs(mgs, pad)


@pytest.mark.parametrize("ckpt", CHECKPOINTS)
def test_checkpoint_predictions_match_jax(data_dir, batches, ckpt):
    jb, tb = batches
    jmodel, variables, jcols = convert_model(data_dir / ckpt)
    want = np.asarray(jmodel.apply(variables, jb, None, None, is_training=False))[:N_SMIS]
    model, cols = load_model(data_dir / ckpt, "cpu")
    assert type(model.predictor).__name__ == type(jmodel.predictor).__name__ and cols == jcols
    with torch.inference_mode():
        got = model(tb)[:N_SMIS].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _run_jax_cli(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["chemprop-tpu", *argv])
    assert jax_cli() in (0, None)


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("ckpt", ["example_model_v2_multiclass_dirichlet_mol.pt",
                                  "example_model_v2_classification_dirichlet_mol.pt"])
def test_cli_columns_match_jax(monkeypatch, data_dir, tmp_path, smis, ckpt):
    in_csv = tmp_path / "smis.csv"
    with open(in_csv, "w", newline="") as f:
        csv.writer(f).writerows([["smiles"], *([s] for s in smis[:N_SMIS])])
    converted = tmp_path / "model.ckpt"
    _run_jax_cli(monkeypatch, ["convert", "-i", str(data_dir / ckpt), "-o", str(converted)])
    _run_jax_cli(monkeypatch, ["predict", "-i", str(in_csv), "--model-paths", str(converted),
                               "-o", str(tmp_path / "jax.csv")])
    want = _read(tmp_path / "jax.csv")
    for src in (data_dir / ckpt, converted):  # the reference file and the JAX package's
        assert port_cli(["predict", "--model-path", str(src), "-i", str(in_csv),
                         "-o", str(tmp_path / "port.csv"), "--device", "cpu"]) == 0
        got = _read(tmp_path / "port.csv")
        assert got[0] == want[0] and len(got) == len(want) == N_SMIS + 1
        for g, w in zip(got[1:], want[1:]):
            assert g[0] == w[0]
            for head, gc, wc in zip(got[0][1:], g[1:], w[1:]):
                if head.endswith("_prob"):  # %.6f: the last digit may round the other way
                    gp, wp = (np.array(c.split(","), float) for c in (gc, wc))
                    assert len(gp) == 3 and np.allclose(gp, wp, rtol=0, atol=1.5e-6)
                elif "multiclass" in ckpt:  # the class label
                    assert gc == wc
                else:
                    np.testing.assert_allclose(float(gc), float(wc), rtol=1e-5, atol=1e-6)


# head, its extra arguments, a criterion other than its default
HEADS = [
    ("RegressionFFN", {}, ("MAE", {})),
    ("MveFFN", {}, None),
    ("EvidentialFFN", {}, ("EvidentialLoss", {"v_kl": 0.3, "eps": 1e-6})),
    ("QuantileFFN", {}, ("QuantileLoss", {"alpha": 0.2})),
    ("BinaryClassificationFFN", {}, ("BinaryMCCLoss", {})),
    ("BinaryDirichletFFN", {}, ("DirichletLoss", {"v_kl": 0.1})),
    ("MulticlassClassificationFFN", {"n_classes": 4}, None),
    ("MulticlassDirichletFFN", {"n_classes": 4}, ("MulticlassMCCLoss", {"n_classes": 4})),
    ("SpectralFFN", {"spectral_activation": "exp"}, ("Wasserstein", {"threshold": 0.1})),
]
D_H = 32


def _numpy_variables(tree, seed=0):
    rng = np.random.default_rng(seed)

    def draw(path, x):
        shape = np.shape(x)
        if path[-1].key == "kernel":
            return jnp.asarray((rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32))
        return jnp.asarray((0.1 * rng.standard_normal(shape)).astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, tree)


def _metric_fields(m):
    return None if m is None else (type(m).__name__, {
        k: np.asarray(v).tolist() for k, v in vars(m).items()
        if k not in ("higher_is_better", "needs_collection")})


@pytest.mark.parametrize("name,extra,crit", HEADS, ids=[h[0] for h in HEADS])
def test_cptpu_files_of_every_head_both_ways(tmp_path, batches, name, extra, crit):
    jb, tb = batches
    tw, threshold = [0.5, 2.0], 0.05
    jcrit = None if crit is None else getattr(jm, crit[0])(task_weights=tw, **crit[1])
    tcrit = None if crit is None else getattr(tm, crit[0])(task_weights=tw, **crit[1])
    jmodel = JaxMPNN(JaxBondMP(d_h=D_H, depth=2), JaxSum(), getattr(jp, name)(
        n_tasks=2, input_dim=D_H, hidden_dim=D_H, criterion=jcrit, task_weights=tuple(tw),
        threshold=threshold, **extra))
    variables = jax.device_get(_numpy_variables(jmodel.init(jax.random.PRNGKey(0), jb, None,
                                                            None, False)))
    want = np.asarray(jmodel.apply(variables, jb, None, None, is_training=False))[:N_SMIS]

    # the JAX package writes, the port reads
    jserialize.save_model(tmp_path / "jax.ckpt", jmodel, variables, output_columns=["a", "b"])
    model, cols = load_model(tmp_path / "jax.ckpt", "cpu")
    pred = model.predictor
    assert type(pred).__name__ == name and cols == ["a", "b"]
    assert pred.task_weights == tw and pred.threshold == threshold
    assert _metric_fields(pred.criterion) == _metric_fields(jcrit)
    for key, value in extra.items():
        assert getattr(pred, key) == value
    with torch.inference_mode():
        got = model(tb)[:N_SMIS].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # the port writes, the JAX package reads
    port = MPNN(BondMessagePassing(d_h=D_H, depth=2), SumAggregation(), getattr(tp, name)(
        n_tasks=2, input_dim=D_H, hidden_dim=D_H, criterion=tcrit, task_weights=tw,
        threshold=threshold, **extra))
    port.load_state_dict(from_jax_params(variables["params"]), strict=False)
    serialize.save_model(tmp_path / "port.ckpt", port)
    jback, jvars, _ = jserialize.load_model(tmp_path / "port.ckpt")
    jpred = jback.predictor
    assert type(jpred).__name__ == name and tuple(jpred.task_weights) == tuple(tw)
    assert jpred.threshold == threshold and jpred.n_targets == port.predictor.n_targets
    assert _metric_fields(jpred.criterion) == _metric_fields(tcrit)
    assert _metric_fields(jpred.get_criterion()) == _metric_fields(port.predictor.get_criterion())
    for key, value in extra.items():
        assert getattr(jpred, key) == value
    back = np.asarray(jback.apply(jvars, jb, None, None, is_training=False))[:N_SMIS]
    np.testing.assert_allclose(back, want, rtol=1e-5, atol=1e-5)
