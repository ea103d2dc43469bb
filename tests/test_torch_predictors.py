"""The port's task heads (``chemprop_tpu_torch/nn/predictors.py``) against
the JAX package's on the CPU, float32:

* each head alone, the weights drawn by numpy from a seed and carried across
  by ``from_jax_params``: the inference output, ``train_step``,
  ``val_step``, ``mc_step`` and ``encode``, with and without an output
  transform (the regression heads), and the default criterion with
  ``task_weights`` and ``threshold``;
* a head of each output layout in a whole ``MPNN`` (d_h = 32, depth 2; the
  JAX package's plain CPU path): every output keeps the head's trailing
  dimensions;
* three Adam steps of a BCE model (classification/mol.csv: four tasks with
  missing labels), a CE model (mol_multiclass.csv) and an MVE model against
  the JAX trainer, to the tolerances of
  ``test_torch_train.py::test_three_adam_steps_match_jax_f32``; the
  validation record (streaming ``val_loss``, metrics) and ``predict`` in
  dataset order against the JAX trainer's;
* regression/bounded.csv's ``<`` and ``>`` targets parsed into the masks,
  collated as the JAX package collates them, and reaching the loss.

Tolerance: rtol 1e-5 / atol 1e-6 for the heads alone (the same f32
arithmetic); rtol 1e-5 / atol 1e-5 through message passing."""

from __future__ import annotations

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu import data as jdata
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import metrics as jm
from chemprop_tpu.nn import predictors as jp
from chemprop_tpu.nn.transforms import UnscaleTransform as JaxUnscale
from chemprop_tpu.train import Trainer as JaxTrainer
from chemprop_tpu.train.trainer import TrainState as JaxTrainState
from chemprop_tpu.train.schedulers import noam_lr_host
from chemprop_tpu_torch.data import DataLoader, MoleculeDatapoint, MoleculeDataset
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.models import MPNN, from_jax_params
from chemprop_tpu_torch.models.serialize import to_jax_params
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation
from chemprop_tpu_torch.nn import metrics as tm
from chemprop_tpu_torch.nn import predictors as tp
from chemprop_tpu_torch.train import Trainer

N_TASKS, D_IN = 3, 16
# head class, extra constructor arguments
HEADS = [
    ("RegressionFFN", {}),
    ("MveFFN", {}),
    ("EvidentialFFN", {}),
    ("QuantileFFN", {}),
    ("BinaryClassificationFFN", {}),
    ("BinaryDirichletFFN", {}),
    ("MulticlassClassificationFFN", {"n_classes": 4}),
    ("MulticlassDirichletFFN", {"n_classes": 4}),
    ("SpectralFFN", {}),
    ("SpectralFFN", {"spectral_activation": "exp"}),
]
REGRESSION = ("RegressionFFN", "MveFFN", "EvidentialFFN", "QuantileFFN")
HEAD_IDS = [name + "".join(f"-{v}" for v in extra.values()) for name, extra in HEADS]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_params(tree, seed=0):
    rng = np.random.default_rng(seed)

    def draw(path, x):
        shape = np.shape(x)
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif name in ("var", "scale"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, tree)


def _head_pair(name, extra, transform: bool, **kwargs):
    """The JAX head, its variables and the port's head with the same weights."""
    rng = np.random.default_rng(1)
    mean, scale = rng.standard_normal(N_TASKS), rng.uniform(0.5, 2.0, N_TASKS)
    jhead = getattr(jp, name)(
        n_tasks=N_TASKS, input_dim=D_IN, hidden_dim=(24, 20),
        output_transform=JaxUnscale(mean, scale) if transform else None, **extra, **kwargs)
    Z = jnp.asarray(rng.standard_normal((6, D_IN)).astype(np.float32))
    variables = _numpy_params(jhead.init(jax.random.PRNGKey(0), Z, False))
    head = getattr(tp, name)(n_tasks=N_TASKS, input_dim=D_IN, hidden_dim=[24, 20],
                             output_transform=transform, **extra, **kwargs)
    sd = from_jax_params({"message_passing": {}, "predictor": variables["params"]})
    head.load_state_dict({k.removeprefix("predictor."): v for k, v in sd.items()}, strict=False)
    if transform:
        head.output_transform.mean.copy_(torch.tensor(mean).reshape(1, -1))
        head.output_transform.scale.copy_(torch.tensor(scale).reshape(1, -1))
    missing = {k for k in head.state_dict() if k.startswith("ffn")} - {
        k.removeprefix("predictor.") for k in sd}
    assert not missing
    return jhead, variables, head, Z


# only the regression heads unscale: they run with and without a transform
HEAD_CASES = [(name, extra, False) for name, extra in HEADS] + [
    (name, extra, True) for name, extra in HEADS if name in REGRESSION]


@pytest.mark.parametrize("name,extra,transform", HEAD_CASES, ids=[
    f"{i}-{'transform' if t else 'no_transform'}"
    for i, (_, _, t) in zip(HEAD_IDS + HEAD_IDS[:4], HEAD_CASES)])
def test_head_matches_jax(name, extra, transform):
    jhead, v, head, Z = _head_pair(name, extra, transform)
    t = torch.from_numpy(np.array(Z))
    outs = {
        "forward": (jhead.apply(v, Z, False), head(t)),
        "forward_training": (jhead.apply(v, Z, True), head(t, True)),
        "train_step": (jhead.apply(v, Z, True, method="train_step"), head.train_step(t)),
        "val_step": (jhead.apply(v, Z, method="val_step"), head.val_step(t)),
        "mc_step": (jhead.apply(v, Z, method="mc_step"), head.mc_step(t, None)),
        "encode_1": (jhead.apply(v, Z, 1, False, method="encode"), head.encode(t, 1)),
        "encode_-1": (jhead.apply(v, Z, -1, False, method="encode"), head.encode(t, -1)),
    }
    for key, (want, got) in outs.items():
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, key
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6, err_msg=key)
    assert head.output_dim == jhead.output_dim and head.n_targets == jhead.n_targets


@pytest.mark.parametrize("name,extra", HEADS, ids=HEAD_IDS)
def test_default_criterion_matches_jax(name, extra):
    kwargs = {"task_weights": [0.5, 1.0, 2.0], "threshold": 0.05}
    jcrit = getattr(jp, name)(n_tasks=N_TASKS, **extra, **kwargs).get_criterion()
    crit = getattr(tp, name)(n_tasks=N_TASKS, **extra, **kwargs).get_criterion()
    assert type(crit).__name__ == type(jcrit).__name__
    for f in ("task_weights", "threshold"):
        if hasattr(jcrit, f):
            np.testing.assert_array_equal(np.asarray(getattr(crit, f)),
                                          np.asarray(getattr(jcrit, f)))
    explicit = tm.MAE()
    assert getattr(tp, name)(criterion=explicit, **extra).get_criterion() is explicit
    registered = {cls.__name__ for cls in tp.PredictorRegistry.values()}
    assert registered == {cls.__name__ for cls in jp.PredictorRegistry.values()}


@pytest.mark.parametrize("name,extra", [HEADS[1], HEADS[6]], ids=[HEAD_IDS[1], HEAD_IDS[6]])
def test_mc_step_draws_dropout_from_the_generator(name, extra):
    head = getattr(tp, name)(n_tasks=2, input_dim=8, hidden_dim=16, dropout=0.5, **extra)
    Z = torch.randn(5, 8, generator=torch.Generator().manual_seed(0))
    a = head.mc_step(Z, torch.Generator().manual_seed(1))
    b = head.mc_step(Z, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, head(Z))
    assert torch.equal(head.val_step(Z), head(Z)) or name in REGRESSION


# ------------------------------------------------------------- whole models
SMIS = ["CCO", "c1ccccc1", "CC(=O)Nc1ccc(O)cc1", "CNC(C)Cc1ccccc1", "C1CCNCC1", "C",
        "O=[N+]([O-])c1ccc(Cl)cc1"]
D_H = 32


@pytest.fixture(scope="module")
def graphs():
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(jdata.MoleculeDatapoint.from_smi(s).mol) for s in SMIS]
    pad = (128, 256, len(SMIS))
    return mgs, jax_batch(mgs, JaxPadSpec(*pad), sort_edges=True), batch_mol_graphs(mgs, PadSpec(*pad))


# one head of each output layout: [n, t] probabilities, [n, t, 2] (mean,
# variance), [n, t, c + 1] (class probabilities, uncertainty)
MODEL_HEADS = [4, 1, 7]


@pytest.mark.parametrize("name,extra", [HEADS[i] for i in MODEL_HEADS],
                         ids=[HEAD_IDS[i] for i in MODEL_HEADS])
def test_model_with_head_matches_jax(graphs, name, extra):
    mgs, jb, tb = graphs
    jmodel = JaxMPNN(JaxBondMP(d_h=D_H, depth=2), JaxMean(),
                     getattr(jp, name)(n_tasks=2, input_dim=D_H, hidden_dim=D_H, **extra),
                     batch_norm=True)
    v = _numpy_params(jmodel.init(jax.random.PRNGKey(0), jb, None, None, False))
    model = MPNN(BondMessagePassing(d_v=mgs[0].V.shape[1], d_e=mgs[0].E.shape[1], d_h=D_H,
                                    depth=2),
                 MeanAggregation(),
                 getattr(tp, name)(n_tasks=2, input_dim=D_H, hidden_dim=D_H,
                                   output_transform=False, **extra),
                 batch_norm=True)
    model.load_state_dict(from_jax_params(v["params"], v["batch_stats"]))
    with torch.inference_mode():
        outs = {
            "forward": (jmodel.apply(v, jb, None, None, False), model(tb)),
            "train_step_preds": (jmodel.apply(v, jb, is_training=False, method="train_step_preds"),
                                 model.train_step_preds(tb, is_training=False)),
            "val_step_preds": (jmodel.apply(v, jb, method="val_step_preds"),
                               model.val_step_preds(tb)),
            "mc_dropout_preds": (jmodel.apply(v, jb, method="mc_dropout_preds"),
                                 model.mc_dropout_preds(tb)),
        }
    for key, (want, got) in outs.items():
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, key
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5, err_msg=key)


# ------------------------------------------------------------ the trainer
def _rows(path, n, bounded=False):
    """``(smiles, y, lt, gt)`` of the first ``n`` rows; empty targets NaN,
    ``<x`` / ``>x`` a bound with ``bounded``."""
    out = []
    with open(path) as f:
        for row in list(csv.reader(f))[1 : n + 1]:
            y, lt, gt = [], [], []
            for v in row[1:]:
                v = v.strip()
                lt.append(bounded and v.startswith("<"))
                gt.append(bounded and v.startswith(">"))
                y.append(float(v.lstrip("<>=")) if v else np.nan)
            out.append((row[0], np.array(y), np.array(lt), np.array(gt)))
    return out


D_TRAIN = 64  # test_torch_train.py's width


def _case(name, data_dir):
    """(rows, the JAX head, the port's head, normalise, validation metrics)."""
    kw = dict(input_dim=D_TRAIN, hidden_dim=D_TRAIN)
    if name == "bce":
        rows = _rows(data_dir / "classification" / "mol.csv", N_ROWS)
        return (rows, jp.BinaryClassificationFFN(n_tasks=4, **kw),
                tp.BinaryClassificationFFN(n_tasks=4, **kw), False, ("roc", "binary-mcc"))
    if name == "ce":
        rows = _rows(data_dir / "classification" / "mol_multiclass.csv", N_ROWS)
        return (rows, jp.MulticlassClassificationFFN(n_classes=3, **kw),
                tp.MulticlassClassificationFFN(n_classes=3, **kw), False, ("multiclass-mcc",))
    if name == "mve":
        rows = _rows(data_dir / "regression" / "mol" / "mol.csv", N_ROWS)
        return (rows, jp.MveFFN(**kw), tp.MveFFN(output_transform=False, **kw), True, ("r2",))


N_ROWS = 56  # in batches of 16: three steps, and a fourth batch of 8 with padding
THREE_LRS = sum(noam_lr_host(k, 4, 96, 1e-4, 1e-3, 1e-4) for k in range(3))


@pytest.mark.parametrize("name", ["bce", "ce", "mve"])
def test_three_adam_steps_match_jax_f32(data_dir, name):
    rows, jhead, head, normalize, metric_names = _case(name, data_dir)
    jds = jdata.MoleculeDataset([jdata.MoleculeDatapoint.from_smi(s, y=y) for s, y, _, _ in rows])
    tds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=y) for s, y, _, _ in rows])
    for ds in (jds, tds):
        if normalize:
            ds.normalize_targets()
        ds.cache = True
    jmetrics = {m: jm.MetricRegistry[m](**({"n_classes": 3} if "multiclass" in m else {}))
                for m in metric_names}
    tmetrics = {m: tm.MetricRegistry[m](**({"n_classes": 3} if "multiclass" in m else {}))
                for m in metric_names}
    jmodel = JaxMPNN(JaxBondMP(d_h=D_TRAIN), JaxMean(), jhead, batch_norm=True)
    model = MPNN(BondMessagePassing(d_h=D_TRAIN), MeanAggregation(), head, batch_norm=True)
    # one padded shape for every batch: each JAX function compiles once
    shapes = [(b.bmg.V.shape[0], b.bmg.E.shape[0]) for b in DataLoader(tds, batch_size=16)]
    pad = (max(n for n, _ in shapes), max(e for _, e in shapes), 16)
    jloader = jdata.DataLoader(jds, batch_size=16, pad_spec=JaxPadSpec(*pad), prefetch=0)
    tloader = DataLoader(tds, batch_size=16, pad_spec=PadSpec(*pad))
    jbatches, tbatches = list(jloader)[:3], list(tloader)[:3]

    trainer = Trainer(model, max_epochs=25, warmup_epochs=1, seed=12, device="cpu",
                      val_metrics=tmetrics)
    trainer.init_state(tbatches[0], len(tloader))
    # the port's initial parameters carried into the JAX trainer's state, as
    # its init_state builds it (the same optimizer), without tracing JAX's init
    jtrainer = JaxTrainer(jmodel, max_epochs=25, warmup_epochs=1, seed=12, val_metrics=jmetrics)
    jtrainer._check_jit_cache(len(jloader))
    jtrainer.tx = jtrainer._build_optimizer(len(jloader))
    v = to_jax_params(model.state_dict())
    state = jtrainer.state = JaxTrainState(
        params=v["params"], batch_stats=v["batch_stats"], opt_state=jtrainer.tx.init(v["params"]),
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(12))

    # validation before the steps: the criterion's streaming state and the
    # metrics over four batches
    want = jtrainer._run_validation(jloader, jtrainer._make_eval_step())
    got = trainer._validate(tloader, True)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    for m in metric_names:
        key = f"val_{m}"
        if jmetrics[m].needs_collection:
            # exact on the port's own predictions; against JAX's within the
            # swaps of scores that differ in the last bits
            preds = trainer.predict(tloader)
            Y = tds.Y
            np.testing.assert_allclose(got[key], tmetrics[m].compute_from_arrays(
                preds, Y, np.isfinite(Y)), rtol=1e-12)
            assert abs(got[key] - want[key]) <= 0.05, key
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5, err_msg=key)

    # predict in dataset order, the last batch's 8 padding rows cut: the
    # multiclass head's [n, t, c] against JAX's (the others' layouts are
    # held in test_model_with_head_matches_jax)
    got = trainer.predict(tloader)
    assert got.shape[0] == N_ROWS and np.isfinite(got).all()
    if name == "ce":
        # JAX's inference-space predictions from the validation's eval step
        # (the step ``Trainer.predict`` applies too), padding rows cut
        eval_step = jtrainer._make_eval_step()
        want = np.concatenate([np.asarray(eval_step(state.params, state.batch_stats, jb)[1])[
            jb.pad_mask] for jb in jloader])
        assert got.shape == want.shape == (N_ROWS, 1, 3)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    jstep = jax.jit(jtrainer._train_body())
    jlosses, tlosses = [], []
    for jb, tb in zip(jbatches, tbatches):
        state, loss = jstep(state, jb)
        jlosses.append(float(loss))
        tlosses.append(float(trainer.train_step(tb)))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    want_sd = from_jax_params(state.params, state.batch_stats)
    got_sd = {k: v.detach() for k, v in model.state_dict().items()}
    n_bad = n_all = 0
    for k in want_sd:
        err = (got_sd[k] - want_sd[k]).abs()
        assert float(err.max()) <= 2 * THREE_LRS, k
        n_bad += int((err > 1e-6 + 1e-4 * want_sd[k].abs()).sum())
        n_all += err.numel()
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)


def test_bounded_targets_reach_the_loss(data_dir):
    """regression/bounded.csv's ``<`` and ``>`` targets: the masks of each
    collated batch equal the JAX package's collate (false padding rows), and
    the trainer's loss is the bounded criterion with them."""
    rows = _rows(data_dir / "regression" / "bounded.csv", 112, bounded=True)
    rows = rows[40:60] + rows[100:112]  # ten "<", ten ">" and twelve plain targets
    jds = jdata.MoleculeDataset([jdata.MoleculeDatapoint.from_smi(s, y=y, lt_mask=lt, gt_mask=gt)
                                 for s, y, lt, gt in rows])
    tds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=y, lt_mask=lt, gt_mask=gt)
                           for s, y, lt, gt in rows])
    lt, gt = (np.array([getattr(d, k) for d in tds.data]) for k in ("lt_mask", "gt_mask"))
    assert lt.any() and gt.any() and not (lt & gt).any()
    tbatches = list(DataLoader(tds, batch_size=24))  # the second one has padding rows
    for jb, tb in zip(jdata.DataLoader(jds, batch_size=24, prefetch=0), tbatches):
        for key in ("lt_mask", "gt_mask"):
            np.testing.assert_array_equal(getattr(tb, key).numpy(), getattr(jb, key))
            assert getattr(tb, key).dtype == torch.bool
    tb = tbatches[0]
    np.testing.assert_array_equal(tds.Y, jds.Y)
    criterion = tm.BoundedMSE(task_weights=[1.0])
    model = MPNN(BondMessagePassing(d_h=16, depth=2), MeanAggregation(),
                 tp.RegressionFFN(input_dim=16, hidden_dim=16, criterion=criterion))
    trainer = Trainer(model, device="cpu")
    trainer.init_state()
    with torch.no_grad():
        got = trainer.loss(tb)
        preds = model.train_step_preds(tb.bmg, is_training=True)
    mask = torch.isfinite(tb.Y)
    want = criterion(preds, torch.nan_to_num(tb.Y), mask, tb.w[:, 0], tb.lt_mask, tb.gt_mask)
    unbounded = tm.MSE(task_weights=[1.0])(preds, torch.nan_to_num(tb.Y), mask, tb.w[:, 0])
    assert float(got) == pytest.approx(float(want), rel=1e-6) and float(want) <= float(unbounded)


def test_a_metric_that_fails_records_nan(data_dir):
    """AUROC over a validation set of one class raises; the epoch records NaN
    for it and the fit goes on."""
    rows = [r for r in _rows(data_dir / "classification" / "mol.csv", 40) if r[1][3] == 0][:6]
    ds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=y[3:]) for s, y, _, _ in rows])
    model = MPNN(BondMessagePassing(d_h=16, depth=2), MeanAggregation(),
                 tp.BinaryClassificationFFN(input_dim=16, hidden_dim=16))
    trainer = Trainer(model, max_epochs=2, device="cpu",
                      val_metrics={"roc": tm.BinaryAUROC(), "accuracy": tm.BinaryAccuracy()})
    trainer.fit(DataLoader(ds, batch_size=4), DataLoader(ds, batch_size=4))
    assert len(trainer.history) == 2
    for rec in trainer.history:
        assert np.isnan(rec["val_roc"]) and np.isfinite(rec["val_accuracy"])
