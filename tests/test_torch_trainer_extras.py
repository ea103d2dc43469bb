"""The rest of the port's ``Trainer`` against the JAX package's on the CPU:
validation metrics and ``monitor`` on them, ``freeze`` (with and without
clipping), and resuming a fit from ``last.ckpt`` (port to port). Both
trainers start from the same parameters (JAX's initialisation carried
across by ``from_jax_params``) and see the same unshuffled batches. Small
size: the first 32 rows of mol.csv, d_h = 32, depth 2, float32."""

from __future__ import annotations

import csv

import jax
import numpy as np
import pytest
import torch

from chemprop_tpu import data as jdata
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.nn import metrics as jmetrics
from chemprop_tpu.nn.transforms import UnscaleTransform as JaxUnscale
from chemprop_tpu.train import Trainer as JaxTrainer
from chemprop_tpu.train.schedulers import noam_lr_host
from chemprop_tpu_torch.data import DataLoader, MoleculeDatapoint, MoleculeDataset
from chemprop_tpu_torch.models import MPNN, from_jax_params
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.nn import metrics
from chemprop_tpu_torch.train import Trainer
from chemprop_tpu_torch.train.trainer import jax_key

D_H = 32
N_ROWS = 32


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def datasets(data_dir):
    with open(data_dir / "regression" / "mol" / "mol.csv") as f:
        rows = [(s, float(y)) for s, y in list(csv.reader(f))[1 : N_ROWS + 1]]
    jds = jdata.MoleculeDataset([jdata.MoleculeDatapoint.from_smi(s, y=np.array([y]))
                                 for s, y in rows])
    tds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=np.array([y])) for s, y in rows])
    for ds in (jds, tds):
        ds.normalize_targets()
        ds.cache = True
    return jds, tds


def _model(dropout: float = 0.0):
    return MPNN(BondMessagePassing(d_h=D_H, depth=2, dropout=dropout), MeanAggregation(),
                RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False),
                batch_norm=True)


def _jax_model():
    return JaxMPNN(message_passing=JaxBondMP(d_h=D_H, depth=2), agg=JaxMean(),
                   predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H), batch_norm=True)


def _pair(datasets, **kwargs):
    """A JAX trainer and the port's, with JAX's initial state carried across."""
    jds, tds = datasets
    jloader = jdata.DataLoader(jds, batch_size=16, shuffle=False, prefetch=0)
    tloader = DataLoader(tds, batch_size=16, shuffle=False)
    jkw = {k: v for k, v in kwargs.items() if k != "val_metrics"}
    jtrainer = JaxTrainer(_jax_model(), seed=4, val_metrics={
        name: getattr(jmetrics, type(m).__name__)() for name, m in
        kwargs.get("val_metrics", {}).items()}, **jkw)
    jtrainer.state = jtrainer.init_state(next(iter(jloader)), len(jloader))
    trainer = Trainer(_model(), seed=4, device="cpu", **kwargs)
    trainer.init_state(None, len(tloader))
    trainer.model.load_state_dict(from_jax_params(jtrainer.state.params,
                                                  jtrainer.state.batch_stats))
    return jtrainer, jloader, trainer, tloader


VAL_METRICS = {"mae": metrics.MAE(), "rmse": metrics.RMSE(), "r2": metrics.R2Score()}


def test_metrics_match_jax_on_arrays():
    """MAE, RMSE and R2 with a mask and task weights, against the JAX
    metrics' states on the same arrays (f32 sums in another order)."""
    rng = np.random.default_rng(0)
    preds, targets = rng.standard_normal((40, 3)), rng.standard_normal((40, 3))
    mask = rng.uniform(size=(40, 3)) > 0.2
    w = rng.uniform(0.5, 1.5, 40)
    for name, cls in (("MAE", metrics.MAE), ("RMSE", metrics.RMSE), ("R2Score", metrics.R2Score),
                      ("MSE", metrics.MSE)):
        jm = getattr(jmetrics, name)(task_weights=[1.0, 2.0, 0.5])
        want = float(jm(*(jax.numpy.asarray(x, jax.numpy.float32) for x in (preds, targets)),
                        jax.numpy.asarray(mask), jax.numpy.asarray(w, jax.numpy.float32)))
        t = [torch.tensor(x, dtype=torch.float32) for x in (preds, targets, w)]
        got = float(cls(task_weights=[1.0, 2.0, 0.5])(t[0], t[1], torch.from_numpy(mask), t[2]))
        assert got == pytest.approx(want, rel=1e-5), name
    assert metrics.R2Score().higher_is_better and not metrics.RMSE().higher_is_better


def test_val_metrics_match_jax_records(datasets):
    """Three epochs with a validation loader: every epoch's val_loss,
    val_mae, val_rmse and val_r2 against the JAX trainer's records."""
    jtrainer, jloader, trainer, tloader = _pair(datasets, max_epochs=3, warmup_epochs=1,
                                                val_metrics=VAL_METRICS)
    jtrainer.fit(jloader, jloader)
    trainer.fit(tloader, tloader)
    assert len(trainer.history) == len(jtrainer.history) == 3
    for got, want in zip(trainer.history, jtrainer.history):
        # R2 is held as 1 - R2 = SS_res / SS_tot, a ratio of means like the rest
        got["val_r2"], want["val_r2"] = 1 - got["val_r2"], 1 - want["val_r2"]
        for key in ("train_loss", "val_loss", "val_mae", "val_rmse", "val_r2"):
            # f32 on both sides, six Adam steps: a gradient at f32 rounding
            # may step the other way (test_torch_train.py), and the JAX f32
            # message keeps ~16 significant bits; these means move by far less
            # than 1e-4 of their value
            assert got[key] == pytest.approx(want[key], rel=1e-4), key


def test_monitor_on_a_metric_and_a_failing_metric(datasets):
    """``monitor`` names a metric (here R2, maximised); a metric that raises
    records NaN and the fit goes on."""

    class Broken(metrics.ChempropMetric):
        def __call__(self, *args):
            raise RuntimeError("broken")

    _, tds = datasets
    loader = DataLoader(tds, batch_size=16)
    trainer = Trainer(_model(), max_epochs=4, warmup_epochs=1, max_lr=5e-3, seed=1,
                      device="cpu", monitor="val_r2", mode="max",
                      val_metrics={**VAL_METRICS, "broken": Broken()})
    trainer.fit(loader, loader)
    r2 = [h["val_r2"] for h in trainer.history]
    assert len(r2) == 4 and all(np.isfinite(r2))
    assert all(np.isnan(h["val_broken"]) for h in trainer.history)
    assert trainer.best_epoch == int(np.argmax(r2))


def _frozen(path: str) -> bool:
    return path.startswith("message_passing")


@pytest.mark.parametrize("grad_clip", [None, 0.05], ids=["unclipped", "clipped"])
def test_freeze_matches_jax(datasets, grad_clip):
    """``freeze`` on JAX paths: the encoder's tensors stay bit for bit, the
    head's move (tests/integration/test_resume_transfer.py's rule), and the
    fit follows JAX's. With clipping the global norm counts only the trained
    gradients: a clip of 0.05 binds on every step, so a norm over the frozen
    gradients too would scale every step differently."""
    jtrainer, jloader, trainer, tloader = _pair(datasets, max_epochs=2, warmup_epochs=1,
                                                freeze=_frozen, grad_clip=grad_clip)
    names = list(trainer.state.params)
    assert {jax_key(n) for n in names} >= {"message_passing/W_i/kernel", "bn/scale",
                                             "predictor/ffn/block1/bias"}
    before = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    jtrainer.fit(jloader)
    trainer.fit(tloader)
    after = {k: v.detach() for k, v in trainer.state.params.items()}
    want = from_jax_params(jtrainer.state.params, jtrainer.state.batch_stats)
    lrs = sum(noam_lr_host(k, *trainer._sched_args) for k in range(trainer.state.step))
    for i, name in enumerate(names):
        if name.startswith("message_passing"):
            assert torch.equal(after[name], before[name]), name
            assert not trainer.state.mu[i].any() and not trainer.state.nu[i].any()
        # f32 on both sides: within twice the steps' rates everywhere (a
        # gradient at f32 rounding may step the other way), and 1e-4 nearly
        # everywhere
        err = (after[name] - want[name]).abs()
        assert float(err.max()) <= 2 * lrs, name
        assert int((err > 1e-6 + 1e-4 * want[name].abs()).sum()) <= max(1, 1e-3 * err.numel())
    moved = (after["predictor.ffn.0.0.weight"] - before["predictor.ffn.0.0.weight"]).abs().max()
    assert moved > 0
    np.testing.assert_allclose([h["train_loss"] for h in trainer.history],
                               [h["train_loss"] for h in jtrainer.history], rtol=1e-5)


def test_resume_equals_an_uninterrupted_fit(datasets, tmp_path):
    """Six epochs straight against three, ``last.ckpt``, ``resume_from`` and
    three more, with dropout (the generator's state is in the file): the
    same losses, parameters and predictions, bit for bit on the CPU. The
    shuffled loader's epoch order is the loader's own state: the interrupted
    run's loader goes on into the resumed fit."""
    _, tds = datasets
    val = DataLoader(tds, batch_size=16)

    def trainer(**kw):
        return Trainer(_model(dropout=0.1), max_epochs=6, warmup_epochs=1, seed=5,
                       device="cpu", grad_clip=1.0, **kw)

    full = trainer()
    full.fit(DataLoader(tds, batch_size=16, shuffle=True, seed=2), val)

    loader = DataLoader(tds, batch_size=16, shuffle=True, seed=2)
    first = trainer(checkpoint_dir=tmp_path)
    first.init_state(None, len(loader))
    first.max_epochs = 3  # the schedule was fixed by init_state for six epochs
    first.fit(loader, val)
    assert (tmp_path / "last.ckpt").exists() and (tmp_path / "best.ckpt").exists()

    resumed = trainer()
    resumed.start_epoch = resumed.resume_from(tmp_path / "last.ckpt", None, len(loader))
    assert resumed.start_epoch == 3 and resumed.state.step == 3 * len(loader)
    resumed.fit(loader, val)
    losses = [h["train_loss"] for h in first.history + resumed.history]
    assert losses == [h["train_loss"] for h in full.history]
    for (name, got), want in zip(resumed.state.params.items(), full.state.params.values()):
        assert torch.equal(got, want), name
    eval_loader = DataLoader(tds, batch_size=16)
    resumed.best_variables = full.best_variables = None  # the last state on both
    np.testing.assert_array_equal(resumed.predict(eval_loader), full.predict(eval_loader))


@pytest.mark.parametrize("written,resumed", [(True, False), (False, True)],
                         ids=["frozen_file", "frozen_trainer"])
def test_resume_refuses_another_freeze(datasets, tmp_path, written, resumed):
    """A ``last.ckpt`` written with another ``freeze`` holds moments for
    another set of parameters: resuming from it raises rather than continue
    with zero moments (or drop the file's)."""
    _, tds = datasets
    loader = DataLoader(tds, batch_size=16)

    def freeze(on):
        return (lambda p: p.startswith("message_passing")) if on else None

    first = Trainer(_model(), max_epochs=1, warmup_epochs=1, seed=5, device="cpu",
                    checkpoint_dir=tmp_path, freeze=freeze(written))
    first.fit(loader)
    second = Trainer(_model(), max_epochs=2, warmup_epochs=1, seed=5, device="cpu",
                     freeze=freeze(resumed))
    with pytest.raises(ValueError, match="freeze"):
        second.resume_from(tmp_path / "last.ckpt", None, len(loader))
    same = Trainer(_model(), max_epochs=2, warmup_epochs=1, seed=5, device="cpu",
                   freeze=freeze(written))
    assert same.resume_from(tmp_path / "last.ckpt", None, len(loader)) == 1


def test_last_ckpt_epoch_after_a_resumed_epoch(datasets, tmp_path):
    """A resumed fit's ``last.ckpt`` names the next epoch to run. The JAX
    trainer writes ``len(history)``, which restarts from 0 in a resumed
    trainer (a fault of the reference, not a parity target): resuming from
    its file would repeat epochs. The port writes the epoch after the one
    just run."""
    from chemprop_tpu_torch.models import serialize

    _, tds = datasets
    loader = DataLoader(tds, batch_size=16)
    first = Trainer(_model(), max_epochs=4, warmup_epochs=1, seed=5, device="cpu",
                    checkpoint_dir=tmp_path / "a")
    first.init_state(None, len(loader))
    first.max_epochs = 2
    first.fit(loader)
    second = Trainer(_model(), max_epochs=4, warmup_epochs=1, seed=5, device="cpu",
                     checkpoint_dir=tmp_path / "b")
    second.start_epoch = second.resume_from(tmp_path / "a" / "last.ckpt", None, len(loader))
    second.max_epochs = 3
    second.fit(loader)
    assert len(second.history) == 1
    _, variables = serialize.read_checkpoint(tmp_path / "b" / "last.ckpt")
    assert int(variables["epoch"]) == 3


def test_val_step_preds_are_jax_criterion_space_predictions(datasets):
    """The metrics take JAX's ``val_step_preds``: evaluation statistics and
    no output unscaling, where the inference forward unscales."""
    jds, tds = datasets
    jmodel = JaxMPNN(message_passing=JaxBondMP(d_h=D_H, depth=2), agg=JaxMean(),
                     predictor=JaxRegressionFFN(
                         input_dim=D_H, hidden_dim=D_H,
                         output_transform=JaxUnscale(np.array([2.0]), np.array([3.0]))),
                     batch_norm=True)
    jb = next(iter(jdata.DataLoader(jds, batch_size=16, prefetch=0)))
    variables = jmodel.init(jax.random.PRNGKey(1), jb.bmg, None, None, False)
    model = MPNN(BondMessagePassing(d_h=D_H, depth=2), MeanAggregation(),
                 RegressionFFN(input_dim=D_H, hidden_dim=D_H), batch_norm=True)
    model.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]),
                          strict=False)
    model.predictor.output_transform.mean.fill_(2.0)
    model.predictor.output_transform.scale.fill_(3.0)
    tb = next(iter(DataLoader(tds, batch_size=16)))
    with torch.no_grad():
        got, got_inf = model.val_step_preds(tb.bmg).numpy(), model(tb.bmg).numpy()
    want = np.asarray(jmodel.apply(variables, jb.bmg, method="val_step_preds"))
    # f32; the JAX f32 message keeps ~16 significant bits (bf16 hi + lo)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_inf, 3.0 * got + 2.0, rtol=1e-6, atol=1e-6)
