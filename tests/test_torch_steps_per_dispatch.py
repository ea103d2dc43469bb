"""``Trainer.steps_per_dispatch`` in the port (cf.
``chemprop_tpu/train/trainer.py:200-205``, read at ``:474-481``), on the CPU.

The JAX trainer chains that many steps into one ``lax.scan`` dispatch, and
its chaining trains the same steps in the same order. The port issues each
step eagerly whatever the value, so a fit with ``steps_per_dispatch=4``
must equal one without it bit for bit: the history (all but the clock's
``time_s`` and ``edges_per_s``), the parameters, Adam's moments and step,
the dropout generator, and the ``best.ckpt`` / ``last.ckpt`` it writes; for
``Trainer`` with and without dropout and for ``MABTrainer``. A value the JAX
trainer's ``fit`` refuses (``int()`` of it fails) raises in both."""

from __future__ import annotations

import csv
import dataclasses

import numpy as np
import pytest
import torch

from chemprop_tpu import data as jdata
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.train import Trainer as JaxTrainer
from chemprop_tpu_torch.data import DataLoader, MoleculeDatapoint, MoleculeDataset
from chemprop_tpu_torch.models import MPNN, serialize
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.train import Trainer
from chemprop_tpu_torch.train.mab_trainer import MABTrainer

D_H = 32
N_ROWS = 40
CLOCK = ("time_s", "edges_per_s")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rows(data_dir):
    with open(data_dir / "regression" / "mol" / "mol.csv") as f:
        return [(s, float(y)) for s, y in list(csv.reader(f))[1 : N_ROWS + 1]]


def _dataset(rows):
    ds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=np.array([y])) for s, y in rows])
    ds.normalize_targets()
    ds.cache = True
    return ds


def _model(dropout: float):
    return MPNN(BondMessagePassing(d_h=D_H, depth=2, dropout=dropout), MeanAggregation(),
                RegressionFFN(input_dim=D_H, hidden_dim=D_H, dropout=dropout,
                              output_transform=False), batch_norm=True)


def _fit(make_trainer, loader, val_loader, ckpt_dir, **kwargs):
    trainer = make_trainer(checkpoint_dir=ckpt_dir, **kwargs)
    trainer.fit(loader, val_loader)
    return trainer


def _assert_same_fits(a, b, dirs):
    assert len(a.history) == len(b.history) == a.max_epochs
    for ra, rb in zip(a.history, b.history, strict=True):
        assert {k: v for k, v in ra.items() if k not in CLOCK} == {
            k: v for k, v in rb.items() if k not in CLOCK}
    for k, v in a.state.params.items():
        assert torch.equal(v, b.state.params[k]), k
    for k, v in a.state.batch_stats.items():
        assert torch.equal(v, b.state.batch_stats[k]), k
    for moments in ("mu", "nu"):
        for x, y in zip(getattr(a.state, moments), getattr(b.state, moments), strict=True):
            assert torch.equal(x, y), moments
    assert a.state.step == b.state.step
    assert torch.equal(a.state.rng.get_state(), b.state.rng.get_state())
    for name in ("best.ckpt", "last.ckpt"):
        (ma, va), (mb, vb) = (serialize.read_checkpoint(d / name) for d in dirs)
        assert ma == mb, name
        flat_a, flat_b = _flat(va), _flat(vb)
        assert flat_a.keys() == flat_b.keys()
        for k in flat_a:
            np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=f"{name}: {k}")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["plain", "dropout"])
def test_a_fit_with_steps_per_dispatch_equals_one_without(rows, tmp_path, dropout):
    ds, val = _dataset(rows), DataLoader(_dataset(rows[:16]), batch_size=8)
    runs = []
    for k, K in enumerate((None, 4)):
        def make(**kw):
            return Trainer(_model(dropout), max_epochs=3, warmup_epochs=1, seed=5, device="cpu",
                           steps_per_dispatch=K, **kw)

        # a shuffled loader of its own: each pass over one reshuffles
        loader = DataLoader(ds, batch_size=8, shuffle=True, seed=3)
        runs.append(_fit(make, loader, val, tmp_path / str(k)))
    assert runs[1].steps_per_dispatch == 4
    _assert_same_fits(*runs, (tmp_path / "0", tmp_path / "1"))


def test_mab_trainer_takes_steps_per_dispatch(data_dir, tmp_path):
    from chemprop_tpu_torch.cli import mab as tmab
    from chemprop_tpu_torch.cli.main import construct_parser
    from chemprop_tpu_torch.data import MolAtomBondDataset
    from test_torch_mab import _train_args

    args = _train_args(construct_parser, data_dir, "regression", "--device", "cpu")
    ds = MolAtomBondDataset(tmab.build_MAB_datapoints(args)[0])
    for kind in ("mol", "atom", "bond"):
        ds.normalize_targets(kind)
    loader = DataLoader(ds, batch_size=4)
    runs = []
    for k, K in enumerate((None, 4)):
        def make(**kw):
            model = tmab.build_MAB_model(args, ds, [None] * 3)
            return MABTrainer(model, max_epochs=2, warmup_epochs=1, seed=2, device="cpu",
                              steps_per_dispatch=K, **kw)

        runs.append(_fit(make, loader, None, tmp_path / str(k)))
    _assert_same_fits(*runs, (tmp_path / "0", tmp_path / "1"))


def test_a_value_the_jax_trainer_refuses_raises_in_both(rows):
    field = {f.name: f for f in dataclasses.fields(JaxTrainer)}["steps_per_dispatch"]
    assert field.default is None
    assert {f.name: f for f in dataclasses.fields(Trainer)}["steps_per_dispatch"].default is None
    jds = jdata.MoleculeDataset([jdata.MoleculeDatapoint.from_smi(s, y=np.array([y]))
                                 for s, y in rows[:8]])
    jmodel = JaxMPNN(message_passing=JaxBondMP(d_h=8, depth=1), agg=JaxMean(),
                     predictor=JaxRegressionFFN(input_dim=8, hidden_dim=8))
    with pytest.raises(ValueError, match="invalid literal for int"):
        JaxTrainer(jmodel, max_epochs=1, steps_per_dispatch="four").fit(
            jdata.DataLoader(jds, batch_size=8, prefetch=0))
    trainer = Trainer(_model(0.0), max_epochs=1, device="cpu", steps_per_dispatch="four")
    with pytest.raises(ValueError, match="invalid literal for int"):
        trainer.fit(DataLoader(_dataset(rows[:8]), batch_size=8))
    assert not trainer.history  # refused before the first step
