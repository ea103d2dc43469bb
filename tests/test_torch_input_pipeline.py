"""The port's training input pipeline against the JAX package's, on the CPU.

* the loader's batches with ``prefetch`` 0 and 2 are equal bit for bit and
  in the same order (every tensor, table and count), for plain,
  multicomponent and mol-atom-bond rows and for shards 0 and 1 of
  ``n_shards=2``; and equal, field by field, to the JAX loader's batches at
  ``prefetch=2`` on the same rows (the graph tables both packages have, the
  extra inputs, targets, weights and bounds; JAX's shard ``k`` of its
  stacked shards);
* a ``fit`` of the port and one of the JAX package on the same rows, both
  loaders at ``prefetch=2``, from JAX's initial parameters: the losses within
  rtol 1e-5 and the parameters to the limits of
  ``test_torch_train.py::test_three_adam_steps_match_jax_f32``, scaled to the
  steps taken;
* fault (i) of ``ROADMAP.md``: ``collate_batch(data, pad, n_targets)``,
  ``collate_sharded(data, n, pad, n_targets)``,
  ``get_activation_function(activation=...)`` and
  ``segment_softmax_weights(logits, segment_ids=...)`` take the JAX
  package's keywords with its meaning, and give its results.

Small sizes: d_h 32, tens of molecules."""

from __future__ import annotations

import csv
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chemprop_tpu_torch.data as tdata
from chemprop_tpu import data as jdata
from chemprop_tpu.cli import mab as jmab
from chemprop_tpu.cli.main import construct_parser as jax_parser
from chemprop_tpu.data.collate import collate_batch as jax_collate_batch
from chemprop_tpu.data.collate import collate_sharded as jax_collate_sharded
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.nn.utils import get_activation_function as jax_activation
from chemprop_tpu.ops.segment import segment_softmax_weights as jax_segment_softmax
from chemprop_tpu.train import Trainer as JaxTrainer
from chemprop_tpu_torch.cli import mab as tmab
from chemprop_tpu_torch.cli.main import construct_parser
from chemprop_tpu_torch.cli.train import _draw_first_batch
from chemprop_tpu_torch.data import DataLoader, MolAtomBondDataset, MulticomponentDataset, PadSpec
from chemprop_tpu_torch.data.collate import BatchMolGraph, collate_batch, collate_sharded
from chemprop_tpu_torch.models import MPNN, from_jax_params
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.nn.utils import get_activation_function
from chemprop_tpu_torch.ops.segment import segment_softmax_weights
from chemprop_tpu_torch.train import Trainer, noam_lr

D_H = 32
N_ROWS = 40
GRAPH = ("V", "E", "src", "dst", "rev", "batch", "node_mask", "edge_mask")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(path: Path, n: int) -> list[list[str]]:
    with open(path, newline="") as f:
        return list(csv.reader(f))[1 : n + 1]


def _molecules(pkg, rows, column: int = 0, y: bool = True):
    return pkg.MoleculeDataset([pkg.MoleculeDatapoint.from_smi(
        r[column], y=np.array([float(r[1])]) if y else np.array([1.0])) for r in rows])


def _mab_datasets(data_dir: Path):
    """Both packages' datasets of the three-head MAB CSV (11 molecules)."""
    mab = data_dir / "mol_atom_bond"
    argv = ["train", "-i", str(mab / "regression.csv"), "--keep-h", "--reorder-atoms",
            "--mol-target-columns", "mol_y1", "mol_y2", "--atom-target-columns", "atom_y1",
            "atom_y2", "--bond-target-columns", "bond_y1", "bond_y2"]
    out = []
    for parse, module, pkg, extra in ((jax_parser, jmab, jdata, []),
                                      (construct_parser, tmab, None, ["--device", "cpu"])):
        args = parse().parse_args(argv + extra)
        args.data_path = Path(args.data_path[0]) if isinstance(args.data_path, list) \
            else args.data_path
        args.target_columns = args.mol_target_columns
        points = module.build_MAB_datapoints(args)[0]
        out.append(jdata.MolAtomBondDataset(points) if pkg else MolAtomBondDataset(points))
    return out


def _datasets(case: str, data_dir: Path):
    """Each package's dataset of one kind of row, and the loader arguments."""
    if case == "multicomponent":
        rows = _read(data_dir / "regression" / "mol+mol" / "mol+mol.csv", 16)
        jds = jdata.MulticomponentDataset([_molecules(jdata, rows, c, y=False) for c in (0, 1)])
        tds = MulticomponentDataset([_molecules(tdata, rows, c, y=False) for c in (0, 1)])
        return jds, tds, dict(batch_size=5)
    if case == "mab":
        return (*_mab_datasets(data_dir), dict(batch_size=4))
    rows = _read(data_dir / "regression" / "mol" / "mol.csv", N_ROWS)
    jds, tds = _molecules(jdata, rows), _molecules(tdata, rows)
    kwargs = dict(batch_size=8, shuffle=True, seed=3)
    if case.startswith("shard"):
        kwargs.update(n_shards=2)
    return jds, tds, kwargs


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal_batches(a, b, where=""):
    """Two port batches (or shards) equal bit for bit: every field, every
    table, every count; NaN where NaN."""
    if isinstance(a, BatchMolGraph):
        assert isinstance(b, BatchMolGraph), where
        for name in a.__dataclass_fields__:
            _assert_equal_batches(getattr(a, name), getattr(b, name), f"{where}.{name}")
    elif isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_batches(x, y, f"{where}[{i}]")
    elif isinstance(a, (torch.Tensor, np.ndarray)):
        assert type(a) is type(b) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(_host(a), _host(b), err_msg=where)
    else:
        assert a == b, where


def _assert_equal_to_jax(t, j, shard: int | None, where=""):
    """A port batch equal to the JAX package's, field by field (JAX's stacked
    shard ``shard`` where given): the graph tables both packages have, and
    every field of the batch that both name."""
    pick = (lambda x: np.asarray(x)) if shard is None else (lambda x: np.asarray(x)[shard])
    if t is None:
        assert j is None, where
    elif isinstance(t, BatchMolGraph):
        for name in GRAPH:
            np.testing.assert_array_equal(_host(getattr(t, name)), pick(getattr(j, name)),
                                          err_msg=f"{where}.{name}")
    elif hasattr(t, "_fields"):
        shared = [f for f in t._fields if f in j._fields]
        assert {"bmg"} <= set(shared), where
        for name in shared:
            _assert_equal_to_jax(getattr(t, name), getattr(j, name), shard, f"{where}.{name}")
    elif isinstance(t, tuple):
        assert len(t) == len(j), where
        for i, (x, y) in enumerate(zip(t, j)):
            _assert_equal_to_jax(x, y, shard, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(_host(t), pick(j), err_msg=where)


@pytest.mark.parametrize("case", ["plain", "multicomponent", "mab", "shard0", "shard1"])
def test_prefetched_batches_equal_inline_ones_and_jax(data_dir, case):
    jds, tds, kwargs = _datasets(case, data_dir)
    shard = int(case[-1]) if case.startswith("shard") else None
    port = {k: list(DataLoader(tds, prefetch=k, shard_index=shard or 0, **kwargs))
            for k in (0, 2)}
    jax_batches = list(jdata.DataLoader(jds, prefetch=2, **kwargs))
    assert len(port[0]) == len(port[2]) == len(jax_batches) > 1
    for i, (a, b, j) in enumerate(zip(port[0], port[2], jax_batches)):
        _assert_equal_batches(a, b, f"batch {i}")
        if shard is not None:
            assert (a.index, a.n_shards) == (shard, 2)
            a = a.batch
        _assert_equal_to_jax(a, j, shard, f"batch {i}")


def _models():
    jmodel = JaxMPNN(message_passing=JaxBondMP(d_h=D_H, depth=2), agg=JaxMean(),
                     predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H), batch_norm=True)
    model = MPNN(BondMessagePassing(d_h=D_H, depth=2), MeanAggregation(),
                 RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False),
                 batch_norm=True)
    return jmodel, model


def test_fit_with_both_prefetches_matches_jax(data_dir):
    """Two epochs of shuffled batches of 8 (one padding for every batch, so
    that JAX compiles one step), each package's loader at ``prefetch=2``."""
    jds, tds, kwargs = _datasets("plain", data_dir)
    for ds in (jds, tds):
        ds.normalize_targets()
        ds.cache = True
    pad = PadSpec(n_nodes=384, n_edges=768, n_graphs=8)
    jloader = jdata.DataLoader(jds, prefetch=2, pad_spec=jdata.PadSpec(384, 768, 8), **kwargs)
    tloader = DataLoader(tds, prefetch=2, pad_spec=pad, **kwargs)
    jmodel, model = _models()
    jtrainer = JaxTrainer(jmodel, max_epochs=2, warmup_epochs=1, seed=12)
    state = jtrainer.init_state(next(iter(jdata.DataLoader(
        jds, prefetch=0, pad_spec=jdata.PadSpec(384, 768, 8), batch_size=8))), len(jloader))
    trainer = Trainer(model, max_epochs=2, warmup_epochs=1, seed=12, device="cpu")
    trainer.init_state(None, len(tloader))
    model.load_state_dict(from_jax_params(state.params, state.batch_stats))
    jtrainer.fit(jloader)
    # JAX's fit draws one batch before its first epoch, which reshuffles; the
    # port's command line draws it where the JAX package does
    _draw_first_batch(tloader)
    trainer.fit(tloader)
    steps = 2 * len(tloader)
    assert trainer.state.step == int(jtrainer.state.step) == steps
    np.testing.assert_allclose([h["train_loss"] for h in trainer.history],
                               [h["train_loss"] for h in jtrainer.history], rtol=1e-5)
    # test_three_adam_steps_match_jax_f32's limits over this fit's steps: an
    # element whose gradient sits at rounding moves by up to the rate of
    # each step in either package's direction
    lrs = sum(noam_lr(k, *trainer._sched_args) for k in range(steps))
    want = from_jax_params(jtrainer.state.params, jtrainer.state.batch_stats)
    got = {k: v.detach() for k, v in model.state_dict().items()}
    assert set(got) == set(want)
    n_bad = n_all = 0
    for name in want:
        err = (got[name] - want[name]).abs()
        assert float(err.max()) <= 2 * lrs, name
        n_bad += int((err > 1e-6 + 1e-4 * want[name].abs()).sum())
        n_all += err.numel()
    assert n_bad < n_all / 1000, (n_bad, n_all)


# --------------------------------------------------------------- fault (i)
@pytest.fixture(scope="module")
def lipo_rows(data_dir):
    rows = _read(data_dir / "regression" / "mol" / "mol.csv", 12)
    return _molecules(jdata, rows), _molecules(tdata, rows)


def test_collate_batch_takes_n_targets(lipo_rows):
    jds, tds = lipo_rows
    pad = PadSpec(512, 1024, 16)
    for n_targets in (None, 1, 3):
        want = jax_collate_batch([jds[i] for i in range(12)], pad, n_targets)
        got = collate_batch([tds[i] for i in range(12)], pad, n_targets)
        assert got.Y.shape == np.asarray(want.Y).shape == (16, n_targets or 1)
        _assert_equal_to_jax(got, want, None)


def test_collate_sharded_takes_n_targets_fourth(lipo_rows):
    jds, tds = lipo_rows
    want = jax_collate_sharded([jds[i] for i in range(12)], 2, None, 2)
    for k in range(2):
        shard = collate_sharded([tds[i] for i in range(12)], 2, None, 2, shard_index=k)
        assert shard.batch.Y.shape[1] == 2
        _assert_equal_to_jax(shard.batch, want, k)
    with pytest.raises(ValueError, match="shard_index"):
        collate_sharded([tds[0]], 2, None, None, 2)


@pytest.mark.parametrize("activation", ["relu", "leakyrelu:0.1", "elu:0.5", "tanh"])
def test_get_activation_function_takes_activation(activation):
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    got = get_activation_function(activation=activation)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_activation(activation=activation)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    fn = torch.sigmoid
    assert get_activation_function(fn) is fn


def test_segment_softmax_weights_takes_segment_ids():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((9, 3)).astype(np.float32)
    ids = np.array([0, 0, 1, 1, 1, 3, 3, 3, 3], np.int32)
    got = segment_softmax_weights(torch.from_numpy(logits), segment_ids=torch.from_numpy(ids),
                                  num_segments=4)
    want = jax_segment_softmax(jnp.asarray(logits), segment_ids=jnp.asarray(ids), num_segments=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
