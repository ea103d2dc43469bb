"""The port's input pipeline on its own, on the CPU (this file imports
nothing of JAX):

* the loader's producer thread: its exception reaches the caller, in a loop
  and in ``fit``; a caller that stops early (``next(iter(loader))``, a
  ``break``, an exception of its own) leaves no producer thread behind,
  also where the producer is blocked on a full queue;
* ``Trainer.fit``'s device prefetch: it keeps two batches' copies ahead of
  the step; a fit gives the same losses and parameters bit for bit with the
  loader's ``prefetch`` 0 and 2, with and without dropout, and for the
  mol-atom-bond trainer, as a loop of ``train_step`` over the same batches;
* ``MoleculeDataset.n_workers``: caches featurised by 0 and by 2 worker
  processes are equal, for molecule and reaction datasets; the field is the
  dataclass's third, as in the JAX package, and ``build_dataloader(
  num_workers=2)`` sets it and leaves the cache as it found it. The pools
  fork from a fresh interpreter that imports nothing but the port (a
  subprocess), never from a test worker that holds JAX's threads."""

from __future__ import annotations

import csv
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from chemprop_tpu_torch.cli import mab as tmab
from chemprop_tpu_torch.cli.main import construct_parser
from chemprop_tpu_torch.data import (
    DataLoader, MolAtomBondDataset, MoleculeDatapoint, MoleculeDataset, build_dataloader,
)
from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.models import MPNN
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.train import Trainer
from chemprop_tpu_torch.train.mab_trainer import MABTrainer
from chemprop_tpu_torch.train.trainer import DevicePrefetch

REPO = Path(__file__).resolve().parent.parent
D_H = 32
N_ROWS = 40
JOIN_S = 5.0  # the longest a closed iterator's producer may take to end


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lipo(data_dir):
    with open(data_dir / "regression" / "mol" / "mol.csv") as f:
        rows = list(csv.reader(f))[1 : N_ROWS + 1]
    ds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=np.array([float(y)])) for s, y in rows])
    ds.normalize_targets()
    ds.cache = True
    return ds


def _producers() -> list[threading.Thread]:
    """The loader's live producer threads, each given ``JOIN_S`` to end."""
    live = [t for t in threading.enumerate() if t.name == "DataLoader-prefetch"]
    for t in live:
        t.join(JOIN_S)
    return [t for t in live if t.is_alive()]


class Failing(MoleculeDataset):
    """A dataset whose row ``bad`` raises when it is read."""

    bad = 13

    def __getitem__(self, idx):
        if idx == self.bad:
            raise KeyError(f"row {idx} is unreadable")
        return super().__getitem__(idx)


def test_a_producers_exception_reaches_the_caller(lipo):
    ds = Failing(lipo.data)
    ds.cache = True
    with pytest.raises(KeyError, match="row 13 is unreadable"):
        list(DataLoader(ds, batch_size=4, prefetch=2))
    trainer = Trainer(_model(0.0), max_epochs=1, device="cpu")
    with pytest.raises(KeyError, match="row 13 is unreadable"):
        trainer.fit(DataLoader(ds, batch_size=4, prefetch=2))
    assert not _producers()


@pytest.mark.parametrize("prefetch", [1, 2, 5])
def test_a_caller_that_stops_early_leaves_no_producer(lipo, prefetch):
    loader = DataLoader(lipo, batch_size=2, prefetch=prefetch)
    first = next(iter(loader))
    assert not _producers()
    for i, batch in enumerate(loader):
        if i == 3:
            break
    assert not _producers()
    with pytest.raises(RuntimeError, match="the caller's own"):
        for batch in loader:
            raise RuntimeError("the caller's own")
    assert not _producers()
    # the producer blocked on a full queue while the caller holds a batch
    it = iter(loader)
    held = next(it)
    it.close()
    assert not _producers()
    np.testing.assert_array_equal(first.Y.numpy(), held.Y.numpy())


def test_many_iterators_closed_at_random_points(lipo):
    """A stress of the close: 40 loaders at once, each stopped after a random
    number of batches, with a short switch interval, end every producer and
    yield the same batches as ``prefetch=0``."""
    want = [b.Y for b in DataLoader(lipo, batch_size=3, prefetch=0)]
    rng = np.random.default_rng(0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        iters = [iter(DataLoader(lipo, batch_size=3, prefetch=int(rng.integers(1, 4))))
                 for _ in range(40)]
        for it in iters:
            for k in range(int(rng.integers(0, len(want)))):
                np.testing.assert_array_equal(next(it).Y.numpy(), want[k].numpy())
            it.close()
    finally:
        sys.setswitchinterval(switch)
    assert not _producers()


def test_device_prefetch_keeps_two_copies_ahead():
    pulled = []

    def source():
        for k in range(6):
            pulled.append(k)
            yield k, torch.full((2,), float(k))

    got = []
    for k, batch in DevicePrefetch(torch.device("cpu")).feed(source()):
        got.append(k)
        assert pulled[-1] == min(k + 2, 5)  # batches k+1 and k+2 already put
        assert torch.equal(batch, torch.full((2,), float(k)))
    assert got == list(range(6))


def _model(dropout: float):
    return MPNN(BondMessagePassing(d_h=D_H, depth=2, dropout=dropout), MeanAggregation(),
                RegressionFFN(input_dim=D_H, hidden_dim=D_H, dropout=dropout,
                              output_transform=False), batch_norm=True)


def _plain_loop(trainer: Trainer, loader, epochs: int) -> list[float]:
    """``fit``'s epochs as a loop of ``train_step`` over the host batches."""
    trainer.init_state(None, len(loader))
    losses = []
    for _ in range(epochs):
        losses.append(float(torch.stack([trainer.train_step(b) for b in loader]).mean()))
    return losses


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_fit_equals_a_loop_of_train_step_with_either_prefetch(lipo, dropout):
    runs = []
    for prefetch in (0, 2):
        trainer = Trainer(_model(dropout), max_epochs=3, warmup_epochs=1, seed=4, device="cpu")
        trainer.fit(DataLoader(lipo, batch_size=8, shuffle=True, seed=5, prefetch=prefetch))
        runs.append(([h["train_loss"] for h in trainer.history], trainer.state))
    plain = Trainer(_model(dropout), max_epochs=3, warmup_epochs=1, seed=4, device="cpu")
    losses = _plain_loop(plain, DataLoader(lipo, batch_size=8, shuffle=True, seed=5, prefetch=0),
                         3)
    runs.append((losses, plain.state))
    (losses0, a), *others = runs
    for losses, b in others:
        assert losses == losses0
        assert a.step == b.step == 15
        for k, v in a.params.items():
            assert torch.equal(v, b.params[k]), k
        for k, v in a.batch_stats.items():
            assert torch.equal(v, b.batch_stats[k]), k


def test_mab_fit_with_either_prefetch(data_dir):
    mab = data_dir / "mol_atom_bond"
    args = construct_parser().parse_args([
        "train", "-i", str(mab / "regression.csv"), "--keep-h", "--reorder-atoms",
        "--mol-target-columns", "mol_y1", "mol_y2", "--atom-target-columns", "atom_y1",
        "atom_y2", "--bond-target-columns", "bond_y1", "bond_y2", "--message-hidden-dim",
        str(D_H), "--ffn-hidden-dim", "16", "--device", "cpu"])
    args.data_path = Path(args.data_path[0])
    args.target_columns = args.mol_target_columns
    ds = MolAtomBondDataset(tmab.build_MAB_datapoints(args)[0])
    for kind in ("mol", "atom", "bond"):
        ds.normalize_targets(kind)
    runs = []
    for prefetch in (0, 2):
        trainer = MABTrainer(tmab.build_MAB_model(args, ds, [None] * 3), max_epochs=2, warmup_epochs=1, seed=3, device="cpu")
        trainer.fit(DataLoader(ds, batch_size=4, shuffle=True, seed=1, prefetch=prefetch))
        runs.append(trainer)
    a, b = runs
    assert [h["train_loss"] for h in a.history] == [h["train_loss"] for h in b.history]
    for k, v in a.state.params.items():
        assert torch.equal(v, b.state.params[k]), k


def test_n_workers_is_the_third_field_and_build_dataloader_sets_it(lipo):
    ds = MoleculeDataset(lipo.data, SimpleMoleculeMolGraphFeaturizer(), 2)
    assert ds.n_workers == 2 and not ds.cache
    loader = build_dataloader(MoleculeDataset(lipo.data), batch_size=8, num_workers=3,
                              prefetch=0, shuffle=False)
    assert loader.dataset.n_workers == 3 and not loader.dataset.cache
    assert loader.prefetch == 0
    loader = build_dataloader(lipo, batch_size=8, num_workers=2)
    assert lipo.n_workers == 2 and lipo.cache and loader.prefetch == 2
    lipo.n_workers = 0


# the caches of 0 and 2 workers, made in a fresh interpreter: each dataset's
# graphs as lists of arrays, equal where every array is
WORKERS = r"""
import csv, json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
from chemprop_tpu_torch.data import (MoleculeDatapoint, MoleculeDataset, ReactionDatapoint,
                                     ReactionDataset)
assert "jax" not in sys.modules
torch.zeros(1)
data = sys.argv[2]
with open(f"{data}/regression/mol/mol.csv") as f:
    mols = [MoleculeDatapoint.from_smi(r[0]) for r in list(csv.reader(f))[1:61]]
with open(f"{data}/regression/rxn+mol/rxn+mol.csv") as f:
    rxns = [ReactionDatapoint.from_smi(r[0], keep_h=True) for r in list(csv.reader(f))[1:31]]
out = {}
for name, make in (("molecule", lambda n: MoleculeDataset(mols, n_workers=n)),
                   ("reaction", lambda n: ReactionDataset(rxns, n_workers=n))):
    caches = []
    for n in (0, 2):
        ds = make(n)
        ds.cache = True
        caches.append(ds._cache)
    serial, forked = caches
    out[name] = {
        "n": [len(serial), len(forked)],
        "equal": all(all(a.dtype == b.dtype and np.array_equal(a, b)
                         for a, b in zip(g, h, strict=True))
                     for g, h in zip(serial, forked, strict=True)),
    }
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def worker_caches(data_dir):
    done = subprocess.run([sys.executable, "-c", WORKERS, str(REPO), str(data_dir)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind,n", [("molecule", 60), ("reaction", 30)])
def test_caches_of_zero_and_two_workers_are_equal(worker_caches, kind, n):
    res = worker_caches[kind]
    assert res["n"] == [n, n] and res["equal"], res
