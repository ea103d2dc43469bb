"""The port's data-parallel training over a process group
(``chemprop_tpu_torch/parallel``) against the JAX package's
(``chemprop_tpu/parallel``), on the CPU over gloo:

* ``partition_shards`` and ``collate_sharded`` give JAX's groups and JAX's
  stacked shard k on rank k, single- and multicomponent; a plain batch cut
  on the host gives the same shard; mol-atom-bond rows with shards are
  refused, as in JAX;
* three Adam steps with batch norm at world size 2 (two spawned ranks)
  against JAX's ``make_sharded_train_step`` on a 2-device mesh, at
  ``test_torch_train.py``'s limits; the ranks' evaluation and predictions;
* world size 1 in this process: bit-equal to the plain ``Trainer``;
* a world-3 run of ``halo_message`` and of the partitioned forward and step
  (the process-group exchange, a middle rank with two neighbours) equal to
  the local exchange's.

Each spawned run has its own time limit. Small size: d_h 48, depth 3."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from chemprop_tpu import data as jdata
from chemprop_tpu.data.collate import collate_sharded as jax_collate_sharded
from chemprop_tpu.data.collate import partition_shards as jax_partition_shards
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.parallel.sharding import replicate as jax_replicate
from chemprop_tpu.train import Trainer as JaxTrainer
from chemprop_tpu.train.schedulers import noam_lr_host
from chemprop_tpu_torch.data import DataLoader, MoleculeDatapoint, MoleculeDataset
from chemprop_tpu_torch.data.collate import (
    collate_batch, collate_sharded, partition_shards, shard_of_batch,
)
from chemprop_tpu_torch.models import from_jax_params

REPO = Path(__file__).resolve().parent.parent
RANKS = Path(__file__).resolve().parent / "torch_ranks.py"
sys.path.insert(0, str(RANKS.parent))
import torch_ranks  # noqa: E402

D_H = torch_ranks.D_H
SPAWN_LIMIT_S = 120
THREE_LRS = sum(noam_lr_host(k, 8, 192, 1e-4, 1e-3, 1e-4) for k in range(3))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rows(data_dir):
    import csv

    with open(data_dir / "regression" / "mol" / "mol.csv") as f:
        return [(s, float(y)) for s, y in list(csv.reader(f))[1:]]


@pytest.fixture(scope="module")
def datasets(rows):
    jds = jdata.MoleculeDataset([jdata.MoleculeDatapoint.from_smi(s, y=np.array([y]))
                                 for s, y in rows])
    tds = torch_ranks.lipo_dataset()
    jds.normalize_targets()
    jds.cache = True
    return jds, tds


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(case: str, world: int, out_dir: Path) -> list[dict]:
    """Run ``torch_ranks.py CASE`` as ``world`` ranks with torchrun's
    variables; each rank's saved results, rank by rank."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, str(RANKS), case, str(out_dir)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=SPAWN_LIMIT_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, outs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(out_dir / f"{case}_{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------- collate
def _check_shard(tb, jb, k):
    for f in ("V", "E", "src", "dst", "rev", "batch", "node_mask", "edge_mask"):
        np.testing.assert_array_equal(getattr(tb.bmg, f).numpy(), np.asarray(getattr(jb.bmg, f))[k],
                                      err_msg=f)
    np.testing.assert_array_equal(tb.Y.numpy(), np.asarray(jb.Y)[k])
    np.testing.assert_array_equal(tb.w.numpy(), np.asarray(jb.w)[k])


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_partition_shards_equal_jax(n_shards):
    sizes = np.random.default_rng(n_shards).integers(2, 90, 37)
    assert partition_shards(sizes, n_shards) == jax_partition_shards(sizes, n_shards)


@pytest.mark.parametrize("n_shards,n_rows", [(2, 32), (3, 32), (4, 3)],
                         ids=["2x32", "3x32", "4x3_empty_shard"])
def test_collate_sharded_equals_jax(datasets, n_shards, n_rows):
    """Rank k's shard is JAX's stacked shard k; a shard left without graphs
    is all padding; the host cut of the plain batch is the same shard."""
    jds, tds = datasets
    jrows = [jds[i] for i in range(n_rows)]
    trows = [tds[i] for i in range(n_rows)]
    jb = jax_collate_sharded(jrows, n_shards)
    plain = collate_batch(trows)
    for k in range(n_shards):
        shard = collate_sharded(trows, n_shards, shard_index=k)
        _check_shard(shard.batch, jb, k)
        cut = shard_of_batch(plain, n_shards, k)
        assert cut.groups == shard.groups
        _check_shard(cut.batch, jb, k)
    if n_rows < n_shards:
        assert not shard.batch.bmg.edge_mask.any() and not (shard.batch.w > 0).any()


def test_collate_sharded_multicomponent_equals_jax(data_dir):
    from chemprop_tpu.data import MulticomponentDataset as JaxMulti
    from chemprop_tpu_torch.data import MulticomponentDataset

    import csv

    with open(data_dir / "regression" / "mol+mol" / "mol+mol.csv") as f:
        table = list(csv.reader(f))[1:12]
    j_comps = [jdata.MoleculeDataset([jdata.MoleculeDatapoint.from_smi(r[c], y=np.array([1.0]))
                                      for r in table]) for c in (0, 1)]
    t_comps = [MoleculeDataset([MoleculeDatapoint.from_smi(r[c], y=np.array([1.0]))
                                for r in table]) for c in (0, 1)]
    jm, tm = JaxMulti(j_comps), MulticomponentDataset(t_comps)
    jb = jax_collate_sharded([jm[i] for i in range(len(table))], 3)
    for k in range(3):
        tb = collate_sharded([tm[i] for i in range(len(table))], 3, shard_index=k).batch
        for c in range(2):
            for f in ("V", "E", "src", "dst", "rev", "batch"):
                np.testing.assert_array_equal(getattr(tb.bmg[c], f).numpy(),
                                              np.asarray(getattr(jb.bmg[c], f))[k])


def test_loader_shards_and_refuses_mab_rows(datasets, data_dir):
    """The loader yields rank k's shard of each batch; mol-atom-bond rows
    with shards are refused as the JAX loader refuses them."""
    from chemprop_tpu_torch.data import MolAtomBondDatapoint, MolAtomBondDataset

    _, tds = datasets
    jds = datasets[0]
    jb = next(iter(jdata.DataLoader(jds, batch_size=32, prefetch=0, n_shards=2)))
    for k in range(2):
        shard = next(iter(DataLoader(tds, batch_size=32, n_shards=2, shard_index=k)))
        assert shard.index == k and shard.n_shards == 2
        _check_shard(shard.batch, jb, k)
    dp = MolAtomBondDatapoint.from_smi("CCO", atom_y=np.zeros((3, 1)))
    with pytest.raises(NotImplementedError, match="sharded MAB batches"):
        next(iter(DataLoader(MolAtomBondDataset([dp]), batch_size=4, n_shards=2)))


# ------------------------------------------------------------ sharded steps
def _jax_sharded_steps(jds):
    """JAX's three sharded steps on a 2-device mesh: the initial parameters,
    the losses and the final state."""
    from chemprop_tpu.parallel.shard_train import local_shard

    mesh = JaxMesh(np.array(jax.devices()[:2]), ("data",))
    jmodel = JaxMPNN(message_passing=JaxBondMP(d_h=D_H, depth=3), agg=JaxMean(),
                     predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H), batch_norm=True,
                     bn_axis="data")
    loader = jdata.DataLoader(jds, batch_size=32, shuffle=False, prefetch=0, n_shards=2)
    batches = list(loader)[:3]
    trainer = JaxTrainer(jmodel, max_epochs=50, warmup_epochs=2, seed=12, mesh=mesh,
                         sharded=True)
    state = trainer.init_state(local_shard(batches[0]), len(loader))
    init = from_jax_params(state.params, state.batch_stats)
    state = jax_replicate(state, mesh)
    step = trainer._make_train_step()
    losses = []
    for b in batches:
        state, loss = step(state, b)
        losses.append(float(loss))
    return init, losses, from_jax_params(state.params, state.batch_stats)


def test_three_sharded_steps_world_2_match_jax(datasets, tmp_path):
    jds, tds = datasets
    init, jlosses, want = _jax_sharded_steps(jds)
    torch.save(init, tmp_path / "init.pt")
    ranks = spawn("sharded_steps", 2, tmp_path)
    # the f32 arithmetic of test_torch_train.py; only summation orders differ
    np.testing.assert_allclose(ranks[0]["losses"], jlosses, rtol=1e-5)
    got = ranks[0]["state"]
    n_bad = n_all = 0
    for name in want:
        for r in ranks[1:]:  # replicated: every rank holds the same state
            assert torch.equal(r["state"][name], got[name]), name
        err = (got[name] - want[name]).abs()
        assert float(err.max()) <= 2 * THREE_LRS, name
        n_bad += int((err > 1e-6 + 1e-4 * want[name].abs()).sum())
        n_all += err.numel()
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)
    # evaluation sums the ranks' states; predictions come back in row order
    assert ranks[0]["val_loss"] == ranks[1]["val_loss"]
    np.testing.assert_array_equal(ranks[0]["preds"], ranks[1]["preds"])
    from chemprop_tpu_torch.train import Trainer

    model = torch_ranks.sharded_model()
    plain = Trainer(model, seed=12, device="cpu")
    plain.init_state(None, 4)
    model.load_state_dict(got)
    np.testing.assert_allclose(ranks[0]["preds"], plain.predict(DataLoader(tds, batch_size=32)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["val_loss"],
                               plain.evaluate(DataLoader(tds, batch_size=32)), rtol=1e-5)


def test_world_1_is_bit_equal_to_the_plain_trainer(datasets):
    """A group of one over gloo in this process: the sharded step's losses
    and parameters are the plain trainer's, bit for bit."""
    from chemprop_tpu_torch.parallel import (
        distributed, make_mesh, make_sharded_apply, make_sharded_eval_step,
    )
    from chemprop_tpu_torch.train import Trainer

    _, tds = datasets
    batches = list(DataLoader(tds, batch_size=32))[:3]
    runs = []
    mesh = make_mesh(device="cpu")
    try:
        for m in (None, mesh):
            torch.manual_seed(0)
            model = torch_ranks.sharded_model()
            trainer = Trainer(model, seed=12, mesh=m, device="cpu")
            trainer.init_state(None, 4)
            losses = [trainer.train_step(b) for b in batches]
            runs.append((losses, {k: v.clone() for k, v in model.state_dict().items()},
                         trainer.predict(DataLoader(tds, batch_size=32))))
        # the library's steps: the criterion's state and the rows of a batch
        state, val = make_sharded_eval_step(model, model.criterion, mesh)(batches[0])
        assert float(model.criterion.compute(state)) == trainer.evaluate([batches[0]])
        rows = make_sharded_apply(model, mesh)(batches[0])
        np.testing.assert_array_equal(rows, runs[1][2][:32])
        assert val.shape == (32, 1)
    finally:
        distributed.shutdown()
    (l0, s0, p0), (l1, s1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    np.testing.assert_array_equal(p0, p1)


def test_group_exchange_world_3_equals_local(tmp_path):
    """halo_message in both phases, and the partitioned forward and step of
    the giant molecule, over a 3-rank gloo group: the local exchange's
    numbers."""
    from chemprop_tpu_torch.ops.edge_partition import LocalExchange

    ranks = spawn("halo", 3, tmp_path)
    want = torch_ranks.halo_case(LocalExchange(3), [0, 1, 2])
    for key in ("M_False", "dH_False", "M_True", "dH_True"):
        got = torch.cat([r[key] for r in ranks])
        torch.testing.assert_close(got, want[key], rtol=1e-5, atol=1e-5, msg=key)
    for r in ranks:
        torch.testing.assert_close(r["preds"], want["preds"], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(r["loss"], want["loss"], rtol=1e-5, atol=1e-6)
        for k, v in want["params"].items():
            torch.testing.assert_close(r["params"][k], v, rtol=1e-4, atol=1e-6, msg=k)


def test_entry_points_need_a_device(monkeypatch):
    """Without a GPU, the group, the sharded trainer and the partitioned
    session raise unless given the CPU."""
    from chemprop_tpu_torch.parallel import distributed, make_mesh
    from chemprop_tpu_torch.parallel.partitioned_mp import PartitionedInference
    from chemprop_tpu_torch.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize()
    model = torch_ranks.giant_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PartitionedInference(model, [])
    with pytest.raises(ValueError, match="sharded=True requires a mesh"):
        Trainer(model, sharded=True, device="cpu")
