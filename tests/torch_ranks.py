"""One rank of the port's multi-process CPU tests (gloo), started by
``tests/test_torch_sharded.py`` once per rank with torchrun's variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``):

    python tests/torch_ranks.py CASE OUT_DIR

``sharded_steps``: three Adam steps of the batch-norm model of
``test_torch_sharded.py`` on this rank's shards of mol.csv's first three
batches, from ``OUT_DIR/init.pt``; ``halo``: ``halo_message`` (both phases)
and the partitioned forward and one step of the giant molecule with one
shard per rank. Each rank writes ``OUT_DIR/<case>_<rank>.pt``. No JAX here."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

D_H = 48


def sharded_model():
    from chemprop_tpu_torch.models import MPNN
    from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN

    return MPNN(BondMessagePassing(d_h=D_H, depth=3), MeanAggregation(),
                RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False),
                batch_norm=True)


def lipo_dataset():
    import csv

    from chemprop_tpu_torch.data import MoleculeDatapoint, MoleculeDataset

    with open(REPO / "tests" / "data" / "regression" / "mol" / "mol.csv") as f:
        rows = [(s, float(y)) for s, y in list(csv.reader(f))[1:]]
    ds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=np.array([y])) for s, y in rows])
    ds.normalize_targets()
    ds.cache = True
    return ds


def chain_plan(n_shards: int):
    """The 1200-node chain of ``test_torch_edge_partition.py``, cut."""
    from chemprop_tpu_torch.ops.edge_partition import partition_edges

    rng = np.random.default_rng(0)
    n = 1200
    bonds = [(i, i + 1) for i in range(n - 1)]
    for _ in range(n // 10):
        i = int(rng.integers(0, n - 4))
        bonds.append((i, i + int(rng.integers(2, 4))))
    pairs = [p for u, v in bonds for p in ((u, v), (v, u))]
    src, dst = np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs])
    rev = np.arange(len(pairs)).reshape(-1, 2)[:, ::-1].reshape(-1)
    order = np.argsort(dst, kind="stable")
    inv = np.argsort(order)
    return partition_edges(src[order], dst[order], inv[rev[order]], n, n_shards)


def giant_model(seed: int = 0):
    from chemprop_tpu_torch.models import MPNN
    from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN

    torch.manual_seed(seed)
    return MPNN(BondMessagePassing(d_h=D_H, depth=3), MeanAggregation(),
                RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False))


def giant_graph(n_shards: int):
    from chemprop_tpu_torch.data import MoleculeDatapoint
    from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer
    from chemprop_tpu_torch.parallel.partitioned_mp import build_partitioned_graph

    mg = SimpleMoleculeMolGraphFeaturizer()(MoleculeDatapoint.from_smi("C1(CCCCC1)" * 180).mol)
    return build_partitioned_graph(mg, n_shards)


def halo_case(exchange, held):
    """``halo_message`` of seeded tables in both phases, forward and the
    gradient of a seeded cotangent, then the giant molecule's partitioned
    forward and one step: everything for the held shards."""
    from chemprop_tpu_torch.ops import edge_partition as ep
    from chemprop_tpu_torch.parallel import partitioned_mp as pm
    from chemprop_tpu_torch.train.trainer import TrainState

    S = exchange.n_shards
    plan = chain_plan(S)
    tables = ep.HaloTables.from_plan(plan, held)
    rng = np.random.default_rng(1)
    H_all = rng.standard_normal((S, plan.P, 16)).astype(np.float32)
    g_all = rng.standard_normal((S, plan.P, 16)).astype(np.float32)
    out = {}
    for phase in (False, True):
        H = torch.from_numpy(H_all[held]).requires_grad_()
        M = ep.halo_message(H, tables, exchange, single_phase=phase)
        (dH,) = torch.autograd.grad(M, H, torch.from_numpy(g_all[held]))
        out[f"M_{phase}"], out[f"dH_{phase}"] = M.detach(), dH
    model = giant_model()
    g, dims = giant_graph(S)
    dg = pm.place(g, dims, exchange, "cpu")
    out["preds"] = pm.make_partitioned_apply(model, exchange, dims)(dg)
    params = dict(model.named_parameters())
    state = TrainState(params, {}, [torch.zeros_like(p) for p in params.values()],
                       [torch.zeros_like(p) for p in params.values()], 0,
                       torch.Generator().manual_seed(0))
    out["loss"] = pm.make_partitioned_train_step(model, exchange, dims)(
        state, dg, torch.full((1, 1), 1.5), torch.ones(1))
    out["params"] = {k: v.detach().clone() for k, v in params.items()}
    return out


def main() -> int:
    case, out_dir = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.ops.edge_partition import GroupExchange
    from chemprop_tpu_torch.parallel import distributed, make_mesh
    from chemprop_tpu_torch.train import Trainer

    mesh = make_mesh(device="cpu")
    try:
        if case == "sharded_steps":
            model = sharded_model()
            trainer = Trainer(model, max_epochs=50, warmup_epochs=2, seed=12, mesh=mesh,
                              sharded=True)
            ds = lipo_dataset()
            loader = DataLoader(ds, batch_size=32, n_shards=mesh.size, shard_index=mesh.rank)
            trainer.init_state(None, len(loader))
            model.load_state_dict(torch.load(out_dir / "init.pt"))
            losses = [float(trainer.train_step(b)) for b in list(loader)[:3]]
            out = {"losses": losses, "state": {k: v.detach().clone()
                                               for k, v in model.state_dict().items()},
                   "val_loss": trainer.evaluate(loader),
                   "preds": trainer.predict(DataLoader(ds, batch_size=32))}
        elif case == "halo":
            out = halo_case(GroupExchange(), [mesh.rank])
        else:
            raise ValueError(f"unknown case {case}")
        torch.save(out, out_dir / f"{case}_{mesh.rank}.pt")
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
