"""The port's edge-partitioned training and inference
(``chemprop_tpu_torch/parallel/partitioned_mp.py``) against the JAX
package's (``chemprop_tpu/parallel/partitioned_mp.py``) under ``shard_map``
on the test session's host devices: the forward and one Adam step of a real
featurised giant molecule (``"C1(CCCCC1)" * 180``, 1080 atoms, more than a
tile) cut into S local shards, with bond and atom message passing,
``undirected``, atom and molecule descriptors with their evaluation
transforms and a graph transform, learned fingerprints (``encode_index``)
and mixed routing (small molecules on the dense path). The JAX package's
initial parameters are carried across with ``from_jax_params``. Small size:
d_h 48, depth 3."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from chemprop_tpu.data import MoleculeDatapoint as JaxDatapoint
from chemprop_tpu.data.collate import collate_batch as jax_collate
from chemprop_tpu.data.datasets import Datum as JaxDatum
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.nn import AtomMessagePassing as JaxAtomMP
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import NormAggregation as JaxNorm
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.nn.transforms import GraphTransform as JaxGraphTransform
from chemprop_tpu.nn.transforms import ScaleTransform as JaxScaleTransform
from chemprop_tpu.parallel import partitioned_mp as jpm
from chemprop_tpu.train.trainer import TrainState as JaxTrainState
from chemprop_tpu_torch.data.datasets import Datum
from chemprop_tpu_torch.models import MPNN, from_jax_params
from chemprop_tpu_torch.nn import (
    AtomMessagePassing, BondMessagePassing, MeanAggregation, NormAggregation, RegressionFFN,
)
from chemprop_tpu_torch.nn.transforms import GraphTransform, ScaleTransform
from chemprop_tpu_torch.parallel import partitioned_mp as tpm
from chemprop_tpu_torch.train.trainer import TrainState

GIANT = "C1(CCCCC1)" * 180
SMALL = ["CCO", "c1ccccc1O", "CC(=O)N"]
D_H = 48
LR = 1e-3
D_VD, D_XD = 3, 2
# f32 on both sides; sums over a thousand atoms in other orders
FWD_TOL = 2e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mgs():
    feat = SimpleMoleculeMolGraphFeaturizer()
    return [feat(JaxDatapoint.from_smi(s).mol) for s in [GIANT] + SMALL]


class _Scaler:
    def __init__(self, mean, scale):
        self.mean_, self.scale_ = np.asarray(mean, np.float32), np.asarray(scale, np.float32)


def _scalers():
    rng = np.random.default_rng(5)
    return {k: _Scaler(rng.standard_normal(n), rng.uniform(0.5, 2.0, n))
            for k, n in (("V_d", D_VD), ("X_d", D_XD), ("V_f", 3))}


def _models(kind: str):
    """The JAX and the port's model of a configuration."""
    atom, undirected, desc = kind == "atom", kind == "undirected", kind == "descriptors"
    sc = _scalers()
    j_mp_cls, t_mp_cls = (JaxAtomMP, AtomMessagePassing) if atom else (JaxBondMP,
                                                                      BondMessagePassing)
    jkw, tkw = dict(d_h=D_H, depth=3, undirected=undirected), dict(d_h=D_H, depth=3,
                                                                  undirected=undirected)
    in_dim = D_H
    if desc:
        # the last 3 of the 72 atom features stand in for extra features
        jkw.update(d_vd=D_VD, V_d_transform=JaxScaleTransform.from_standard_scaler(sc["V_d"]),
                   graph_transform=JaxGraphTransform(
                       JaxScaleTransform.from_standard_scaler(sc["V_f"], pad=69), None))
        tkw.update(d_vd=D_VD, V_d_transform=ScaleTransform.from_standard_scaler(sc["V_d"]),
                   graph_transform=GraphTransform(
                       ScaleTransform.from_standard_scaler(sc["V_f"], pad=69), None))
        in_dim = D_H + D_VD + D_XD
    jagg, tagg = (JaxNorm(), NormAggregation()) if kind == "norm" else (JaxMean(),
                                                                       MeanAggregation())
    jmodel = JaxMPNN(message_passing=j_mp_cls(**jkw), agg=jagg,
                     predictor=JaxRegressionFFN(input_dim=in_dim, hidden_dim=D_H),
                     X_d_transform=JaxScaleTransform.from_standard_scaler(sc["X_d"]) if desc
                     else None)
    model = MPNN(t_mp_cls(**tkw), tagg,
                 RegressionFFN(input_dim=in_dim, hidden_dim=D_H, output_transform=False),
                 X_d_transform=ScaleTransform.from_standard_scaler(sc["X_d"]) if desc else None)
    return jmodel, model


def _data(mgs, kind: str):
    """JAX's and the port's Datum rows: the giant molecule, then the small
    ones (with seeded descriptors for the descriptor model)."""
    rng = np.random.default_rng(11)
    rows_j, rows_t = [], []
    for mg in mgs:
        V_d = rng.standard_normal((mg.V.shape[0], D_VD)).astype(np.float32)
        x_d = rng.standard_normal(D_XD).astype(np.float32)
        y = np.array([1.5], np.float32)
        if kind != "descriptors":
            V_d = x_d = None
        rows_j.append(JaxDatum(mg, V_d, x_d, y, 1.0, None, None))
        rows_t.append(Datum(mg, V_d, x_d, y, 1.0, None, None))
    return rows_j, rows_t


def _init(jmodel, model, rows_j):
    batch = jax_collate(rows_j[:1])
    variables = jmodel.init(jax.random.PRNGKey(0), batch.bmg, batch.V_d, batch.X_d,
                            is_training=False)
    model.load_state_dict(from_jax_params(variables["params"], variables.get("batch_stats")),
                          strict=False)
    return variables


def _jax_mesh(S):
    return JaxMesh(np.array(jax.devices()[:S]), ("data",))


@pytest.mark.parametrize("kind,S", [("bond", 2), ("bond", 4), ("atom", 4), ("undirected", 4),
                                    ("descriptors", 4), ("norm", 2)])
def test_forward_matches_jax(mgs, kind, S):
    jmodel, model = _models(kind)
    rows_j, rows_t = _data(mgs, kind)
    variables = _init(jmodel, model, rows_j)
    jg, jdims = jpm.build_partitioned_graph(rows_j[0].mg, S, V_d=rows_j[0].V_d)
    x_d = None if rows_j[0].x_d is None else rows_j[0].x_d.reshape(1, -1)
    want = np.asarray(jpm.make_partitioned_apply(jmodel, _jax_mesh(S), jdims)(
        variables, jg, None if x_d is None else jnp.asarray(x_d)))
    g, dims = tpm.build_partitioned_graph(rows_t[0].mg, S, V_d=rows_t[0].V_d)
    assert dims == tuple(jdims)
    dg = tpm.place(g, dims, tpm.LocalExchange(S), "cpu")
    got = tpm.make_partitioned_apply(model, S, dims)(
        dg, None if x_d is None else torch.from_numpy(x_d)).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    # and the port's own single-device forward of the molecule
    from chemprop_tpu_torch.data.collate import collate_batch

    b = collate_batch(rows_t[:1])
    with torch.inference_mode():
        dense = model(b.bmg, b.V_d, b.X_d)[:1].numpy()
    np.testing.assert_allclose(got, dense, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("kind", ["bond", "atom", "undirected", "descriptors"])
def test_train_step_matches_jax(mgs, kind):
    S = 4
    jmodel, model = _models(kind)
    rows_j, rows_t = _data(mgs, kind)
    variables = _init(jmodel, model, rows_j)
    y = np.array([[1.5]], np.float32)
    x_d = None if rows_j[0].x_d is None else rows_j[0].x_d.reshape(1, -1)
    tx = optax.adam(LR)
    jg, jdims = jpm.build_partitioned_graph(rows_j[0].mg, S, V_d=rows_j[0].V_d)
    jstate = JaxTrainState(params=jax.tree.map(lambda a: jnp.array(np.asarray(a)),
                                               variables["params"]),
                           batch_stats={}, opt_state=tx.init(variables["params"]),
                           step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    jstep = jpm.make_partitioned_train_step(jmodel, tx, _jax_mesh(S), jdims)
    jstate, jloss = jstep(jstate, jg, jnp.asarray(y), jnp.ones(1),
                          None if x_d is None else jnp.asarray(x_d))
    want = from_jax_params(jstate.params, None)

    g, dims = tpm.build_partitioned_graph(rows_t[0].mg, S, V_d=rows_t[0].V_d)
    dg = tpm.place(g, dims, tpm.LocalExchange(S), "cpu")
    params = dict(model.named_parameters())
    state = TrainState(params, {}, [torch.zeros_like(p) for p in params.values()],
                       [torch.zeros_like(p) for p in params.values()], 0,
                       torch.Generator().manual_seed(0))
    step = tpm.make_partitioned_train_step(model, S, dims, lr=LR)
    loss = step(state, dg, torch.from_numpy(y), torch.ones(1),
                None if x_d is None else torch.from_numpy(x_d))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.step == 1
    n_bad = n_all = 0
    for name, w in want.items():
        if name not in params:
            continue
        err = (params[name].detach() - w).abs()
        # Adam's first step moves each weight by about LR times its
        # gradient's sign: where a gradient is at the level of rounding the
        # sign may differ, by 2 LR at most
        assert float(err.max()) <= 2 * LR + 1e-6, name
        n_bad += int((err > 1e-6 + 1e-4 * w.abs()).sum())
        n_all += err.numel()
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)


def test_zero_dropout_is_the_deterministic_step(mgs):
    """A model of dropout 0 takes the same step with a shard generator and
    without."""
    S = 2
    results = []
    for gen in (None, torch.Generator().manual_seed(3)):
        torch.manual_seed(0)
        _, model = _models("bond")
        rows_t = _data(mgs, "bond")[1]
        g, dims = tpm.build_partitioned_graph(rows_t[0].mg, S)
        dg = tpm.place(g, dims, tpm.LocalExchange(S), "cpu")
        params = dict(model.named_parameters())
        state = TrainState(params, {}, [torch.zeros_like(p) for p in params.values()],
                           [torch.zeros_like(p) for p in params.values()], 0,
                           torch.Generator().manual_seed(0), shard_rng=gen)
        loss = tpm.make_partitioned_train_step(model, S, dims)(state, dg, torch.ones(1, 1),
                                                               torch.ones(1))
        results.append((float(loss), {k: v.detach().clone() for k, v in params.items()}))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(results[0][1][k], results[1][1][k]) for k in results[0][1])


@pytest.mark.parametrize("encode_index", [None, 0, 1], ids=["preds", "encode0", "encode1"])
def test_mixed_inference_matches_jax(mgs, encode_index):
    """The giant molecule partitioned, the small ones (which no plan over 4
    shards takes) on the dense path, rows in input order."""
    S = 4
    jmodel, model = _models("bond")
    rows_j, rows_t = _data(mgs, "bond")
    variables = _init(jmodel, model, rows_j)
    jsession = jpm.PartitionedInference(jmodel, rows_j, n_shards=S, encode_index=encode_index)
    want = jsession.run(variables)
    session = tpm.PartitionedInference(model, rows_t, n_shards=S, encode_index=encode_index,
                                       device="cpu")
    assert session.keys == jsession.keys and session.keys[1:] == [None] * len(SMALL)
    got = session.run(model)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_scope_checks():
    """Batch norm, the attentive readout and a multicomponent model are
    refused with the JAX package's reasons; entry points need a device."""
    from chemprop_tpu_torch.nn import AttentiveAggregation

    bn = MPNN(BondMessagePassing(d_h=D_H), MeanAggregation(),
              RegressionFFN(input_dim=D_H, hidden_dim=D_H), batch_norm=True)
    with pytest.raises(ValueError, match="batch-norm"):
        tpm.check_partitionable(bn)
    att = MPNN(BondMessagePassing(d_h=D_H), AttentiveAggregation(D_H),
               RegressionFFN(input_dim=D_H, hidden_dim=D_H))
    with pytest.raises(ValueError, match="mean/sum/norm"):
        tpm.check_partitionable(att)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpm.PartitionedInference(_models("bond")[1], [], n_shards=2)
