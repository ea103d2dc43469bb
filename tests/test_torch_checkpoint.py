"""The JAX package's ``CPTPU001`` checkpoint format in the port
(``models/serialize.py``, ``utils/msgpack_codec.py``), against the JAX
package on the CPU: the msgpack codec against ``flax.serialization`` both
ways; JAX's ``best.ckpt`` and ``last.ckpt`` loaded by the port (parameters,
batch-norm statistics, Adam's moments and count, the step; then three more
steps against JAX's); the port's files read by JAX's ``load_model``; the CLI
on a ``CPTPU001`` file; and a manifest the port cannot build. Small size:
the first 32 rows of mol.csv, d_h = 32, float32."""

from __future__ import annotations

import copy
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from chemprop_tpu import data as jdata
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.models import serialize as jserialize
from chemprop_tpu.models.torch_convert import convert_model
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.nn.agg import AttentiveAggregation as JaxAttentive
from chemprop_tpu.train import Trainer as JaxTrainer
from chemprop_tpu.train.schedulers import noam_lr_host
from chemprop_tpu_torch.cli.main import main
from chemprop_tpu_torch.data import DataLoader, MoleculeDatapoint, MoleculeDataset
from chemprop_tpu_torch.models import MPNN, from_jax_params, load_model, serialize
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.train import Trainer
from chemprop_tpu_torch.utils.msgpack_codec import packb, unpackb

D_H = 32
N_ROWS = 32
REF = "example_model_v2_regression_mol.pt"


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


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"W": {"kernel": rng.standard_normal((3, 5)).astype(np.float32),
                         "bias": np.zeros(5, np.float32)}},
        "bf16": np.asarray(jnp.asarray(rng.standard_normal(9), jnp.bfloat16)),
        "step": np.array(7, np.int32), "epoch": np.int32(3), "rng": np.array([1, 2], np.uint32),
        "ints": {str(i): v for i, v in enumerate(
            [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -129, -2**15 - 1,
             -2**31 - 1, 2**63])},
        "long": {str(i): float(i) / 3 for i in range(40)}, "text": "x" * 300,
        "none": None, "flags": {"t": True, "f": False}, "empty": {}, "blob": b"\x00\x01",
        "big": np.arange(70000, dtype=np.int64), "scalar64": np.float64(2.5),
    }


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):  # the codec's bfloat16 arrays
        return np.array_equal(a.float().numpy(), np.asarray(b, np.float32))
    if isinstance(a, (np.ndarray, np.generic)):
        return type(a) is type(b) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def test_codec_writes_and_reads_flax_bytes():
    """The port's bytes are flax's, bit for bit, and each side reads the
    other's: every msgpack form the trees of a checkpoint use, and the ones
    their sizes reach (16-, 32-bit lengths, ext 8/16/32, fixext)."""
    tree = _tree()
    want = serialization.msgpack_serialize(copy.deepcopy(tree), in_place=True)
    assert packb(tree) == want
    assert packb(tree) == serialization.to_bytes(tree)
    assert _equal(unpackb(want), serialization.msgpack_restore(packb(tree)))
    assert _equal(unpackb(packb(tree)), serialization.msgpack_restore(want))
    assert isinstance(unpackb(want)["bf16"], torch.Tensor)
    assert packb({"x": unpackb(want)["bf16"]}) == packb({"x": tree["bf16"]})


@pytest.fixture(scope="module", params=["plain", "frozen_clipped"])
def jax_run(request, datasets, tmp_path_factory):
    """Six epochs of the JAX trainer with a validation loader and
    ``checkpoint_dir``: its ``best.ckpt``, ``last.ckpt`` and final state."""
    jds, _ = datasets
    kw = {} if request.param == "plain" else dict(
        grad_clip=0.05, freeze=lambda p: p.startswith("message_passing/W_i"))
    path = tmp_path_factory.mktemp(request.param)
    model = JaxMPNN(message_passing=JaxBondMP(d_h=D_H, depth=3), agg=JaxMean(),
                    predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H), batch_norm=True)
    jloader = jdata.DataLoader(jds, batch_size=16, shuffle=False, prefetch=0)
    trainer = JaxTrainer(model, max_epochs=6, warmup_epochs=1, seed=9, checkpoint_dir=path, **kw)
    trainer.fit(jloader, jloader)
    return request.param, kw, path, trainer, jloader


def test_jax_best_ckpt_predicts_in_the_port(datasets, jax_run):
    _, _, path, jtrainer, jloader = jax_run
    _, tds = datasets
    want = jtrainer.predict(jloader)
    model, cols = load_model(path / "best.ckpt", "cpu")
    assert cols is None and model.message_passing.compute_dtype == torch.float32
    trainer = Trainer(model, device="cpu")
    trainer.state = object()  # predict needs no training state
    got = trainer.predict(DataLoader(tds, batch_size=16))
    # f32; the JAX f32 message keeps ~16 significant bits (bf16 hi + lo)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_jax_last_ckpt_resumes_in_the_port(datasets, jax_run):
    """The port restores the parameters, the batch-norm statistics, Adam's
    moments and count and the step of JAX's ``last.ckpt`` exactly (the
    frozen parameters' moments are masked out there: zeros), seeds its
    dropout generator from ``seed``, and three more steps on both sides
    agree as three steps from one state do
    (test_torch_train.py::test_three_adam_steps_match_jax_f32)."""
    case, kw, path, jtrainer, jloader = jax_run
    _, tds = datasets
    tloader = DataLoader(tds, batch_size=16, shuffle=False)
    trainer = Trainer(_port_model(), max_epochs=6, warmup_epochs=1, seed=9, device="cpu", **kw)
    start = trainer.resume_from(path / "last.ckpt", None, len(tloader))
    state = jtrainer.state
    assert start == len(jtrainer.history) == 6 and trainer.state.step == int(state.step)
    adam = serialize.adam_moments(serialization.to_state_dict(state.opt_state),
                                  list(trainer.state.params))
    for i, name in enumerate(trainer.state.params):
        for got, want in ((trainer.state.mu[i], adam[0][i]), (trainer.state.nu[i], adam[1][i])):
            if want is None:  # frozen
                assert case == "frozen_clipped" and name.startswith("message_passing.W_i")
                assert not got.any()
            else:
                assert torch.equal(got, want), name
    for name, want in from_jax_params(state.params, state.batch_stats).items():
        assert torch.equal(trainer.model.state_dict()[name], want), name
    fresh = torch.Generator().manual_seed(9)
    assert torch.equal(trainer.state.rng.get_state(), fresh.get_state())

    # three more steps on both sides, on the first three batches
    jstep = jax.jit(jtrainer._train_body())
    for jb, tb in list(zip(jloader, tloader))[:3]:
        state, jloss = jstep(state, jb)
        tloss = trainer.train_step(tb)
        # f32 on both sides; only summation orders differ
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    want = from_jax_params(state.params, state.batch_stats)
    lrs = sum(noam_lr_host(k, *trainer._sched_args)
              for k in range(trainer.state.step - 3, trainer.state.step))
    n_bad = n_all = 0
    for name, w in want.items():
        err = (trainer.model.state_dict()[name] - w).abs()
        # Adam moves a weight by about the rate in the direction of its
        # gradient's sign: where a gradient is at f32 rounding the two sides
        # may step apart by twice the steps' rates, no more
        assert float(err.max()) <= 2 * lrs + 1e-6, name
        n_bad += int((err > 1e-6 + 1e-4 * w.abs()).sum())
        n_all += err.numel()
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)


def _port_model():
    return MPNN(BondMessagePassing(d_h=D_H, depth=3), MeanAggregation(),
                RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False),
                batch_norm=True)


def _jax_predict(path, smis):
    model, variables, extra = jserialize.load_model(path)
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(jdata.MoleculeDatapoint.from_smi(s).mol) for s in smis]
    bmg = jax_batch(mgs, JaxPadSpec.for_graphs(mgs), sort_edges=True)
    preds = model.apply(variables, bmg, None, None, is_training=False)
    return np.asarray(preds)[: len(smis)], extra


def test_jax_reads_the_port_trainers_checkpoints(datasets, tmp_path):
    """The port's ``best.ckpt`` and ``last.ckpt`` load in the JAX package
    (its ``load_model`` keeps the parameters and statistics) and predict what
    the port predicts from the same state."""
    _, tds = datasets
    loader = DataLoader(tds, batch_size=16)
    trainer = Trainer(_port_model(), max_epochs=3, warmup_epochs=1, seed=2, device="cpu",
                      checkpoint_dir=tmp_path, val_metrics={})
    trainer.fit(loader, loader)
    smis = [d.name for d in tds.data]
    best = trainer.predict(loader)
    last = trainer.model.eval()
    with torch.no_grad():
        want_last = np.concatenate([
            last(b.bmg)[: int(b.pad_mask.sum())].numpy() for b in loader])
    for name, want in (("best", best), ("last", want_last)):
        got, _ = _jax_predict(tmp_path / f"{name}.ckpt", smis)
        # f32; the JAX f32 message keeps ~16 significant bits (bf16 hi + lo)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_reference_model_round_trip_and_cli(data_dir, tmp_path):
    """The reference checkpoint through the port into a ``CPTPU001`` file
    (with its output unscaling and column names): JAX's ``load_model`` reads
    it and predicts as the port; the CLI on that file gives the CLI's
    predictions on the ``.pt`` bit for bit; and a file the JAX package wrote
    from the same checkpoint gives them too."""
    model, _ = load_model(data_dir / REF, "cpu")
    serialize.save_model(tmp_path / "port.ckpt", model, ["lipo"])
    jmodel, jvars, _ = convert_model(data_dir / REF)
    jserialize.save_model(tmp_path / "jax.ckpt", jmodel, jvars, ["lipo"])
    in_csv = data_dir / "regression" / "mol" / "mol.csv"
    outs = {}
    for name in (REF, "port.ckpt", "jax.ckpt"):
        src = data_dir / REF if name == REF else tmp_path / name
        out = tmp_path / f"{name}.csv"
        assert main(["predict", "--model-path", str(src), "-i", str(in_csv), "-o", str(out),
                     "--device", "cpu"]) == 0
        with open(out) as f:
            outs[name] = list(csv.reader(f))
    assert outs["port.ckpt"][0] == outs["jax.ckpt"][0] == ["name", "lipo"]
    assert [r[1:] for r in outs["port.ckpt"][1:]] == [r[1:] for r in outs[REF][1:]]
    got = np.array([float(r[1]) for r in outs["jax.ckpt"][1:]])
    want = np.array([float(r[1]) for r in outs[REF][1:]])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)  # the same f32 weights
    smis = [r[0] for r in outs[REF][1:]]
    jax_preds, extra = _jax_predict(tmp_path / "port.ckpt", smis)
    assert extra == {"output_columns": ["lipo"]}
    # f32; the JAX f32 message keeps ~16 significant bits (bf16 hi + lo)
    np.testing.assert_allclose(jax_preds[:, 0], want, rtol=1e-4, atol=1e-4)


def test_a_manifest_the_port_cannot_build_raises(tmp_path, datasets):
    jds, _ = datasets
    model = JaxMPNN(message_passing=JaxBondMP(d_h=D_H), agg=JaxAttentive(output_size=D_H),
                    predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H))
    batch = next(iter(jdata.DataLoader(jds, batch_size=4, prefetch=0)))
    variables = model.init(jax.random.PRNGKey(0), batch.bmg, None, None, False)
    jserialize.save_model(tmp_path / "attentive.ckpt", model, jax.device_get(variables))
    # the attentive readout loads since it was ported (test_torch_atom_messages.py
    # holds it against JAX's); classes the port does not have still raise
    assert type(load_model(tmp_path / "attentive.ckpt", "cpu")[0].agg).__name__ == (
        "AttentiveAggregation")
    cfg = serialize.model_config(_port_model())
    cfg["message_passing"]["cls"] = "MABAtomMessagePassing"
    cfg["agg"]["cls"] = "UnknownAggregation"
    with pytest.raises(ValueError, match="MABAtomMessagePassing.*UnknownAggregation"):
        serialize.model_from_config(cfg)
    with pytest.raises(ValueError, match="not a chemprop_tpu checkpoint"):
        serialize.read_checkpoint(__file__)
