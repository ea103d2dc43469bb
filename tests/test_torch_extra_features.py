"""Extra inputs, held against the JAX package on the CPU: atom descriptors
``V_d`` through ``W_d``, molecule descriptors ``X_d`` with their transform,
and extra atom and bond features ``V_f``/``E_f`` with the graph transform;
the datasets' scalers and the collate on the repo's ``.npz`` files
(tests/data/regression/mol/: descriptors 1 per molecule, atom descriptors and
atom features 3 per atom, bond features 2 per bond, for the 100 rows of
mol.csv). The JAX models run their plain CPU reference. Small sizes: 16
molecules, d_h = 64."""

from __future__ import annotations

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu import data as jdata
from chemprop_tpu.featurizers.molgraph.molecule import (
    SimpleMoleculeMolGraphFeaturizer as JaxFeaturizer,
)
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.nn.transforms import GraphTransform as JaxGraphTransform
from chemprop_tpu.nn.transforms import ScaleTransform as JaxScaleTransform
from chemprop_tpu_torch import data as tdata
from chemprop_tpu_torch.featurizers.molgraph import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.models import MPNN, from_jax_params
from chemprop_tpu_torch.models.load import build_model
from chemprop_tpu_torch.nn import (
    BondMessagePassing,
    GraphTransform,
    MeanAggregation,
    RegressionFFN,
    ScaleTransform,
)

N_MOLS = 16
D_H = 64
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
KEYS = ("X_d", "V_f", "E_f", "V_d")


@pytest.fixture(scope="module")
def inputs(data_dir):
    """The first rows of mol.csv with their four kinds of extra input."""
    mol = data_dir / "regression" / "mol"
    with open(mol / "mol.csv") as f:
        rows = list(csv.reader(f))[1 : N_MOLS + 1]

    def arrays(name):
        z = np.load(mol / f"{name}.npz")
        return [z[f"arr_{i}"] for i in range(len(z.files))]

    x_d = np.load(mol / "descriptors.npz")["arr_0"]
    V_d, V_f, E_f = arrays("atom_descriptors"), arrays("atom_features"), arrays("bond_features")
    return [dict(smi=s, y=float(y), x_d=x_d[i], V_d=V_d[i], V_f=V_f[i], E_f=E_f[i])
            for i, (s, y) in enumerate(rows)]


def _dataset(pkg, featurizer, inputs):
    dps = [pkg.MoleculeDatapoint.from_smi(r["smi"], y=np.array([r["y"]]), x_d=r["x_d"],
                                          V_d=r["V_d"], V_f=r["V_f"], E_f=r["E_f"])
           for r in inputs]
    ds = pkg.MoleculeDataset(dps, featurizer=featurizer)
    ds.normalize_targets()
    scalers = {key: ds.normalize_inputs(key) for key in KEYS}
    return ds, scalers


@pytest.fixture(scope="module")
def datasets(inputs):
    jds, jsc = _dataset(jdata, JaxFeaturizer(extra_atom_fdim=3, extra_bond_fdim=2), inputs)
    tds, tsc = _dataset(tdata, SimpleMoleculeMolGraphFeaturizer(extra_atom_fdim=3,
                                                                extra_bond_fdim=2), inputs)
    return (jds, jsc), (tds, tsc)


def test_dataset_scalers_match_jax(datasets):
    """The port's own StandardScaler on each kind of extra input gives
    scikit-learn's moments, and the scaled inputs are JAX's."""
    (jds, jsc), (tds, tsc) = datasets
    assert (tds.d_xd, tds.d_vf, tds.d_ef, tds.d_vd) == (jds.d_xd, jds.d_vf, jds.d_ef, jds.d_vd)
    assert (tds.d_xd, tds.d_vf, tds.d_ef, tds.d_vd) == (1, 3, 2, 3)
    for key in KEYS:
        # float64 moments: only summation orders differ
        np.testing.assert_allclose(tsc[key].mean_, jsc[key].mean_, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tsc[key].scale_, jsc[key].scale_, rtol=1e-12)
    np.testing.assert_allclose(tds.X_d, jds.X_d, rtol=1e-12, atol=1e-12)
    for got, want in [(tds.V_fs, jds.V_fs), (tds.E_fs, jds.E_fs), (tds.V_ds, jds.V_ds)]:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def test_collate_matches_jax(datasets):
    """The featurizer's extra columns and the collated descriptor tables are
    JAX's, bit for bit, padding rows zero; the batch unpacks in JAX's order."""
    (jds, _), (tds, _) = datasets
    jb = next(iter(jdata.DataLoader(jds, batch_size=N_MOLS, prefetch=0)))
    tb = next(iter(tdata.DataLoader(tds, batch_size=N_MOLS)))
    bmg, V_d, X_d, Y, w, lt, gt = tb
    assert lt is None and gt is None
    assert bmg.V.shape[1] == 75 and bmg.E.shape[1] == 16
    for got, want in [(bmg.V, jb.bmg.V), (V_d, jb.V_d), (X_d, jb.X_d), (w, jb.w)]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(Y.numpy(), np.asarray(jb.Y))
    # the edge tables: the port sorts by dst as the JAX package's kernels do;
    # the same rows as a multiset
    jE = np.asarray(jb.bmg.E)
    assert sorted(map(tuple, bmg.E.numpy())) == sorted(map(tuple, jE))


def _models(dtype, scalers):
    """JAX's and the port's descriptor models, the transforms made from the
    dataset scalers, the weights drawn by numpy and carried across."""
    jdt, tdt = DTYPES[dtype]
    sc = scalers
    jgt = JaxGraphTransform(JaxScaleTransform.from_standard_scaler(sc["V_f"], pad=72),
                            JaxScaleTransform.from_standard_scaler(sc["E_f"], pad=14))
    jmodel = JaxMPNN(
        message_passing=JaxBondMP(
            d_h=D_H, depth=3, compute_dtype=jdt, d_vd=3,
            V_d_transform=JaxScaleTransform.from_standard_scaler(sc["V_d"]), graph_transform=jgt),
        agg=JaxMean(), predictor=JaxRegressionFFN(input_dim=D_H + 3 + 1, hidden_dim=D_H),
        batch_norm=True, X_d_transform=JaxScaleTransform.from_standard_scaler(sc["X_d"]))
    model = MPNN(
        BondMessagePassing(
            d_v=75, d_e=16, d_h=D_H, depth=3, compute_dtype=tdt, d_vd=3,
            V_d_transform=ScaleTransform.from_standard_scaler(sc["V_d"]),
            graph_transform=GraphTransform(ScaleTransform.from_standard_scaler(sc["V_f"], pad=72),
                                           ScaleTransform.from_standard_scaler(sc["E_f"], pad=14))),
        MeanAggregation(), RegressionFFN(input_dim=D_H + 3 + 1, hidden_dim=D_H,
                                         output_transform=False),
        batch_norm=True, X_d_transform=ScaleTransform.from_standard_scaler(sc["X_d"]))
    return jmodel, model


@pytest.mark.parametrize("is_training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_descriptor_model_matches_jax(datasets, dtype, is_training):
    """Fingerprints and predictions of the whole model with V_d, X_d, V_f and
    E_f: at evaluation the transforms scale (and the batch norm takes its
    running statistics), in training they do not (batch statistics)."""
    (jds, jsc), (tds, _) = datasets
    jb = next(iter(jdata.DataLoader(jds, batch_size=N_MOLS, prefetch=0)))
    tb = next(iter(tdata.DataLoader(tds, batch_size=N_MOLS)))
    jmodel, model = _models(dtype, jsc)
    variables = jmodel.init(jax.random.PRNGKey(0), jb.bmg, jb.V_d, jb.X_d, False)
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(
        lambda x: jnp.asarray((rng.standard_normal(np.shape(x)) / np.sqrt(np.shape(x)[0])
                               if np.ndim(x) == 2 else 0.1 * rng.standard_normal(np.shape(x))
                               ).astype(np.float32)), variables)
    variables["batch_stats"]["bn"]["var"] = jnp.ones_like(variables["batch_stats"]["bn"]["var"])
    sd = from_jax_params(variables["params"], variables["batch_stats"])
    assert {"message_passing.W_d.weight", "message_passing.W_d.bias"} <= set(sd)
    assert sd["message_passing.W_d.weight"].shape == (D_H + 3, D_H + 3)
    model.load_state_dict(sd, strict=False)  # the transforms' buffers are configuration
    args = (jb.bmg, jb.V_d, jb.X_d)

    def jax_apply(method):
        out = jmodel.apply(variables, *args, is_training=is_training, method=method,
                           **({"mutable": ["batch_stats"]} if is_training else {}))
        return np.asarray(out[0] if is_training else out)

    want_fp, want = jax_apply("fingerprint"), jax_apply("train_step_preds")
    with torch.no_grad():
        got_fp = model.fingerprint(tb.bmg, tb.V_d, tb.X_d, is_training).numpy()
        got = model.train_step_preds(tb.bmg, tb.V_d, tb.X_d, is_training).numpy()
    assert model.message_passing.output_dim == D_H + 3 and got_fp.shape == want_fp.shape
    assert got_fp.shape == (N_MOLS, D_H + 3 + 1)
    if dtype == "float32":
        # the JAX f32 message kernel keeps ~16 significant bits (bf16 hi + lo)
        np.testing.assert_allclose(got_fp, want_fp, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        # bf16 tables round at other places in the two frameworks: the JAX
        # package's own bf16 parity envelope
        np.testing.assert_allclose(got_fp, want_fp, rtol=0.05, atol=0.05)
        np.testing.assert_allclose(got, want, rtol=0.05, atol=0.1)


def test_w_d_output_is_lane_padded_with_zero_columns(datasets):
    """W_d's 67 output columns are padded to 128 with zero weights and a zero
    bias, so the node table keeps the readout kernel's width; the padding
    columns stay exact zeros (no activation follows), the gradient flows to
    W_d's real block only."""
    (_, jsc), (tds, _) = datasets
    _, model = _models("float32", jsc)
    tb = next(iter(tdata.DataLoader(tds, batch_size=N_MOLS)))
    mp = model.message_passing
    H_v = mp(tb.bmg, tb.V_d, is_training=True)
    assert H_v.shape == (tb.bmg.V.shape[0], 128)
    assert not H_v[:, D_H + 3 :].any()
    H_v.sum().backward()
    assert mp.W_d.weight.grad.shape == (D_H + 3, D_H + 3)
    with pytest.raises(ValueError):  # d_vd without V_d
        mp(tb.bmg)


def test_reference_checkpoint_with_descriptors_loads(datasets):
    """A reference-style state dict with W_d and the three transforms' buffers
    builds the descriptor model (``load.build_model`` stopped refusing
    ``d_vd`` and ``X_d_transform``), and the loaded model computes as the one
    it came from."""
    (_, jsc), (tds, _) = datasets
    _, model = _models("float32", jsc)
    torch.manual_seed(0)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    sd = model.state_dict()
    stub = lambda name: type(name, (), {})  # noqa: E731  (the pickle's stand-in classes)
    hp = {"message_passing": {"cls": stub("BondMessagePassing"), "d_h": D_H, "depth": 3,
                              "d_vd": 3, "activation": "RELU"},
          "agg": {"cls": stub("MeanAggregation")},
          "predictor": {"cls": stub("RegressionFFN"), "n_tasks": 1, "input_dim": D_H + 4,
                        "hidden_dim": D_H}, "X_d_transform": stub("ScaleTransform")()}
    loaded = build_model(hp, {k: v for k, v in sd.items() if "output_transform" not in k})
    loaded.load_state_dict(sd, strict=False)
    assert loaded.message_passing.d_vd == 3 and loaded.X_d_transform is not None
    assert loaded.message_passing.graph_transform.V_transform.mean.shape == (1, 75)
    tb = next(iter(tdata.DataLoader(tds, batch_size=N_MOLS)))
    with torch.no_grad():
        want = model.fingerprint(tb.bmg, tb.V_d, tb.X_d)
        got = loaded.fingerprint(tb.bmg, tb.V_d, tb.X_d)
    assert torch.equal(got, want)


def test_descriptor_model_checkpoint_reads_in_jax(datasets, tmp_path):
    """The port's descriptor model (W_d, the three transforms in the
    manifest) written as a ``CPTPU001`` file: the port reads it back bit for
    bit, and the JAX package's ``load_model`` rebuilds it and predicts what
    the port predicts, at evaluation (the transforms scale)."""
    from chemprop_tpu.models import serialize as jserialize
    from chemprop_tpu_torch.models import serialize

    (jds, jsc), (tds, _) = datasets
    _, model = _models("float32", jsc)
    torch.manual_seed(1)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    serialize.save_model(tmp_path / "desc.ckpt", model)
    tb = next(iter(tdata.DataLoader(tds, batch_size=N_MOLS)))
    with torch.no_grad():
        want = model(tb.bmg, tb.V_d, tb.X_d).numpy()
        again, _ = serialize.load_model(tmp_path / "desc.ckpt", "cpu")
        assert np.array_equal(again(tb.bmg, tb.V_d, tb.X_d).numpy(), want)
    jmodel, variables, _ = jserialize.load_model(tmp_path / "desc.ckpt")
    jb = next(iter(jdata.DataLoader(jds, batch_size=N_MOLS, prefetch=0)))
    got = np.asarray(jmodel.apply(variables, jb.bmg, jb.V_d, jb.X_d, is_training=False))
    # f32; the JAX f32 message keeps ~16 significant bits (bf16 hi + lo)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
