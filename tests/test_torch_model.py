"""The port's whole inference forward against the JAX package's.

* With weights made by numpy from a seed, handed to both packages (the port
  through ``from_jax_params``), on a small model: d_h=64 padded to 128,
  depth 3, mean readout, batch norm, regression head. The JAX side runs its
  Pallas kernels in interpret mode.
* With the reference checkpoint ``example_model_v2_regression_mol.pt``,
  loaded by each package its own way, on tests/data/smis.csv."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu.data import MoleculeDatapoint
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.models.torch_convert import convert_model
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.models import MPNN, from_jax_params, load_model
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.nn.init import init_parameters

SMIS = [
    "CCO",
    "c1ccccc1",
    "CC(=O)Nc1ccc(O)cc1",
    "CNC(C)Cc1ccccc1",
    "CC(C)CC1=CC=C(C=C1)C(C)C(=O)O",
    "c1ccc2ccccc2c1",
    "CC(=O)OC1=CC=CC=C1C(=O)O",
    "C1CCNCC1",
    "C",
    "O=[N+]([O-])c1ccc(Cl)cc1",
]
D_H = 64
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def mgs():
    feat = SimpleMoleculeMolGraphFeaturizer()
    return [feat(MoleculeDatapoint.from_smi(s).mol) for s in SMIS]


def _numpy_variables(variables, seed=0):
    """The JAX variable tree with every leaf replaced by numpy draws of a
    realistic scale: kernels N(0, 1/fan_in), biases and batch-norm shifts
    small, running variances around one."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(mgs, monkeypatch, dtype):
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")
    jdt, tdt = DTYPES[dtype]
    pad = (256, 768, len(SMIS))
    jb = jax_batch(mgs, JaxPadSpec(*pad), sort_edges=True)
    jmodel = JaxMPNN(
        message_passing=JaxBondMP(d_h=D_H, depth=3, compute_dtype=jdt),
        agg=JaxMean(),
        predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H),
        batch_norm=True,
    )
    variables = _numpy_variables(jmodel.init(jax.random.PRNGKey(0), jb, None, None, False))
    want_fp = np.asarray(jmodel.apply(variables, jb, is_training=False, method="fingerprint"))
    want = np.asarray(jmodel.apply(variables, jb, None, None, is_training=False))

    model = MPNN(
        BondMessagePassing(d_v=mgs[0].V.shape[1], d_e=mgs[0].E.shape[1], d_h=D_H, depth=3,
                           compute_dtype=tdt),
        MeanAggregation(),
        RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False),
        batch_norm=True,
    )
    model.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]))
    tb = batch_mol_graphs(mgs, PadSpec(*pad))
    with torch.inference_mode():  # the module leaves gradients on
        got_fp = model.fingerprint(tb).numpy()
        got = model(tb).numpy()
    assert got.shape == want.shape == (len(SMIS), 1)
    if dtype == "float32":
        # the JAX f32 message kernel keeps ~16 significant bits (bf16 hi+lo)
        np.testing.assert_allclose(got_fp, want_fp, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        # bf16 tables round at other places in the two frameworks: the JAX
        # package's own bf16 parity envelope (test_reference_parity.py)
        np.testing.assert_allclose(got_fp, want_fp, rtol=0.05, atol=0.05)
        np.testing.assert_allclose(got, want, rtol=0.05, atol=0.1)


@pytest.fixture(scope="module")
def reference_preds(data_dir, smis):
    """JAX predictions of the reference checkpoint, f32 and bf16."""
    model, variables, _ = convert_model(data_dir / "example_model_v2_regression_mol.pt")
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(MoleculeDatapoint.from_smi(s).mol) for s in smis]
    out = {}
    for dtype, (jdt, _) in DTYPES.items():
        mp = model.message_passing.clone(compute_dtype=jdt)
        m = model.clone(message_passing=mp)
        jb = jax_batch(mgs, JaxPadSpec.for_graphs(mgs), sort_edges=True)
        out[dtype] = np.asarray(m.apply(variables, jb, None, None, is_training=False))[: len(mgs)]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_matches_jax(data_dir, smis, reference_preds, dtype):
    from chemprop_tpu_torch.chem import make_mol
    from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer as Featurizer

    model, cols = load_model(
        data_dir / "example_model_v2_regression_mol.pt", "cpu", DTYPES[dtype][1]
    )
    assert cols is None
    feat = Featurizer()
    tb = batch_mol_graphs([feat(make_mol(s)) for s in smis])
    with torch.inference_mode():
        got = model(tb)[: len(smis)].numpy()
    want = reference_preds[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0.05, atol=0.1)


def test_reference_checkpoint_loads_every_weight(data_dir):
    model, _ = load_model(data_dir / "example_model_v2_regression_mol.pt", "cpu")
    mp = model.message_passing
    assert (mp.d_v, mp.d_e, mp.d_h, mp.depth, mp.d_pad) == (72, 14, 300, 3, 384)
    assert mp.W_i.bias is None and mp.W_h.bias is None and mp.W_o.bias is not None
    assert model.bn is not None and float(model.bn.running_var.min()) > 0
    ot = model.predictor.output_transform
    assert ot is not None and ot.scale.shape == (1, 1) and float(ot.scale) != 1.0


@pytest.mark.parametrize("bias", [False, True])
def test_padding_columns_stay_zero(mgs, bias):
    """The hidden width is padded 64 -> 128 with zero weight columns: the node
    table's padding columns are exact zeros."""
    mp = BondMessagePassing(d_h=D_H, depth=3, bias=bias)
    init_parameters(mp, "torch", torch.Generator().manual_seed(0))
    H_v = mp(batch_mol_graphs(mgs))
    assert H_v.shape[1] == 128 and H_v[:, :D_H].any()
    assert not H_v[:, D_H:].any()


@pytest.mark.parametrize("scheme", ["lecun", "torch"])
def test_init_schemes(scheme):
    """Seeded initialisation: the same seed gives the same weights; lecun is
    a truncated normal of variance 1/fan_in with zero biases, torch is
    uniform within 1/sqrt(fan_in)."""
    def make(seed):
        layer = torch.nn.Linear(400, 300).requires_grad_(False)
        return init_parameters(layer, scheme, torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    assert torch.equal(a.weight, b.weight) and not torch.equal(a.weight, c.weight)
    bound = 400**-0.5
    if scheme == "lecun":
        assert abs(float(a.weight.std()) - bound) < 0.05 * bound
        assert float(a.weight.abs().max()) <= 2 * bound / 0.87962566103423978 + 1e-6
        assert not a.bias.any()
    else:
        assert float(a.weight.abs().max()) <= bound and float(a.bias.abs().max()) <= bound
    with pytest.raises(ValueError):
        init_parameters(a, "xavier")
