"""The port's export (``chemprop_tpu_torch.models.export``) against the JAX
package's ``export_forward`` and against the port's own eager forward, on
the CPU: the exported graph holds the kernels' ops (``chemprop_tpu_torch::``)
and no plain-version scatter, takes other paddings through its dynamic
dimensions, a batch without a tile table, zero-edge molecules, and a
``.pt2`` round trip, also in a process that imports only
``chemprop_tpu_torch.ops``."""

from __future__ import annotations

import collections
import subprocess
import sys
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu.data import MoleculeDatapoint as JaxDatapoint
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.models import MPNN as JaxMPNN
from chemprop_tpu.models.export import export_forward as jax_export_forward
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.models import MPNN, from_jax_params
from chemprop_tpu_torch.models.export import export_forward, load_exported, save_exported
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.ops import UNSERVED, KernelOptions

REPO = Path(__file__).resolve().parent.parent
SMIS = ["CCO", "c1ccccc1", "CC(=O)Nc1ccc(O)cc1", "CNC(C)Cc1ccccc1", "C", "O=[N+]([O-])c1ccc(Cl)cc1"]
D_H = 64
PAD = (128, 256, len(SMIS))
# the ops of one forward at depth 3: two message-passing iterations, the M_v
# readout and the mean readout (with counts)
OPS = {
    "float32": {"message": 2, "seg_sum": 1, "seg_sum_counts": 1},
    "bfloat16": {"fused_iter": 2, "seg_sum": 1, "seg_sum_counts": 1},
}


def _mgs(smis):
    feat = SimpleMoleculeMolGraphFeaturizer()
    return [feat(JaxDatapoint.from_smi(s).mol) for s in smis]


def _numpy_variables(variables, seed=0):
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name, shape = path[-1].key, np.shape(x)
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif name in ("var", "scale"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.fixture(scope="module")
def jax_model():
    jb = jax_batch(_mgs(SMIS), JaxPadSpec(*PAD), sort_edges=True)
    jmodel = JaxMPNN(
        message_passing=JaxBondMP(d_h=D_H, depth=3),
        agg=JaxMean(),
        predictor=JaxRegressionFFN(input_dim=D_H, hidden_dim=D_H),
        batch_norm=True,
    )
    variables = _numpy_variables(jmodel.init(jax.random.PRNGKey(0), jb, None, None, False))
    return jmodel, variables, jb


def _model(variables, dtype=torch.float32, **options):
    model = MPNN(
        BondMessagePassing(d_h=D_H, depth=3, compute_dtype=dtype,
                           kernel_options=KernelOptions(**options)),
        MeanAggregation(),
        RegressionFFN(input_dim=D_H, hidden_dim=D_H, output_transform=False),
        batch_norm=True,
    )
    model.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]))
    return model.eval()


def _batch(smis=SMIS, pad=PAD):
    return SimpleNamespace(bmg=batch_mol_graphs(_mgs(smis), PadSpec(*pad)), V_d=None, X_d=None)


def _ops(exported) -> dict:
    """The ``chemprop_tpu_torch`` ops of the program's graph, by name, and
    every other op's name."""
    ops, others = collections.Counter(), set()
    for node in exported.program.graph.nodes:
        if node.op == "call_function":
            name = str(node.target)
            if name.startswith("chemprop_tpu_torch."):
                ops[name.split(".")[1]] += 1
            else:
                others.add(name)
    return dict(ops), others


def _eager(model, batch):
    with torch.inference_mode():
        return model(batch.bmg, batch.V_d, batch.X_d)


def test_matches_the_jax_exported_forward(jax_model):
    """f32 on weights carried across: the JAX program (its XLA path, Pallas
    off) against the port's (its kernels' plain versions on the CPU)."""
    jmodel, variables, jb = jax_model
    want = np.asarray(jax_export_forward(jmodel, variables, SimpleNamespace(
        bmg=jb, V_d=None, X_d=None)).call(variables, jb, None, None))
    got = export_forward(_model(variables), _batch())(_batch().bmg).numpy()
    assert got.shape == want.shape == (len(SMIS), 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_eager_and_holds_the_kernels_ops(jax_model, dtype):
    _, variables, _ = jax_model
    model, batch = _model(variables, getattr(torch, dtype)), _batch()
    exported = export_forward(model, batch)
    ops, others = _ops(exported)
    assert ops == OPS[dtype]
    assert not {name for name in others if "index_add" in name or "scatter" in name}, others
    assert torch.equal(exported(batch.bmg), _eager(model, batch))
    # another padding goes through the dynamic node and edge counts
    other = _batch(pad=(256, 512, len(SMIS)))
    assert torch.equal(exported(other.bmg), _eager(model, other))


def test_a_batch_without_a_tile_table(jax_model):
    """One program serves both forms: A takes message.cu's form and counts
    the call in UNSERVED, as the eager forward does."""
    _, variables, _ = jax_model
    model, batch = _model(variables), _batch()
    exported = export_forward(model, batch)
    bare = replace(batch.bmg, tile_ptr=None)
    before = UNSERVED["message"]
    got = exported(bare)
    assert UNSERVED["message"] - before == 2
    assert torch.equal(got, _eager(model, SimpleNamespace(bmg=bare, V_d=None, X_d=None)))
    with pytest.raises(ValueError, match="export from a batch with a tile table"):
        export_forward(model, SimpleNamespace(bmg=bare, V_d=None, X_d=None))


def test_zero_edge_molecules_and_the_graph_count(jax_model):
    _, variables, _ = jax_model
    model = _model(variables)
    exported = export_forward(model, _batch())
    atoms = _batch(["C", "O", "N", "CCO", "C", "O"])
    got = exported(atoms.bmg)
    assert torch.isfinite(got).all()
    assert torch.equal(got, _eager(model, atoms))
    with pytest.raises(ValueError, match="exported for"):
        exported(_batch(SMIS[:4], (128, 256, 4)).bmg)


@pytest.mark.parametrize("option,op", [("iter2", "fused_iter2"), ("window_gather", "row_gather")])
def test_the_options_kernels_are_in_the_graph(jax_model, option, op):
    _, variables, _ = jax_model
    model, batch = _model(variables, torch.bfloat16, **{option: True}), _batch()
    exported = export_forward(model, batch)
    assert _ops(exported)[0].get(op) == 1
    assert torch.equal(exported(batch.bmg), _eager(model, batch))


def test_pt2_round_trip(jax_model, tmp_path):
    """Saved, loaded by ``load_exported``, and loaded in a process that
    imports only ``chemprop_tpu_torch.ops``, fed the batch's leaves."""
    from chemprop_tpu_torch.models.export import program_inputs

    _, variables, _ = jax_model
    model, batch = _model(variables), _batch()
    path = tmp_path / "model.pt2"
    save_exported(path, export_forward(model, batch))
    want = _eager(model, batch)
    assert torch.equal(load_exported(path)(batch.bmg), want)
    (leaves, _, _), _ = program_inputs(batch.bmg)
    torch.save(leaves, tmp_path / "leaves.pt")
    script = (
        "import sys, torch\n"
        "import chemprop_tpu_torch.ops\n"
        "program = torch.export.load(sys.argv[1])\n"
        "out = program.module()(torch.load(sys.argv[2]), None, None)\n"
        "torch.save(out, sys.argv[3])\n"
        "assert not any(m.startswith(('chemprop_tpu_torch.models', 'chemprop_tpu_torch.nn', "
        "'chemprop_tpu_torch.data')) for m in sys.modules)\n"
    )
    subprocess.run([sys.executable, "-c", script, str(path), str(tmp_path / "leaves.pt"),
                    str(tmp_path / "out.pt")], check=True, cwd=REPO, timeout=300)
    assert torch.equal(torch.load(tmp_path / "out.pt"), want)
