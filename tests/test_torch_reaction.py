"""Reactions in the port against the JAX package, on the CPU: the condensed
graph of reaction (``featurizers/molgraph/reaction.py``) in all six modes on
the reactions of tests/data/regression/rxn/rxn.csv (``V``, ``E``,
``edge_index`` and ``rev_edge_index`` equal), the reaction datapoints and
dataset, ``W_i`` at the CGR's 134 inputs with ``grad_w``, one ``train`` epoch
through each command line from one warm start, and ``predict`` of the
reference reaction checkpoints (``.pt`` and ``.ckpt``) through each."""

from __future__ import annotations

import csv
import importlib

import numpy as np
import pytest
import torch

from chemprop_tpu.chem import make_mol as jax_make_mol
from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu.data.datapoints import ReactionDatapoint as JaxReactionDatapoint
from chemprop_tpu.featurizers.molgraph.reaction import CondensedGraphOfReactionFeaturizer as JaxCGR
from chemprop_tpu.train.schedulers import noam_lr_host
from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.cli.main import main as port_main
from chemprop_tpu_torch.data import DataLoader
from chemprop_tpu_torch.data.datapoints import LazyReactionDatapoint, ReactionDatapoint
from chemprop_tpu_torch.data.datasets import ReactionDataset
from chemprop_tpu_torch.featurizers.molgraph import CondensedGraphOfReactionFeaturizer, RxnMode
from chemprop_tpu_torch.nn import BondMessagePassing
from chemprop_tpu_torch.ops import KernelOptions
from test_torch_multicomponent import _head, _rows, assert_runs_match, train_both

N_RXNS = 40
BF16_ULP = 2.0**-7
gw_module = importlib.import_module("chemprop_tpu_torch.ops.grad_weight")


@pytest.fixture(scope="module")
def reactions(data_dir):
    with open(data_dir / "regression/rxn/rxn.csv") as f:
        return [(r[0], float(r[1])) for r in list(csv.reader(f))[1:N_RXNS + 1]]


def _sides(rxn: str) -> tuple[str, str]:
    rct, _, pdt = rxn.split(">")
    return rct, pdt


@pytest.mark.parametrize("mode", [m.name.lower() for m in RxnMode])
def test_cgr_equals_jax(reactions, mode):
    port, jax = CondensedGraphOfReactionFeaturizer(mode_=mode), JaxCGR(mode_=mode)
    assert port.shape == jax.shape == (106, 28)
    for rxn, _ in reactions:
        r, p = _sides(rxn)
        got = port((make_mol(r), make_mol(p)))
        want = jax((jax_make_mol(r), jax_make_mol(p)))
        for name in ("V", "E", "edge_index", "rev_edge_index"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and a.shape == b.shape, (mode, name, rxn)
            np.testing.assert_array_equal(a, b, err_msg=f"{mode} {name} {rxn}")


def test_reaction_datapoints_equal_jax(reactions):
    """Both SMILES forms, agents joined to the reactants, and the lazy
    datapoint's sides parsed on first access."""
    rxn, y = reactions[0]
    a = ReactionDatapoint.from_smi(rxn, y=[y])
    b = JaxReactionDatapoint.from_smi(rxn, y=[y])
    lazy = LazyReactionDatapoint.from_smi(rxn, y=[y])
    pair = ReactionDatapoint.from_smi(_sides(rxn), y=[y])
    assert a.name == b.name == lazy.name == pair.name == rxn
    f = CondensedGraphOfReactionFeaturizer()
    graphs = [f((d.rct, d.pdt)) for d in (a, lazy, pair)]
    for g in graphs[1:]:
        np.testing.assert_array_equal(g.V, graphs[0].V)
        np.testing.assert_array_equal(g.E, graphs[0].E)
    agent = ReactionDatapoint.from_smi("[CH3:1][OH:2]>O>[CH2:1]=[O:2]")
    assert agent.rct.num_atoms == 3 and agent.pdt.num_atoms == 2
    with pytest.raises(ValueError, match="invalid reaction"):
        ReactionDatapoint.from_smi("CC>O>C>C")


def test_reaction_dataset_scales_x_d_alone(reactions):
    data = [ReactionDatapoint.from_smi(r, y=[y], x_d=[y, 2.0 * i])
            for i, (r, y) in enumerate(reactions[:8])]
    ds = ReactionDataset(data)
    assert (ds.d_xd, ds.d_vf, ds.d_ef, ds.d_vd) == (2, 0, 0, 0)
    assert ds.normalize_inputs("V_f") is None
    scaler = ds.normalize_inputs("X_d")
    np.testing.assert_allclose(ds.X_d.mean(0), 0, atol=1e-12)
    assert scaler.mean_.shape == (2,)
    b = next(iter(DataLoader(ds, batch_size=8)))
    assert b.bmg.V.shape[1] == 106 and b.bmg.E.shape[1] == 28 and b.X_d.shape == (8, 2)


@pytest.mark.parametrize("fused_readout", [True, False], ids=["default", "per_iteration"])
def test_w_i_at_134_inputs_with_grad_w(reactions, monkeypatch, fused_readout):
    """In bfloat16 with ``grad_w``, W_i's input ``[V[src] ; E]`` (106 + 28
    columns) is padded to 256 and its weight gradient goes through
    ``grad_weight``; forward equal and the gradient within bf16 rounding of
    the route without it."""
    ds = ReactionDataset([ReactionDatapoint.from_smi(r, y=[y]) for r, y in reactions])
    bmg = next(iter(DataLoader(ds, batch_size=N_RXNS))).bmg
    routed = []
    plain = gw_module.grad_weight

    def spy(X, G, use_kernel=False):
        routed.append((X.shape[1], use_kernel))
        return plain(X, G, use_kernel)

    monkeypatch.setattr(gw_module, "grad_weight", spy)
    c = torch.from_numpy(np.random.default_rng(0).standard_normal((bmg.V.shape[0], 128)))
    grads, outs = [], []
    for grad_w in (False, True):
        mp = BondMessagePassing(d_v=106, d_e=28, d_h=64, compute_dtype=torch.bfloat16,
                                kernel_options=KernelOptions(grad_w=grad_w,
                                                             fused_readout=fused_readout))
        torch.manual_seed(0)
        for p in mp.parameters():
            torch.nn.init.normal_(p, std=0.1)
        out = mp(bmg, is_training=True)
        outs.append(out)
        (g,) = torch.autograd.grad((out.float() * c.float()).sum(), [mp.W_i.weight])
        grads.append(g)
    assert routed == [(256, True)]
    assert torch.equal(outs[0], outs[1])
    assert grads[1].shape == (64, 134)
    torch.testing.assert_close(grads[1], grads[0], rtol=BF16_ULP, atol=1e-6)


# ------------------------------------------------------------ command line
CLI_STEPS_LRS = sum(noam_lr_host(k, 4, 1, 1e-4, 1e-3, 1e-4) for k in range(2))


def test_cli_epoch_of_rxn_matches_jax(data_dir, tmp_path):
    csv_in = _head(data_dir / "regression/rxn/rxn.csv", tmp_path / "in.csv", 40)
    argv = ["-i", str(csv_in), "--reaction-columns", "smiles", "--rxn-mode", "reac_diff",
            "--batch-norm", "-b", "16", "--message-hidden-dim", "32", "--ffn-hidden-dim", "16",
            "--save-data-splits"]
    jax_dir, port_dir = train_both(tmp_path, argv)
    jmodel = assert_runs_match(jax_dir, port_dir, CLI_STEPS_LRS)
    assert type(jmodel).__name__ == "MPNN"
    got, want = _rows(port_dir / "train_full.csv"), _rows(jax_dir / "train_full.csv")
    assert [r[0] for r in got] == [r[0] for r in want] and got[0] == ["smiles", "ea"]
    # pandas' fast float parser may read a target one unit in the last place
    # away from Python's float()
    np.testing.assert_allclose([float(r[1]) for r in got[1:]], [float(r[1]) for r in want[1:]],
                               rtol=1e-15)


@pytest.mark.parametrize("ckpt", ["example_model_v2_regression_rxn.pt",
                                  "example_model_v2_regression_rxn.ckpt"])
def test_cli_predict_of_rxn_matches_jax(data_dir, tmp_path, ckpt):
    csv_in = _head(data_dir / "regression/rxn/rxn.csv", tmp_path / "in.csv", 20)
    assert jax_main(["convert", "-i", str(data_dir / ckpt), "-o", str(tmp_path / "jax.ckpt")]) in (
        0, None)
    flags = ["-i", str(csv_in), "--reaction-columns", "smiles"]
    assert jax_main(["predict", *flags, "--model-paths", str(tmp_path / "jax.ckpt"),
                     "-o", str(tmp_path / "jax.csv")]) == 0
    assert port_main(["predict", *flags, "--model-paths", str(data_dir / ckpt), "-o",
                      str(tmp_path / "port.csv"), "--device", "cpu"]) == 0
    want, got = _rows(tmp_path / "jax.csv"), _rows(tmp_path / "port.csv")
    assert got[0] == want[0] and [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([float(r[1]) for r in got[1:]], [float(r[1]) for r in want[1:]],
                               rtol=1e-5, atol=1e-6)


def test_hpopt_searches_a_reaction_model(data_dir, tmp_path):
    """``hpopt`` takes ``train``'s reaction and component options, as the JAX
    package's does: two trials over a CGR model, each score finite."""
    import json

    csv_in = _head(data_dir / "regression/rxn/rxn.csv", tmp_path / "in.csv", 40)
    out = tmp_path / "search"
    assert port_main(["hpopt", "-i", str(csv_in), "--reaction-columns", "smiles", "-o", str(out),
                      "--num-trials", "2", "--epochs", "1", "--search-algorithm", "random",
                      "--search-parameter-keywords", "depth", "--message-hidden-dim", "16",
                      "--ffn-hidden-dim", "16", "--device", "cpu"]) == 0
    progress = json.loads((out / "all_progress.json").read_text())
    assert len(progress) == 2 and all(np.isfinite(r["score"]) for r in progress)
