"""The port's native C++ featurizer (``chemprop_tpu_torch.featurizers.native``
over its copy of ``csrc/featurizer.cpp``) against the port's Python
featurizers and the JAX package's ``featurize_batch_native``, bit for bit,
on the CPU; the datasets' native caches; a failed build; and ``train
--split kmeans --use-cuikmolmaker-featurization`` and ``predict`` with the
flag against the JAX command line."""

from __future__ import annotations

import csv
import json

import numpy as np
import pytest
import torch

from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu.featurizers.native import featurize_batch_native as jax_native
from chemprop_tpu.featurizers.native import featurize_rxn_batch_native as jax_rxn_native
from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.cli.main import construct_parser
from chemprop_tpu_torch.cli.main import main as port_main
from chemprop_tpu_torch.cli.parsing import build_datasets, make_datapoints, parse_csv
from chemprop_tpu_torch.cli.train import build_model
from chemprop_tpu_torch.data import (
    CuikmolmakerDataset, CuikmolmakerReactionDataset, MoleculeDatapoint, MoleculeDataset,
    ReactionDatapoint, ReactionDataset,
)
from chemprop_tpu_torch.featurizers import (
    BatchCuikMolGraph, CuikmolmakerCGRFeaturizer, CuikmolmakerMolGraphFeaturizer,
    SimpleMoleculeMolGraphFeaturizer,
)
from chemprop_tpu_torch.featurizers import native
from chemprop_tpu_torch.featurizers.atom import MultiHotAtomFeaturizer
from chemprop_tpu_torch.featurizers.molgraph import CondensedGraphOfReactionFeaturizer
from chemprop_tpu_torch.models import serialize
from chemprop_tpu_torch.nn.init import init_parameters
from chemprop_tpu_torch.ops import build

MODES = ["REAC_PROD", "REAC_PROD_BALANCE", "REAC_DIFF", "REAC_DIFF_BALANCE", "PROD_DIFF",
         "PROD_DIFF_BALANCE"]


@pytest.fixture(scope="module")
def rxns(data_dir):
    with open(data_dir / "regression/rxn/rxn.csv", newline="") as f:
        return [r["smiles"] for r in csv.DictReader(f)][:30]


def _assert_graphs_equal(got, want, tag):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for field in ("V", "E", "edge_index", "rev_edge_index"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype or field in ("edge_index", "rev_edge_index"), (tag, i, field)
            np.testing.assert_array_equal(a, b, err_msg=f"{tag} row {i} {field}")


def _arrays_equal(nb, jnb):
    for field, a in nb._asdict().items():
        b = getattr(jnb, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_molecules_match_python_and_jax(smis):
    nb = CuikmolmakerMolGraphFeaturizer()(smis)
    assert isinstance(nb, BatchCuikMolGraph) and nb.V.shape[1:] == (72,) and nb.E.shape[1:] == (14,)
    feat = SimpleMoleculeMolGraphFeaturizer()
    _assert_graphs_equal(native.molgraphs_from_native(nb), [feat(make_mol(s)) for s in smis],
                         "smis")
    _arrays_equal(nb, jax_native(smis))
    # the batch's layout: each atom's molecule, and rev an involution
    assert nb.atom_offsets[-1] == nb.V.shape[0] and nb.edge_offsets[-1] == nb.E.shape[0]
    assert all((nb.batch[nb.atom_offsets[m]:nb.atom_offsets[m + 1]] == m).all()
               for m in range(len(smis)))
    np.testing.assert_array_equal(nb.rev[nb.rev], np.arange(len(nb.rev)))


@pytest.mark.parametrize("mode", MODES)
def test_reactions_match_python_and_jax(rxns, mode):
    nb = CuikmolmakerCGRFeaturizer(mode=mode, keep_h=True)(rxns)
    feat = CondensedGraphOfReactionFeaturizer(mode_=mode)
    want = []
    for smi in rxns:
        dp = ReactionDatapoint.from_smi(smi, keep_h=True)
        want.append(feat((dp.rct, dp.pdt)))
    _assert_graphs_equal(native.molgraphs_from_native(nb), want, mode)
    _arrays_equal(nb, jax_rxn_native(rxns, keep_h=True, mode=mode))


def test_keep_h_and_errors():
    assert native.featurize_batch_native(["[H][H]"], keep_h=True).V.shape[0] == 2
    assert native.featurize_batch_native(["[H]C([H])([H])[H]"]).V.shape[0] == 1
    with pytest.raises(ValueError, match="failed to parse 'not_a_smiles'"):
        native.featurize_batch_native(["CCO", "not_a_smiles"])
    with pytest.raises(KeyError):
        native.featurize_rxn_batch_native(["CC>>CC"], mode="reac_sum")
    empty = native.featurize_batch_native([])
    assert empty.V.shape == (0, 72) and empty.atom_offsets.tolist() == [0]


def test_datasets_fill_their_caches_natively(smis, rxns):
    dps = [MoleculeDatapoint.from_smi(s, y=np.array([1.0])) for s in smis[:20]]
    ds = MoleculeDataset(dps)
    want = [ds[i].mg for i in range(len(ds))]
    assert ds.populate_cache_native()
    _assert_graphs_equal([ds[i].mg for i in range(len(ds))], want, "MoleculeDataset")
    cuik = CuikmolmakerDataset(dps)
    assert cuik.cache
    _assert_graphs_equal([cuik[i].mg for i in range(len(cuik))], want, "CuikmolmakerDataset")
    # another featurizer: no native cache (the Python one for the Cuik dataset)
    v1 = MoleculeDataset(dps, SimpleMoleculeMolGraphFeaturizer(MultiHotAtomFeaturizer.v1()))
    assert not v1.populate_cache_native() and not v1.cache
    assert CuikmolmakerDataset(dps, v1.featurizer).cache

    rdps = [ReactionDatapoint.from_smi(s, keep_h=True) for s in rxns[:8]]
    rds = ReactionDataset(rdps, CondensedGraphOfReactionFeaturizer(mode_="PROD_DIFF"))
    want = [rds[i].mg for i in range(len(rds))]
    assert rds.populate_cache_native(keep_h=True)
    _assert_graphs_equal([rds[i].mg for i in range(len(rds))], want, "ReactionDataset")
    crds = CuikmolmakerReactionDataset(rdps, rds.featurizer, keep_h=True)
    _assert_graphs_equal([crds[i].mg for i in range(len(crds))], want, "CuikmolmakerReaction")


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """Where the JAX package falls back to Python featurization, the port
    raises (ROADMAP.md section 3): the caller asked for the native path."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed on csrc/featurizer.cpp"):
        native.featurize_batch_native(["CCO"])
    ds = MoleculeDataset([MoleculeDatapoint.from_smi("CCO")])
    with pytest.raises(RuntimeError, match="failed on csrc/featurizer.cpp"):
        ds.populate_cache_native()
    assert not list((tmp_path / "_build").glob("*.so"))


# ----------------------------------------------------------- command line
def _warm_start(path, mol_csv) -> None:
    args = construct_parser().parse_args(["train", "-i", str(mol_csv), "--device", "cpu"])
    ds = build_datasets(make_datapoints(*parse_csv(mol_csv, None, None, None)[:6]))
    model = build_model(args, ds)
    init_parameters(model, "lecun", torch.Generator().manual_seed(11))
    serialize.save_model(path, model)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, data_dir):
    """One epoch of ``train --split kmeans --use-cuikmolmaker-featurization``
    in each package from one warm start, and the port's epoch without the
    flag."""
    root = tmp_path_factory.mktemp("native_cli")
    mol_csv = data_dir / "regression/mol/mol.csv"
    _warm_start(root / "warm.ckpt", mol_csv)
    argv = ["train", "-i", str(mol_csv), "--checkpoint", str(root / "warm.ckpt"), "--epochs",
            "1", "--split", "kmeans", "--data-seed", "3", "--seed", "5"]
    flag = ["--use-cuikmolmaker-featurization"]
    assert jax_main(argv + flag + ["-o", str(root / "jax")]) == 0
    assert port_main(argv + flag + ["-o", str(root / "port"), "--device", "cpu"]) == 0
    assert port_main(argv + ["-o", str(root / "python"), "--device", "cpu"]) == 0
    return root


def test_train_kmeans_native_matches_jax(cli_runs):
    """The JAX run's splits, its losses at test_torch_cli_train.py's limit,
    its test predictions; and the port's Python featurization's loss bits."""
    def history(run):
        return json.loads((cli_runs / run / "history.json").read_text())

    def splits(run):
        return json.loads((cli_runs / run / "splits.json").read_text())

    assert splits("port") == splits("jax") == splits("python")
    np.testing.assert_allclose([r["train_loss"] for r in history("port")],
                               [r["train_loss"] for r in history("jax")], rtol=1e-5)
    for key in ("train_loss", "val_loss"):
        assert [r[key] for r in history("port")] == [r[key] for r in history("python")]
    jp = _rows(cli_runs / "jax/test_predictions.csv")
    tp = _rows(cli_runs / "port/test_predictions.csv")
    assert [r[0] for r in tp] == [r[0] for r in jp]
    np.testing.assert_allclose(np.array([r[1:] for r in tp[1:]], dtype=float),
                               np.array([r[1:] for r in jp[1:]], dtype=float), atol=1e-4)


def test_predict_with_the_flag_equals_predict_without(cli_runs, data_dir):
    mol_csv, model = data_dir / "regression/mol/mol.csv", cli_runs / "port/best.ckpt"
    out = {}
    for tag, flags in (("with", ["--use-cuikmolmaker-featurization"]), ("without", [])):
        out[tag] = cli_runs / f"preds_{tag}.csv"
        assert port_main(["predict", "-i", str(mol_csv), "--model-paths", str(model), "-o",
                          str(out[tag]), "--device", "cpu", *flags]) == 0
    assert _rows(out["with"]) == _rows(out["without"])
