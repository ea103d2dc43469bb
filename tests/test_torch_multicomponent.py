"""Multicomponent models in the port against the JAX package, on the CPU
(float32; the JAX package's plain CPU path):

* the reference checkpoints ``example_model_v2_regression_{mol+mol,rxn,
  rxn+mol}.pt`` and ``..._rxn.ckpt``: each loaded by each package its own
  way, equal predictions on 20 rows of their CSVs (rtol 1e-5, atol 1e-6);
* ``CPTPU001`` both ways: the port's file read by the JAX package's
  ``load_model`` and the JAX package's read by the port, equal predictions;
* three Adam steps of a two-block and of a shared-block model from JAX's
  initial parameters, within the limits of
  ``test_three_adam_steps_match_jax_f32``;
* one ``train`` epoch of mol+mol (two blocks, and ``--mpn-shared``) through
  each command line from one warm start, ``predict`` of the rxn+mol
  checkpoint and ``fingerprint`` of the mol+mol one through each;
* the collate (a tile table, or a split table, per component), the edge
  count of ``fit``, resuming, freezing, the component-order fix and
  ``serve``'s refusal."""

from __future__ import annotations

import csv
import json

import numpy as np
import pytest
import torch

from chemprop_tpu import data as jdata
from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu.cli.parsing import build_datasets as jax_build_datasets
from chemprop_tpu.cli.parsing import make_datapoints as jax_make_datapoints
from chemprop_tpu.cli.parsing import parse_csv as jax_parse_csv
from chemprop_tpu.cli.predict import _reorder_components as jax_reorder
from chemprop_tpu.models import serialize as jserialize
from chemprop_tpu.models.multi import MulticomponentMPNN as JaxMultiMPNN
from chemprop_tpu.models.torch_convert import convert_model
from chemprop_tpu.nn import BondMessagePassing as JaxBondMP
from chemprop_tpu.nn import MeanAggregation as JaxMean
from chemprop_tpu.nn import RegressionFFN as JaxRegressionFFN
from chemprop_tpu.nn.message_passing.multi import MulticomponentMessagePassing as JaxMultiMP
from chemprop_tpu.train import Trainer as JaxTrainer
from chemprop_tpu.train.schedulers import noam_lr_host
from chemprop_tpu_torch.cli import parsing
from chemprop_tpu_torch.cli.main import construct_parser
from chemprop_tpu_torch.cli.main import main as port_main
from chemprop_tpu_torch.cli.predict import check_plain_inputs, reorder_components
from chemprop_tpu_torch.cli.train import build_model
from chemprop_tpu_torch.data import DataLoader
from chemprop_tpu_torch.data.datasets import MulticomponentDataset
from chemprop_tpu_torch.featurizers.molgraph import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.models import MulticomponentMPNN, from_jax_params, load_model, serialize
from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
from chemprop_tpu_torch.nn.init import init_parameters
from chemprop_tpu_torch.nn.message_passing import MulticomponentMessagePassing
from chemprop_tpu_torch.train import Trainer

N_ROWS = 20
# checkpoint -> (CSV, SMILES columns, reaction columns)
REFERENCES = {
    "example_model_v2_regression_mol+mol.pt": ("regression/mol+mol/mol+mol.csv",
                                               ["smiles", "solvent"], None),
    "example_model_v2_regression_rxn.pt": ("regression/rxn/rxn.csv", None, ["smiles"]),
    "example_model_v2_regression_rxn.ckpt": ("regression/rxn/rxn.csv", None, ["smiles"]),
    "example_model_v2_regression_rxn+mol.pt": ("regression/rxn+mol/rxn+mol.csv",
                                               ["solvent_smiles"], ["rxn_smiles"]),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(data_dir, rel, smiles_cols, rxn_cols, n=N_ROWS, **kwargs):
    """Both packages' datasets of the CSV's first ``n`` rows, from one parse."""
    smis, rxns, Y, w, lt, gt = jax_parse_csv(data_dir / rel, smiles_cols, rxn_cols, None)[:6]
    smis = {k: v[:n] for k, v in smis.items()}
    rxns = {k: v[:n] for k, v in rxns.items()}
    parsed = (smis, rxns, Y[:n], w[:n], lt, gt)
    jds = jax_build_datasets(jax_make_datapoints(*parsed), **kwargs)
    tds = parsing.build_datasets(parsing.make_datapoints(*parsed), **kwargs)
    return jds, tds


def _jax_preds(jmodel, variables, jds):
    jb = next(iter(jdata.DataLoader(jds, batch_size=64, prefetch=0)))
    return np.asarray(jmodel.apply(variables, jb.bmg, jb.V_d, jb.X_d, is_training=False))


def _port_preds(model, tds):
    b = next(iter(DataLoader(tds, batch_size=64)))
    with torch.inference_mode():
        return model(b.bmg, b.V_d, b.X_d).numpy()


@pytest.fixture(scope="module")
def references(data_dir):
    out = {}
    for ckpt, (rel, sc, rc) in REFERENCES.items():
        jmodel, variables, jcols = convert_model(data_dir / ckpt)
        jds, tds = _inputs(data_dir, rel, sc, rc)
        out[ckpt] = (jmodel, variables, jcols, tds, _jax_preds(jmodel, variables, jds)[:N_ROWS])
    return out


@pytest.mark.parametrize("ckpt", sorted(REFERENCES))
def test_reference_checkpoint_matches_jax(data_dir, references, ckpt):
    jmodel, _, jcols, tds, want = references[ckpt]
    model, cols = load_model(data_dir / ckpt, "cpu")
    assert type(model).__name__ == type(jmodel).__name__ and cols == jcols
    multi = isinstance(model, MulticomponentMPNN)
    assert multi == isinstance(tds, MulticomponentDataset)
    got = _port_preds(model, tds)[:N_ROWS]
    assert got.shape == want.shape == (N_ROWS, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ckpt", ["example_model_v2_regression_mol+mol.pt",
                                  "example_model_v2_regression_rxn+mol.pt"])
def test_cptpu001_both_ways(data_dir, references, tmp_path, ckpt):
    """The port's file of the reference model read by the JAX package, and
    the JAX package's file of it read by the port: the same manifest class,
    blocks and predictions."""
    jmodel, variables, jcols, tds, want = references[ckpt]
    model, cols = load_model(data_dir / ckpt, "cpu")
    serialize.save_model(tmp_path / "port.ckpt", model, cols)
    jm2, v2, extra = jserialize.load_model(tmp_path / "port.ckpt")
    assert type(jm2).__name__ == "MulticomponentMPNN" and extra["output_columns"] == cols
    assert len(jm2.message_passing.blocks) == 2 and not jm2.message_passing.shared
    jds = _inputs(data_dir, *REFERENCES[ckpt])[0]
    np.testing.assert_allclose(_jax_preds(jm2, v2, jds)[:N_ROWS], want, rtol=1e-5, atol=1e-6)

    jserialize.save_model(tmp_path / "jax.ckpt", jmodel, variables, output_columns=jcols)
    back, cols2 = load_model(tmp_path / "jax.ckpt", "cpu")
    assert isinstance(back, MulticomponentMPNN) and cols2 == jcols
    np.testing.assert_allclose(_port_preds(back, tds)[:N_ROWS], want, rtol=1e-5, atol=1e-6)


def test_reorder_matches_jax(data_dir):
    """The component-order fix puts the rxn+mol components in the
    checkpoint's (molecule, reaction) order from either order, as JAX's."""
    path = data_dir / "example_model_v2_regression_rxn+mol.pt"
    model, _ = load_model(path, "cpu")
    _, variables, _ = convert_model(path)
    smis, rxns, Y, w, lt, gt = jax_parse_csv(data_dir / REFERENCES[path.name][0],
                                             ["solvent_smiles"], ["rxn_smiles"], None)[:6]
    parsed = ({k: v[:4] for k, v in smis.items()}, {k: v[:4] for k, v in rxns.items()}, Y[:4],
              w[:4], lt, gt)
    args = construct_parser().parse_args(["predict", "-i", "x.csv", "--model-path", str(path)])
    port, jax_ = parsing.make_datapoints(*parsed), jax_make_datapoints(*parsed)
    for order in ([0, 1], [1, 0]):
        got = reorder_components([port[i] for i in order], model, args)
        want = jax_reorder([jax_[i] for i in order], variables, args)
        assert [type(c[0]).__name__ for c in got] == [type(c[0]).__name__ for c in want] == [
            "MoleculeDatapoint", "ReactionDatapoint"]


# ----------------------------------------------------------------- training
D_H = 64
THREE_LRS = sum(noam_lr_host(k, 4, 96, 1e-4, 1e-3, 1e-4) for k in range(3))


@pytest.mark.parametrize("shared", [False, True], ids=["two_blocks", "shared"])
def test_three_adam_steps_match_jax_f32(data_dir, shared):
    """Three steps of both trainers from JAX's initial parameters on mol+mol
    (batches of 16): the losses at rtol 1e-5, and every parameter (a shared
    block's takes both components' gradients) and batch-norm statistic
    within twice the steps' rates, rtol 1e-4 / atol 1e-6 for all but one
    element in a thousand."""
    jds, tds = _inputs(data_dir, *REFERENCES["example_model_v2_regression_mol+mol.pt"], n=48)
    for ds in (jds, tds):
        ds.normalize_targets()
    n_blocks = 1 if shared else 2
    jmodel = JaxMultiMPNN(
        message_passing=JaxMultiMP(blocks=[JaxBondMP(d_h=D_H) for _ in range(n_blocks)],
                                   n_components=2, shared=shared),
        agg=JaxMean(), predictor=JaxRegressionFFN(input_dim=2 * D_H, hidden_dim=D_H),
        batch_norm=True)
    model = MulticomponentMPNN(
        MulticomponentMessagePassing([BondMessagePassing(d_h=D_H) for _ in range(n_blocks)],
                                     2, shared),
        MeanAggregation(), RegressionFFN(input_dim=2 * D_H, hidden_dim=D_H,
                                         output_transform=False), batch_norm=True)
    jloader = jdata.DataLoader(jds, batch_size=16, shuffle=False, prefetch=0)
    tloader = DataLoader(tds, batch_size=16, shuffle=False)
    jbatches, tbatches = list(jloader), list(tloader)
    jtrainer = JaxTrainer(jmodel, max_epochs=50, warmup_epochs=2, seed=12)
    state = jtrainer.init_state(jbatches[0], len(jloader))
    trainer = Trainer(model, max_epochs=50, warmup_epochs=2, seed=12, device="cpu")
    trainer.init_state(tbatches[0], len(tloader))
    model.load_state_dict(from_jax_params(state.params, state.batch_stats))
    import jax

    jstep = jax.jit(jtrainer._train_body())
    jlosses, tlosses = [], []
    for jb, tb in zip(jbatches, tbatches):
        state, loss = jstep(state, jb)
        jlosses.append(float(loss))
        tlosses.append(float(trainer.train_step(tb)))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    want = from_jax_params(state.params, state.batch_stats)
    got = {k: v.detach() for k, v in model.state_dict().items()}
    assert set(got) == set(want)
    assert {k.split(".")[2] for k in got if k.startswith("message_passing")} == {
        str(i) for i in range(n_blocks)}
    n_bad = n_all = 0
    for name in want:
        err = (got[name] - want[name]).abs()
        assert float(err.max()) <= 2 * THREE_LRS, name
        n_bad += int((err > 1e-6 + 1e-4 * want[name].abs()).sum())
        n_all += err.numel()
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)


def _tiny_model(shared=False, d_h=16):
    n_blocks = 1 if shared else 2
    return MulticomponentMPNN(
        MulticomponentMessagePassing([BondMessagePassing(d_h=d_h) for _ in range(n_blocks)],
                                     2, shared),
        MeanAggregation(), RegressionFFN(input_dim=2 * d_h, hidden_dim=d_h), batch_norm=True)


def test_each_component_has_its_own_tile_table(data_dir):
    """mol+mol's dyes of more than 128 directed edges give their component a
    split table and cross rows; the other component keeps a tile table, and
    each table moves checked for its own graph's rows."""
    _, tds = _inputs(data_dir, *REFERENCES["example_model_v2_regression_mol+mol.pt"], n=99)
    batches = list(DataLoader(tds, batch_size=50))
    assert all(isinstance(b.bmg, tuple) and len(b.bmg) == 2 for b in batches)
    split = [b for b in batches if b.bmg[0].tile_ptr is None]
    assert split and all(b.bmg[0].split_ptr is not None and len(b.bmg[0].cross_rows)
                         for b in split)
    assert all(b.bmg[1].tile_ptr is not None for b in batches)
    moved = batches[0].to("cpu")
    for g in moved.bmg:
        table = g.tile_ptr if g.tile_ptr is not None else g.split_ptr
        assert table.checked_for_rows == g.E.shape[0]
    assert moved.bmg[0].E.shape[0] != moved.bmg[1].E.shape[0]
    # targets, weights and X_d are component 0's
    assert torch.equal(moved.w, batches[0].w) and moved.V_d is None


def test_fit_counts_every_components_edges(data_dir, tmp_path):
    """``edges_per_s`` counts the real edges of both components; ``last.ckpt``
    resumes to the same state; ``freeze`` of the message passing keeps both
    blocks."""
    _, tds = _inputs(data_dir, *REFERENCES["example_model_v2_regression_mol+mol.pt"], n=24)
    tds.normalize_targets()
    loader = DataLoader(tds, batch_size=12)
    edges = sum(int(g.edge_mask.sum()) for b in loader for g in b.bmg)
    model = _tiny_model()
    trainer = Trainer(model, max_epochs=2, seed=3, device="cpu", checkpoint_dir=tmp_path)
    trainer.fit(loader)
    for r in trainer.history:
        assert r["edges_per_s"] * r["time_s"] == pytest.approx(edges, rel=1e-9)
    resumed = Trainer(_tiny_model(), max_epochs=2, seed=3, device="cpu")
    assert resumed.resume_from(tmp_path / "last.ckpt", None, len(loader)) == 2
    for (k, a), b in zip(trainer.state.params.items(), resumed.state.params.values()):
        assert torch.equal(a, b), k
    for a, b in zip(trainer.state.nu, resumed.state.nu):
        assert torch.equal(a, b)

    frozen = Trainer(_tiny_model(), max_epochs=1, seed=3, device="cpu",
                     freeze=lambda p: p.startswith("message_passing"))
    frozen.init_state(None, len(loader))
    before = {k: v.clone() for k, v in frozen.state.params.items()}
    frozen.fit(loader)
    for k, v in frozen.state.params.items():
        assert torch.equal(v, before[k]) == k.startswith("message_passing"), k
    assert {k for k in frozen._frozen} == {k for k in before if k.startswith("message_passing")}


def test_serve_refuses_a_multicomponent_model(data_dir):
    model, _ = load_model(data_dir / "example_model_v2_regression_mol+mol.pt", "cpu")
    with pytest.raises(ValueError, match="one SMILES per row"):
        check_plain_inputs(model, SimpleMoleculeMolGraphFeaturizer())


# ------------------------------------------------------------ command line
def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _head(src, dst, n):
    with open(src, newline="") as f:
        rows = list(csv.reader(f))[: n + 1]
    with open(dst, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return dst


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree, dtype=np.float64)}


def train_both(tmp_path, argv: list[str], epochs: int = 1):
    """``train`` of each command line from one warm start (a ``CPTPU001`` file
    of the port's model for ``argv``, its parameters from a seed): the two
    output directories."""
    args = construct_parser().parse_args(["train", *argv, "--device", "cpu"])
    from chemprop_tpu_torch.cli.train import _read_inputs, process_train_args

    args.data_paths, args.data_path = args.data_path, args.data_path[0]
    process_train_args(args)
    _, components = _read_inputs(args, args.data_path, [], True)
    ds = parsing.build_datasets(components, multi_hot_atom_featurizer_mode=
                                args.multi_hot_atom_featurizer_mode, rxn_mode=args.rxn_mode)
    model = build_model(args, ds)
    init_parameters(model, "lecun", torch.Generator().manual_seed(11))
    serialize.save_model(tmp_path / "warm.ckpt", model)
    full = ["train", *argv, "--checkpoint", str(tmp_path / "warm.ckpt"), "--epochs", str(epochs)]
    assert jax_main(full + ["-o", str(tmp_path / "jax")]) == 0
    assert port_main(full + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    return tmp_path / "jax", tmp_path / "port"


def assert_runs_match(jax_dir, port_dir, steps_lrs: float):
    """Splits equal, the losses at rtol 1e-5, ``best.ckpt`` within twice the
    steps' rates and rtol 1e-4 / atol 1e-6 for all but one element in a
    thousand, the test predictions within 1e-4; JAX reads the port's file."""
    assert (json.loads((port_dir / "splits.json").read_text())
            == json.loads((jax_dir / "splits.json").read_text()))
    want = json.loads((jax_dir / "history.json").read_text())
    got = json.loads((port_dir / "history.json").read_text())
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want], rtol=1e-5,
                                   err_msg=key)
    w = _flat({k: v for k, v in serialize.read_checkpoint(jax_dir / "best.ckpt")[1].items()
               if k in ("params", "batch_stats")})
    g = _flat({k: v for k, v in serialize.read_checkpoint(port_dir / "best.ckpt")[1].items()
               if k in ("params", "batch_stats")})
    assert set(g) == set(w)
    n_bad = n_all = 0
    for name in w:
        err = np.abs(g[name] - w[name])
        assert err.max() <= 2 * steps_lrs, name
        n_bad += int((err > 1e-6 + 1e-4 * np.abs(w[name])).sum())
        n_all += err.size
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)
    jp, tp = _rows(jax_dir / "test_predictions.csv"), _rows(port_dir / "test_predictions.csv")
    assert tp[0] == jp[0] and [r[0] for r in tp] == [r[0] for r in jp]
    np.testing.assert_allclose([[float(x) for x in r[1:]] for r in tp[1:]],
                               [[float(x) for x in r[1:]] for r in jp[1:]], rtol=0, atol=1e-4)
    jmodel, _, _ = jserialize.load_model(port_dir / "best.ckpt")
    return jmodel


# 40 rows: 32 train rows in batches of 16, two steps of the warm-up
CLI_STEPS_LRS = sum(noam_lr_host(k, 4, 1, 1e-4, 1e-3, 1e-4) for k in range(2))


@pytest.mark.parametrize("shared", [False, True], ids=["two_blocks", "mpn_shared"])
def test_cli_epoch_of_mol_mol_matches_jax(data_dir, tmp_path, shared):
    csv_in = _head(data_dir / "regression/mol+mol/mol+mol.csv", tmp_path / "in.csv", 40)
    argv = ["-i", str(csv_in), "-s", "smiles", "solvent", "--batch-norm", "-b", "16",
            "--message-hidden-dim", "32", "--ffn-hidden-dim", "16", "--save-smiles-splits",
            *(["--mpn-shared"] if shared else [])]
    jax_dir, port_dir = train_both(tmp_path, argv)
    jmodel = assert_runs_match(jax_dir, port_dir, CLI_STEPS_LRS)
    assert type(jmodel).__name__ == "MulticomponentMPNN"
    assert jmodel.message_passing.shared == shared
    assert len(jmodel.message_passing.blocks) == (1 if shared else 2)
    assert _rows(port_dir / "test_smiles.csv") == _rows(jax_dir / "test_smiles.csv")
    assert _rows(port_dir / "test_smiles.csv")[0] == ["smiles", "solvent"]


def test_cli_predict_of_rxn_mol_matches_jax(data_dir, tmp_path):
    src = data_dir / "example_model_v2_regression_rxn+mol.pt"
    csv_in = _head(data_dir / "regression/rxn+mol/rxn+mol.csv", tmp_path / "in.csv", N_ROWS)
    assert jax_main(["convert", "-i", str(src), "-o", str(tmp_path / "jax.ckpt")]) in (0, None)
    flags = ["-i", str(csv_in), "--reaction-columns", "rxn_smiles", "-s", "solvent_smiles"]
    assert jax_main(["predict", *flags, "--model-paths", str(tmp_path / "jax.ckpt"),
                     "-o", str(tmp_path / "jax.csv")]) == 0
    for model in (src, tmp_path / "jax.ckpt"):
        assert port_main(["predict", *flags, "--model-paths", str(model), "-o",
                          str(tmp_path / "port.csv"), "--device", "cpu"]) == 0
        want, got = _rows(tmp_path / "jax.csv"), _rows(tmp_path / "port.csv")
        assert got[0] == want[0] == ["name", "pred_0"]
        assert [r[0] for r in got] == [r[0] for r in want]
        np.testing.assert_allclose([float(r[1]) for r in got[1:]],
                                   [float(r[1]) for r in want[1:]], rtol=1e-5, atol=1e-6)


def test_cli_fingerprint_of_mol_mol_matches_jax(data_dir, tmp_path):
    src = data_dir / "example_model_v2_regression_mol+mol.pt"
    csv_in = _head(data_dir / "regression/mol+mol/mol+mol.csv", tmp_path / "in.csv", N_ROWS)
    assert jax_main(["convert", "-i", str(src), "-o", str(tmp_path / "jax.ckpt")]) in (0, None)
    flags = ["-i", str(csv_in), "-s", "smiles", "solvent", "--ffn-block-index", "0"]
    assert jax_main(["fingerprint", *flags, "--model-paths", str(tmp_path / "jax.ckpt"),
                     "-o", str(tmp_path / "jax.npz")]) == 0
    assert port_main(["fingerprint", *flags, "--model-paths", str(src), "-o",
                      str(tmp_path / "port.npz"), "--device", "cpu"]) == 0
    want, got = np.load(tmp_path / "jax.npz")["fps"], np.load(tmp_path / "port.npz")["fps"]
    assert got.shape == want.shape == (N_ROWS, 600)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cli_epoch_with_per_component_extra_inputs_matches_jax(data_dir, tmp_path):
    """Extra inputs given per component as ``IDX PATH`` pairs (atom features
    of both components, bond features of the first, atom descriptors of the
    second, molecule descriptors), each scaled on its own component: one
    epoch of both command lines from one warm start (80 training rows in
    batches of 64: two steps)."""
    d = data_dir / "regression/mol+mol"
    argv = ["-i", str(d / "mol+mol.csv"), "-s", "smiles", "solvent", "--batch-norm",
            "--message-hidden-dim", "32", "--ffn-hidden-dim", "16",
            "--atom-features-path", "0", str(d / "atom_features_0.npz"), "1",
            str(d / "atom_features_1.npz"), "--bond-features-path", "0",
            str(d / "bond_features_0.npz"), "--atom-descriptors-path", "1",
            str(d / "atom_descriptors_1.npz"), "--descriptors-path", str(d / "descriptors.npz")]
    jax_dir, port_dir = train_both(tmp_path, argv)
    assert_runs_match(jax_dir, port_dir, CLI_STEPS_LRS)
    manifest = serialize.read_checkpoint(port_dir / "best.ckpt")[0]["model"]
    b0, b1 = (b["__submodule__"] for b in manifest["message_passing"]["blocks"])
    assert b0["graph_transform"]["E"] is not None and b0["d_vd"] is None
    assert b1["graph_transform"]["E"] is None and b1["d_vd"] == 3
    assert manifest["predictor"]["input_dim"] == 32 + 35 + 2


def test_trainer_paths_take_a_tuple_of_graphs(data_dir):
    """Validation with metrics, ``predict``, ``predict_mc_dropout`` and the
    loader's class-balance and ``drop_last`` over multicomponent batches."""
    from chemprop_tpu_torch.nn.metrics import MAE

    _, tds = _inputs(data_dir, *REFERENCES["example_model_v2_regression_mol+mol.pt"], n=20)
    tds.normalize_targets()
    model = MulticomponentMPNN(
        MulticomponentMessagePassing([BondMessagePassing(d_h=16, dropout=0.2) for _ in range(2)],
                                     2),
        MeanAggregation(), RegressionFFN(input_dim=32, hidden_dim=16, dropout=0.2))
    trainer = Trainer(model, max_epochs=1, seed=1, device="cpu", val_metrics={"mae": MAE()})
    trainer.fit(DataLoader(tds, batch_size=8, shuffle=True, drop_last=True),
                DataLoader(tds, batch_size=8))
    assert np.isfinite([trainer.history[0][k] for k in ("val_loss", "val_mae")]).all()
    preds = trainer.predict(DataLoader(tds, batch_size=8))
    mc = trainer.predict_mc_dropout(DataLoader(tds, batch_size=8), sampling_size=3)
    assert preds.shape == (20, 1) and mc.shape == (3, 20, 1) and mc.var(0).max() > 0
    with torch.inference_mode():
        enc = model.encoding(next(iter(DataLoader(tds, batch_size=8))).bmg, i=0)
    assert enc.shape == (8, 32)
    assert len(DataLoader(tds, batch_size=8, drop_last=True)) == 2
    balanced = DataLoader(tds, batch_size=8, class_balance=True, seed=0)
    assert all(len(b.bmg) == 2 for b in balanced)
