"""Chemprop v1 ``.pt`` files, ``convert`` and ``train --from-foundation`` in
the port, against the JAX package on the CPU (float32):

* the v1 file's predictions within atol 1e-5 of
  example_model_v1_regression_mol_prediction.csv (the JAX package's own bar,
  tests/unit/models/test_v1_convert.py) and of ``convert_v1_model``'s on the
  same batch; ``cli predict`` finds the v1 featurizer mode by itself; what
  the port does not serve raises, as the JAX converter raises or naming the
  ``ROADMAP.md`` section that says why;
* ``convert`` of the v1 file and of the v2 ``.pt``: JAX's ``load_model``
  reads the output, whose predictions equal the port's from the source file
  and lie within 1e-5 of JAX ``convert`` + ``predict``'s; the rows of
  converted_preds_golden.csv at 1e-4
  (tests/cli/test_predict_all_checkpoints.py's bar);
* ``--from-foundation``: the message-passing tensors after the graft equal
  the file's (v1 ``.pt``, v2 ``.pt``, ``CPTPU001``); one epoch of one
  ``train`` command in both packages from one initial state: losses within
  rtol 1e-4, test predictions within 1e-4."""

from __future__ import annotations

import argparse
import csv
import json

import numpy as np
import pytest
import torch

from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu.cli.parsing import make_dataset as jax_make_dataset
from chemprop_tpu.data import MoleculeDatapoint as JaxDatapoint
from chemprop_tpu.data import PadSpec as JaxPadSpec
from chemprop_tpu.data import collate_batch as jax_collate
from chemprop_tpu.models import serialize as jserialize
from chemprop_tpu.models.torch_convert import convert_v1_model
from chemprop_tpu.train import Trainer as JaxTrainer
from chemprop_tpu_torch.cli.main import construct_parser
from chemprop_tpu_torch.cli.main import main as port_main
from chemprop_tpu_torch.cli.parsing import build_datasets, make_datapoints, parse_csv
from chemprop_tpu_torch.cli.train import build_model, graft_message_passing
from chemprop_tpu_torch.data import DataLoader
from chemprop_tpu_torch.models import load_model, serialize
from chemprop_tpu_torch.models.load import build_v1_model, load_checkpoint
from chemprop_tpu_torch.nn.init import init_parameters
from chemprop_tpu_torch.train import Trainer

V1 = "example_model_v1_regression_mol.pt"
V2 = "example_model_v2_regression_mol.pt"


@pytest.fixture(scope="module")
def golden(data_dir):
    rows = list(csv.DictReader(open(data_dir / "example_model_v1_regression_mol_prediction.csv")))
    return [r["smiles"] for r in rows], np.array([float(r["logSolubility"]) for r in rows])


def _write_smiles(path, smis):
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows([["smiles"]] + [[s] for s in smis])
    return path


def _read_preds(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.array([[float(x) for x in r[1:]]
                                                        for r in rows[1:]])


def _port_predict(model_path, in_csv, out, *flags):
    assert port_main(["predict", "--model-paths", str(model_path), "-i", str(in_csv),
                      "-o", str(out), "--device", "cpu", *flags]) == 0
    return _read_preds(out)


def test_v1_cli_predictions_match_the_golden(data_dir, golden, tmp_path, capsys):
    smis, want = golden
    in_csv = _write_smiles(tmp_path / "in.csv", smis)
    header, names, got = _port_predict(data_dir / V1, in_csv, tmp_path / "out.csv")
    assert "switching atom featurizer mode 'v2' -> 'v1'" in capsys.readouterr().err
    assert header == ["name", "logSolubility"] and names == smis
    np.testing.assert_allclose(got[:, 0], want, rtol=0, atol=1e-5)


def test_v1_model_matches_convert_v1_model(data_dir, golden):
    smis, _ = golden
    jmodel, variables, jcols = convert_v1_model(data_dir / V1)
    ds = jax_make_dataset([JaxDatapoint.from_smi(s, y=np.array([np.nan])) for s in smis],
                          multi_hot_atom_featurizer_mode="v1")
    data = [ds[i] for i in range(len(ds))]
    batch = jax_collate(data, JaxPadSpec.for_graphs([d.mg for d in data]))
    want = np.asarray(jmodel.apply(variables, batch.bmg, batch.V_d, batch.X_d,
                                   is_training=False))[batch.pad_mask]
    model, cols = load_model(data_dir / V1, "cpu")
    assert cols == jcols == ["logSolubility"]
    mp = model.message_passing
    assert (mp.d_v, mp.d_e, mp.d_h, mp.d_pad, model.bn) == (133, 14, 300, 384, None)
    tds = build_datasets([make_datapoints({"smiles": smis}, {}, np.full((len(smis), 1), np.nan),
                                          np.ones(len(smis)), None, None)[0]],
                         multi_hot_atom_featurizer_mode="v1")
    got = Trainer(model, device="cpu")
    got.init_state(keep_parameters=True)
    np.testing.assert_allclose(got.predict(DataLoader(tds, batch_size=64)), want, rtol=0,
                               atol=1e-5)


def test_v1_state_dict_in_the_ports_names(data_dir):
    d = load_checkpoint(data_dir / V1)
    _, sd, _ = build_v1_model(d)
    assert sorted(sd) == sorted([
        "message_passing.W_i.weight", "message_passing.W_h.weight", "message_passing.W_o.weight",
        "message_passing.W_o.bias", "predictor.ffn.0.0.weight", "predictor.ffn.0.0.bias",
        "predictor.ffn.1.2.weight", "predictor.ffn.1.2.bias",
        "predictor.output_transform.mean", "predictor.output_transform.scale"])
    assert torch.equal(sd["predictor.ffn.1.2.weight"], d["state_dict"]["readout.4.weight"])
    assert float(sd["predictor.output_transform.scale"]) == pytest.approx(2.07632995)


# a v1 file with atom_messages loads since AtomMessagePassing was ported
# (tests/test_torch_atom_messages.py), and one of several molecules since
# item 7's last part was (tests/test_torch_v1_multi.py). What stays refused:
# two molecules over one unshared encoder, which the JAX converter refuses
# too; atom descriptors and molecule features, which it loads as a model
# that ignores them, so the port refuses to serve them wrongly. Each case:
# (changed args, the port's message, whether the JAX converter raises)
V1_REFUSALS = {
    "two_molecules": (dict(number_of_molecules=2), "one encoder per molecule.*holds 1", True),
    "atom_descriptors": (dict(atom_descriptors="descriptor"),
                         "JAX package's converter would mis-serve.*v1 atom descriptors", False),
    "features": (dict(features_generator=["morgan"]),
                 "JAX package's converter would mis-serve.*v1 molecule features", False),
}


@pytest.mark.parametrize("case", sorted(V1_REFUSALS))
def test_v1_files_the_port_does_not_serve_are_refused(data_dir, case):
    d = load_checkpoint(data_dir / V1)
    changes, message, jax_raises = V1_REFUSALS[case]
    d["args"] = argparse.Namespace(**{**vars(d["args"]), **changes})
    with pytest.raises(ValueError, match=message):
        build_v1_model(d)
    if jax_raises:
        with pytest.raises(ValueError, match="expected 2 blocks, got 1"):
            convert_v1_model(None, _loaded=d)


# mol-atom-bond models load since they were ported (tests/test_torch_mab.py);
# what stays refused is a reference one with batch norm, as the JAX converter
# refuses it
@pytest.mark.parametrize("path,item", [("mol_atom_bond/example_models/regression.pt",
                                        "batch norm is refused, as the JAX package")])
def test_other_models_are_refused_with_their_item(data_dir, path, item):
    from chemprop_tpu_torch.models.load import build_model

    d = load_checkpoint(data_dir / path)
    d["hyper_parameters"]["batch_norm"] = True
    with pytest.raises(ValueError, match=item):
        build_model(d["hyper_parameters"], d["state_dict"])


def _leaves(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    return {k2: v2 for k, v in tree.items() for k2, v2 in _leaves(v, f"{prefix}/{k}").items()}


def test_multicomponent_model_loads_as_jax_converts_it(data_dir, tmp_path):
    """The mol+mol checkpoint, refused before, loads as a two-block model and
    ``convert`` writes it as the JAX package's converter does: the same
    manifest and parameters."""
    from chemprop_tpu.models.torch_convert import convert_model
    from chemprop_tpu_torch.models import serialize

    src = data_dir / "example_model_v2_regression_mol+mol.pt"
    model, cols = load_model(src, "cpu")
    assert type(model).__name__ == "MulticomponentMPNN" and len(model.message_passing.blocks) == 2
    assert port_main(["convert", "-i", str(src), "-o", str(tmp_path / "port.ckpt")]) == 0
    manifest, variables = serialize.read_checkpoint(tmp_path / "port.ckpt")
    jmodel, jvars, _ = convert_model(src)
    assert manifest["model"]["model_cls"] == type(jmodel).__name__
    assert manifest["model"]["message_passing"]["n_components"] == 2
    got, want = _leaves(variables["params"]), _leaves(jvars["params"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------------ convert
@pytest.fixture(scope="module")
def converted(data_dir, tmp_path_factory):
    """Both packages' ``convert`` of the v1 and v2 files, and each CLI's
    predictions on 20 SMILES of mol.csv: the port's of the source and of its
    output, JAX's of its own output."""
    root = tmp_path_factory.mktemp("convert")
    in_csv = _write_smiles(root / "in.csv", _mol_smiles(data_dir, 20))
    out = {}
    for name in (V1, V2):
        port_out, jax_out = root / f"{name}.port.ckpt", root / f"{name}.jax.ckpt"
        assert port_main(["convert", "-i", str(data_dir / name), "-o", str(port_out)]) == 0
        assert jax_main(["convert", "-i", str(data_dir / name), "-o", str(jax_out)]) in (0, None)
        src = _port_predict(data_dir / name, in_csv, root / f"{name}.src.csv")
        port = _port_predict(port_out, in_csv, root / f"{name}.port.csv")
        assert jax_main(["predict", "-i", str(in_csv), "--model-paths", str(jax_out),
                         "-o", str(root / f"{name}.jax.csv")]) in (0, None)
        out[name] = dict(port_ckpt=port_out, src=src, port=port,
                         jax=_read_preds(root / f"{name}.jax.csv"),
                         src_csv=(root / f"{name}.src.csv").read_text(),
                         port_csv=(root / f"{name}.port.csv").read_text())
    return out


def _mol_smiles(data_dir, n):
    with open(data_dir / "regression/mol/mol.csv") as f:
        return [row[0] for row in csv.reader(f)][1 : n + 1]


@pytest.mark.parametrize("name", [V1, V2])
def test_converted_file_serves_the_sources_predictions(converted, name):
    c = converted[name]
    assert c["port_csv"] == c["src_csv"]  # the same bits


@pytest.mark.parametrize("name", [V1, V2])
def test_jax_reads_the_converted_file(converted, data_dir, name):
    c = converted[name]
    model, variables, extra = jserialize.load_model(c["port_ckpt"])
    assert extra["output_columns"] == (["logSolubility"] if name == V1 else None)
    _, names, got = c["port"]
    ds = jax_make_dataset([JaxDatapoint.from_smi(s, y=np.array([np.nan])) for s in names],
                          multi_hot_atom_featurizer_mode="v1" if name == V1 else "v2")
    data = [ds[i] for i in range(len(ds))]
    batch = jax_collate(data, JaxPadSpec.for_graphs([d.mg for d in data]))
    want = np.asarray(model.apply(variables, batch.bmg, batch.V_d, batch.X_d,
                                  is_training=False))[batch.pad_mask]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", [V1, V2])
def test_converted_predictions_match_jax_convert(converted, name):
    c = converted[name]
    (ph, pn, pv), (jh, jn, jv) = c["port"], c["jax"]
    assert (ph, pn) == (jh, jn)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-5)


@pytest.mark.parametrize("conversion", ["torch_to_tpu", "v1_to_v2", "v2_0_to_v2_1"])
def test_convert_takes_the_jax_clis_choices(data_dir, tmp_path, conversion):
    out = tmp_path / "out.ckpt"
    assert port_main(["convert", "--conversion", conversion, "-i", str(data_dir / V1),
                      "-o", str(out)]) == 0
    manifest, _ = serialize.read_checkpoint(out)
    assert manifest["extra"]["output_columns"] == ["logSolubility"]


def test_converted_goldens(data_dir, tmp_path):
    golden: dict = {}
    for r in csv.DictReader(open(data_dir / "converted_preds_golden.csv")):
        golden.setdefault(r["checkpoint"], {})[r["smiles"]] = [float(r[k]) for k in ("v0", "v1")
                                                              if r[k]]
    assert len(golden) == 3
    for ckpt, per_smi in golden.items():
        in_csv = _write_smiles(tmp_path / f"{ckpt}.csv", list(per_smi))
        conv = tmp_path / f"{ckpt}.ckpt"
        assert port_main(["convert", "-i", str(data_dir / ckpt), "-o", str(conv)]) == 0
        flags = ["--uncertainty-method", "mve"] if "mve" in ckpt else []
        header, names, got = _port_predict(conv, in_csv, tmp_path / f"{ckpt}.out.csv", *flags)
        assert names == list(per_smi)
        for smi, row in zip(names, got):
            want = per_smi[smi]
            np.testing.assert_allclose(row[: len(want)], want, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{ckpt}: {smi}")


# ---------------------------------------------------------- from-foundation
def _default_model(data_dir, *flags):
    args = construct_parser().parse_args(["train", "-i", "x.csv", "--device", "cpu", *flags])
    ds = build_datasets(make_datapoints(*parse_csv(data_dir / "regression/mol/mol.csv", None,
                                                   None, None)[:6]),
                        multi_hot_atom_featurizer_mode=args.multi_hot_atom_featurizer_mode)
    return build_model(args, ds)


@pytest.mark.parametrize("source", ["v1_pt", "v2_pt", "cptpu"])
def test_graft_copies_the_files_message_passing(data_dir, tmp_path, source):
    path = {"v1_pt": data_dir / V1, "v2_pt": data_dir / V2, "cptpu": tmp_path / "f.ckpt"}[source]
    if source == "cptpu":
        assert port_main(["convert", "-i", str(data_dir / V2), "-o", str(path)]) == 0
    flags = ["--multi-hot-atom-featurizer-mode", "v1"] if source == "v1_pt" else []
    model = _default_model(data_dir, *flags)
    init_parameters(model, "lecun", torch.Generator().manual_seed(3))
    head = {k: v.clone() for k, v in model.predictor.state_dict().items()}
    graft_message_passing(model, path)
    want = load_model(path, "cpu")[0].message_passing.state_dict()
    got = model.message_passing.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k, v in model.predictor.state_dict().items():
        assert torch.equal(v, head[k]), k


def test_graft_refuses_another_width(data_dir):
    model = _default_model(data_dir, "--message-hidden-dim", "64")
    with pytest.raises(ValueError, match="does not fit"):
        graft_message_passing(model, data_dir / V2)


@pytest.fixture(scope="module")
def foundation_runs(data_dir, tmp_path_factory):
    """One epoch of ``train --from-foundation`` v2 ``.pt`` in both packages.
    The message passing comes from the file; the rest of each package's
    initial state is made the same by loading one ``CPTPU001`` file of
    seeded parameters after each ``init_state``."""
    root = tmp_path_factory.mktemp("foundation")
    mol_csv = data_dir / "regression/mol/mol.csv"
    model = _default_model(data_dir, "--batch-norm")
    init_parameters(model, "lecun", torch.Generator().manual_seed(11))
    warm = root / "init.ckpt"
    serialize.save_model(warm, model)
    _, variables = serialize.read_checkpoint(warm)
    argv = ["train", "-i", str(mol_csv), "--from-foundation", str(data_dir / V2),
            "--epochs", "1", "--batch-norm", "--split", "scaffold_balanced", "--data-seed", "2",
            "--seed", "5"]
    mp = pytest.MonkeyPatch()
    try:
        jax_init = JaxTrainer.init_state

        def jax_init_state(self, batch, steps_per_epoch):
            from flax import serialization

            state = jax_init(self, batch, steps_per_epoch)
            return state.replace(
                params=serialization.from_state_dict(state.params, variables["params"]),
                batch_stats=serialization.from_state_dict(state.batch_stats,
                                                          variables["batch_stats"]))

        mp.setattr(JaxTrainer, "init_state", jax_init_state)
        assert jax_main(argv + ["-o", str(root / "jax")]) in (0, None)
        port_init = Trainer.init_state

        def port_init_state(self, *args, **kwargs):
            state = port_init(self, *args, **kwargs)
            serialize.load_variables(self.model, variables)
            return state

        mp.setattr(Trainer, "init_state", port_init_state)
        assert port_main(argv + ["-o", str(root / "port"), "--device", "cpu"]) == 0
    finally:
        mp.undo()
    return root / "jax", root / "port"


def test_foundation_epoch_matches_jax(foundation_runs):
    jax_dir, port_dir = foundation_runs
    want = json.loads((jax_dir / "history.json").read_text())
    got = json.loads((port_dir / "history.json").read_text())
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want], rtol=1e-4,
                                   err_msg=key)
    (jh, jn, jv), (th, tn, tv) = (_read_preds(d / "test_predictions.csv") for d in foundation_runs)
    assert (th, tn) == (jh, jn)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)


def test_foundation_file_seeds_the_run(foundation_runs, data_dir):
    """The run's first steps start from the file's message passing: after
    one epoch (two Adam steps of at most 1e-4 and 3.25e-4) every weight of
    W_i, W_h and W_o lies within those steps of the file's."""
    _, port_dir = foundation_runs
    trained = load_model(port_dir / "best.ckpt", "cpu")[0].message_passing.state_dict()
    source = load_model(data_dir / V2, "cpu")[0].message_passing.state_dict()
    for k, v in source.items():
        assert float((trained[k] - v).abs().max()) <= 1e-4 + 3.25e-4 + 1e-6, k
