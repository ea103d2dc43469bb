"""Chemprop v1 ``.pt`` files of two molecules in the port, against the JAX
package's ``convert_v1_model`` on the CPU (float32).

No golden file of one exists, so the files are built by
``chip_smoke.two_molecule_v1`` (the recipe phase 18 of ``chip_smoke.py``
uses on the card): the reference v1 file with ``number_of_molecules=2``, a
second encoder of the first one's tensors plus seeded noise, and the
readout's first layer widened to 600 inputs; in regression and in binary
classification.

* The port's state dict equals ``from_jax_params`` of JAX's parameters
  tensor by tensor; predictions on the first 20 rows of
  tests/data/regression/mol+mol/mol+mol.csv agree within atol 1e-5 (the
  bar of ``tests/test_torch_v1_convert.py``'s single-molecule case) through
  the library, and through ``predict`` and ``fingerprint`` of each command
  line (the JAX CLI reads its own ``convert`` of the file and needs
  ``--multi-hot-atom-featurizer-mode v1``; the port finds the mode).
* ``convert`` writes what the JAX package reads; ``train
  --from-foundation`` grafts each block (and its epoch's one Adam step keeps
  every weight within the step's rate of the file's), and both command
  lines refuse the file for a single-molecule model.
* Where JAX's converter raises (one encoder, two molecules, unshared), the
  port raises. A shared encoder, which v1 saves as one module repeated at
  every index, makes JAX's converter raise; the port loads it as one shared
  block and serves what JAX serves from the file without the repeats."""

from __future__ import annotations

import argparse
import csv
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu.cli.parsing import build_datasets as jax_build_datasets
from chemprop_tpu.cli.parsing import make_datapoints as jax_make_datapoints
from chemprop_tpu.cli.parsing import parse_csv as jax_parse_csv
from chemprop_tpu.cli.train import _warm_start_encoder
from chemprop_tpu.data import DataLoader as JaxDataLoader
from chemprop_tpu.models import serialize as jserialize
from chemprop_tpu.models.torch_convert import convert_v1_model
from chemprop_tpu_torch.cli import parsing
from chemprop_tpu_torch.cli.main import main as port_main
from chemprop_tpu_torch.cli.train import graft_message_passing
from chemprop_tpu_torch.data import DataLoader
from chemprop_tpu_torch.models import MulticomponentMPNN, from_jax_params, load_model, serialize
from chemprop_tpu_torch.models.load import build_v1_model, load_checkpoint

from chip_smoke import two_molecule_v1  # noqa: E402

N_ROWS = 20
MOL_MOL = "regression/mol+mol/mol+mol.csv"
KINDS = ("regression", "classification")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("v1_multi")
    out = {kind: two_molecule_v1(root / f"{kind}.pt", kind) for kind in KINDS}
    out["shared"] = two_molecule_v1(root / "shared.pt", shared=True)
    return out


@pytest.fixture(scope="module")
def rows(data_dir, tmp_path_factory):
    """The first ``N_ROWS`` rows of mol+mol.csv as a CSV, and both packages'
    datasets of them in the v1 featurizer mode, from one parse."""
    path = tmp_path_factory.mktemp("v1_multi_rows") / "mm.csv"
    with open(data_dir / MOL_MOL, newline="") as f:
        head = list(csv.reader(f))[: N_ROWS + 1]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(head)
    parsed = jax_parse_csv(path, ["smiles", "solvent"], None, None)[:6]
    jds = jax_build_datasets(jax_make_datapoints(*parsed), multi_hot_atom_featurizer_mode="v1")
    tds = parsing.build_datasets(parsing.make_datapoints(*parsed),
                                 multi_hot_atom_featurizer_mode="v1")
    return path, jds, tds


def _jax_preds(jmodel, variables, jds):
    jb = next(iter(JaxDataLoader(jds, batch_size=64, prefetch=0)))
    return np.asarray(jmodel.apply(variables, jb.bmg, jb.V_d, jb.X_d,
                                   is_training=False))[:N_ROWS]


def _port_preds(model, tds):
    b = next(iter(DataLoader(tds, batch_size=64)))
    with torch.inference_mode():
        return model(b.bmg, b.V_d, b.X_d).numpy()[:N_ROWS]


def _csv_values(path):
    with open(path, newline="") as f:
        header, *body = list(csv.reader(f))
    return header, [r[0] for r in body], np.array([[float(x) for x in r[1:]] for r in body])


@pytest.mark.parametrize("kind", KINDS)
def test_parameters_equal_jax_tensor_by_tensor(files, kind):
    jmodel, jvars, jcols = convert_v1_model(files[kind])
    model, sd, cols = build_v1_model(load_checkpoint(files[kind]))
    assert type(model).__name__ == type(jmodel).__name__ == "MulticomponentMPNN"
    assert cols == jcols == ["logSolubility"]
    assert [b.d_v for b in model.message_passing.blocks] == [133, 133]
    assert model.predictor.input_dim == model.message_passing.output_dim == 600
    want = from_jax_params(jvars["params"])
    transforms = {k for k in sd if "output_transform" in k}
    assert set(sd) - transforms == set(want)
    assert bool(transforms) == (kind == "regression")
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    model.load_state_dict(sd)  # every tensor has its place


@pytest.mark.parametrize("kind", KINDS)
def test_library_predictions_match_jax(files, rows, kind):
    _, jds, tds = rows
    want = _jax_preds(*convert_v1_model(files[kind])[:2], jds)
    model, _ = load_model(files[kind], "cpu")
    got = _port_preds(model, tds)
    assert got.shape == want.shape == (N_ROWS, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def cli_runs(files, rows, tmp_path_factory):
    """``predict`` and ``fingerprint`` of the regression file through each
    command line: the port reads the ``.pt`` and finds its featurizer mode,
    the JAX CLI its own ``convert`` of it with the v1 mode given."""
    path, _, _ = rows
    root = tmp_path_factory.mktemp("v1_multi_cli")
    jax_ckpt = root / "jax.ckpt"
    assert jax_main(["convert", "-i", str(files["regression"]), "-o", str(jax_ckpt)]) in (0, None)
    flags = ["-i", str(path), "-s", "smiles", "solvent"]
    out = {}
    for sub, suffix in (("predict", "csv"), ("fingerprint", "npz")):
        port, jax = root / f"port.{sub}.{suffix}", root / f"jax.{sub}.{suffix}"
        assert port_main([sub, *flags, "--model-paths", str(files["regression"]), "-o",
                          str(port), "--device", "cpu"]) == 0
        assert jax_main([sub, *flags, "--model-paths", str(jax_ckpt), "-o", str(jax),
                         "--multi-hot-atom-featurizer-mode", "v1"]) == 0
        out[sub] = (port, jax)
    return out


def test_predict_cli_matches_jax(cli_runs):
    (ph, pn, pv), (jh, jn, jv) = (_csv_values(p) for p in cli_runs["predict"])
    assert ph == jh == ["name", "logSolubility"] and pn == jn and len(pn) == N_ROWS
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-5)


def test_fingerprint_cli_matches_jax(cli_runs):
    got, want = (np.load(p)["fps"] for p in cli_runs["fingerprint"])
    assert got.shape == want.shape == (N_ROWS, 300)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_convert_writes_what_jax_reads(files, rows, tmp_path):
    _, jds, tds = rows
    assert port_main(["convert", "-i", str(files["regression"]), "-o",
                      str(tmp_path / "port.ckpt")]) == 0
    jmodel, jvars, extra = jserialize.load_model(tmp_path / "port.ckpt")
    assert type(jmodel).__name__ == "MulticomponentMPNN"
    assert extra["output_columns"] == ["logSolubility"]
    manifest, _ = serialize.read_checkpoint(tmp_path / "port.ckpt")
    assert manifest["model"]["message_passing"]["n_components"] == 2
    model, _ = load_model(files["regression"], "cpu")
    np.testing.assert_allclose(_jax_preds(jmodel, jvars, jds), _port_preds(model, tds),
                               rtol=0, atol=1e-5)


def _mol_mol_model(data_dir, *flags):
    from chemprop_tpu_torch.cli.main import construct_parser
    from chemprop_tpu_torch.cli.train import build_model

    args = construct_parser().parse_args(["train", "-i", "x.csv", "--device", "cpu", *flags])
    smis, rxns, Y, w, lt, gt = parsing.parse_csv(data_dir / MOL_MOL, args.smiles_columns, None,
                                                 ["peakwavs_max"])[:6]
    smis = {k: v[:8] for k, v in smis.items()}
    ds = parsing.build_datasets(parsing.make_datapoints(smis, rxns, Y[:8], w[:8], lt, gt),
                                multi_hot_atom_featurizer_mode="v1")
    return build_model(args, ds)


def test_from_foundation_grafts_each_block(data_dir, files):
    model = _mol_mol_model(data_dir, "-s", "smiles", "solvent",
                           "--multi-hot-atom-featurizer-mode", "v1")
    graft_message_passing(model, files["regression"])
    want = from_jax_params(convert_v1_model(files["regression"])[1]["params"])
    got = {f"message_passing.{k}": v for k, v in model.message_passing.state_dict().items()}
    assert set(got) == {k for k in want if k.startswith("message_passing.")}
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


def test_train_from_foundation_takes_the_file(files, rows, tmp_path):
    """``train --from-foundation`` of the two-molecule file on mol+mol rows
    (the v1 mode given, as the graft needs the file's widths): one epoch of
    one Adam step at the warm-up's first rate, 1e-4, so every message-passing
    weight of ``best.ckpt`` lies within that step of the file's."""
    path, _, _ = rows
    assert port_main(["train", "-i", str(path), "-s", "smiles", "solvent",
                      "--multi-hot-atom-featurizer-mode", "v1", "--from-foundation",
                      str(files["regression"]), "--epochs", "1", "-o", str(tmp_path / "out"),
                      "--device", "cpu"]) == 0
    trained = load_model(tmp_path / "out" / "best.ckpt", "cpu")[0].message_passing.state_dict()
    source = load_model(files["regression"], "cpu")[0].message_passing.state_dict()
    assert set(trained) == set(source)
    for k, v in source.items():
        assert float((trained[k] - v).abs().max()) <= 1e-4 + 1e-6, k


def test_from_foundation_refused_for_one_molecule_in_both(data_dir, files):
    """A single-molecule model takes no two-block file: the port refuses it
    by shape, the JAX CLI's graft (``_warm_start_encoder``) by its keys."""
    model = _mol_mol_model(data_dir, "-s", "smiles", "--multi-hot-atom-featurizer-mode", "v1")
    with pytest.raises(ValueError, match="does not fit"):
        graft_message_passing(model, files["regression"])
    one_block = {w: {"kernel": np.zeros((1, 1), np.float32)} for w in ("W_i", "W_h", "W_o")}
    state = SimpleNamespace(params={"message_passing": one_block})
    trainer = SimpleNamespace(init_state=lambda *a: state)
    jargs = argparse.Namespace(from_foundation=str(files["regression"]))
    with pytest.raises(ValueError, match="keys do not match"):
        _warm_start_encoder(trainer, jargs, [None])


def test_one_encoder_for_two_molecules_raises_in_both(data_dir, tmp_path):
    d = load_checkpoint(data_dir / "example_model_v1_regression_mol.pt")
    d["args"] = argparse.Namespace(**{**vars(d["args"]), "number_of_molecules": 2})
    torch.save(d, tmp_path / "one_encoder.pt")
    with pytest.raises(ValueError, match="expected 2 blocks, got 1"):
        convert_v1_model(tmp_path / "one_encoder.pt")
    with pytest.raises(ValueError, match="one encoder per molecule"):
        build_v1_model(load_checkpoint(tmp_path / "one_encoder.pt"))


def test_shared_encoder_loads_as_one_block(files, rows, tmp_path):
    """v1 saves a shared encoder as one module repeated in a ``ModuleList``,
    so its state dict repeats the module's tensors at every index (as
    PyTorch's ``state_dict`` of ``ModuleList([m] * 2)`` does). JAX's
    converter counts two encoders and raises; the port loads one shared
    block, which serves what JAX serves from the file without the repeats."""
    repeated = torch.nn.ModuleList([torch.nn.Linear(2, 2)] * 2).state_dict()
    assert sorted(repeated) == ["0.bias", "0.weight", "1.bias", "1.weight"]
    d = load_checkpoint(files["shared"])
    assert any(k.startswith("encoder.encoder.1.") for k in d["state_dict"])
    with pytest.raises(ValueError, match="only one block may be given when 'shared' is True"):
        convert_v1_model(files["shared"])
    model, _ = load_model(files["shared"], "cpu")
    mp = model.message_passing
    assert isinstance(model, MulticomponentMPNN) and mp.shared and len(mp.blocks) == 1
    d["state_dict"] = {k: v for k, v in d["state_dict"].items()
                       if not k.startswith("encoder.encoder.1.")}
    torch.save(d, tmp_path / "deduplicated.pt")
    _, jds, tds = rows
    want = _jax_preds(*convert_v1_model(tmp_path / "deduplicated.pt")[:2], jds)
    np.testing.assert_allclose(_port_preds(model, tds), want, rtol=0, atol=1e-5)


def test_shared_encoder_with_differing_repeats_raises(files):
    d = load_checkpoint(files["shared"])
    d["state_dict"]["encoder.encoder.1.W_h.weight"] = d["state_dict"][
        "encoder.encoder.1.W_h.weight"] + 1.0
    with pytest.raises(ValueError, match="holds encoder 1 apart from encoder 0"):
        build_v1_model(d)
