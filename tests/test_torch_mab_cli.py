"""The port's command line on mol-atom-bond (MAB) models against the JAX
package's on the CPU: ``predict`` of the 14 reference checkpoints against
the JAX CLI's output of the same file (its ``convert``), the reference's own
predictions of its atom-mapped corpus (500 of 500 molecules) and the extras
golden file, ensembles, Monte-Carlo dropout and a head's uncertainty,
``train`` of each bundled CSV (regression, bounded, classification,
multiclass, constrained) from one set of initial parameters in both command
lines, and ``fingerprint``'s three tables. Small size: the bundled CSVs' 11
molecules at d_h = 32 for ``train``; the reference checkpoints at their own
d_h = 300."""

from __future__ import annotations

import ast
import csv
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu.models import serialize as jserialize
from chemprop_tpu.train.mab_trainer import MABTrainer as JaxMABTrainer
from chemprop_tpu_torch.cli import mab as tmab
from chemprop_tpu_torch.cli.main import construct_parser
from chemprop_tpu_torch.cli.main import main as port_main
from chemprop_tpu_torch.cli.train import process_train_args
from chemprop_tpu_torch.data import MolAtomBondDataset
from chemprop_tpu_torch.models import serialize
from chemprop_tpu_torch.nn.init import init_parameters
from chemprop_tpu_torch.train.mab_trainer import MABTrainer

sys.path.insert(0, str(Path(__file__).resolve().parent / "cli"))
from test_predict_all_checkpoints import _mab_argv  # noqa: E402  (the JAX tests' inputs)
from test_torch_multicomponent import CLI_STEPS_LRS, _flat  # noqa: E402

MODELS = "mol_atom_bond/example_models"
CHECKPOINTS = ["QM_descriptors.pt", "atomic_regression_atom_mapped.pt", "classification.pt",
               "multiclass.pt", "regression.pt", "regression_constrained.pt",
               "regression_mve.pt", "regression_no_atom.pt", "regression_no_bond.pt",
               "regression_no_mol.pt", "regression_only_atom.pt", "regression_only_bond.pt",
               "regression_only_mol.pt", "regression_with_extras.pt"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(path: Path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _values(cell: str) -> np.ndarray:
    return np.atleast_1d(np.array(ast.literal_eval(cell) if cell else np.nan, dtype=float))


def assert_csvs_match(got: Path, want: Path, rtol: float, atol: float) -> int:
    """Same header and names, every value (list cells element by element)
    within the limits; the number of rows."""
    g, w = _rows(got), _rows(want)
    assert list(g[0]) == list(w[0]) and len(g) == len(w)
    for i, (rg, rw) in enumerate(zip(g, w)):
        assert rg["smiles"] == rw["smiles"]
        for col in rw:
            if col != "smiles":
                a, b = _values(rg[col]), _values(rw[col])
                assert a.shape == b.shape, (i, col)
                np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{i} {col}")
    return len(g)


@pytest.fixture(scope="module")
def converted(tmp_path_factory, data_dir):
    """Each reference checkpoint as the JAX package's ``convert`` writes it."""
    root = tmp_path_factory.mktemp("mab_convert")

    def convert(name: str) -> Path:
        out = root / f"{name}.ckpt"
        if not out.exists():
            assert jax_main(["convert", "-i", str(data_dir / MODELS / name), "-o", str(out)]) \
                in (0, None)
        return out

    return convert


@pytest.mark.parametrize("ckpt", CHECKPOINTS)
def test_predict_of_reference_checkpoints_matches_jax(data_dir, tmp_path, converted, ckpt):
    """The port's ``predict`` of the reference file, and of JAX's converted
    one, against the JAX CLI's: the same columns, every value at rtol 1e-5 /
    atol 1e-6 (the lists are rounded to 6 places in both)."""
    argv = ["predict", *_mab_argv(data_dir, ckpt)]
    if ckpt == "atomic_regression_atom_mapped.pt":  # its first 100 of 500 molecules
        lines = Path(argv[2]).read_text().splitlines()[:101]
        argv[2] = str(tmp_path / "corpus.csv")
        Path(argv[2]).write_text("\n".join(lines) + "\n")
    want = tmp_path / "jax.csv"
    assert jax_main([*argv, "--model-paths", str(converted(ckpt)), "-o", str(want)]) == 0
    for model in (data_dir / MODELS / ckpt, converted(ckpt)):
        got = tmp_path / "port.csv"
        assert port_main([*argv, "--model-paths", str(model), "-o", str(got),
                          "--device", "cpu"]) == 0
        assert assert_csvs_match(got, want, rtol=1e-5, atol=1e-6) > 0


def test_atom_mapped_corpus_matches_the_references_predictions(data_dir, tmp_path):
    """All 500 molecules of the atom-mapped corpus against the reference
    chemprop's own predictions, at the JAX package's limits."""
    mab = data_dir / "mol_atom_bond"
    out = tmp_path / "preds.csv"
    assert port_main(["predict", "-i", str(mab / "atomic_regression_atom_mapped.csv"),
                      "--keep-h", "--reorder-atoms", "--model-paths",
                      str(data_dir / MODELS / "atomic_regression_atom_mapped.pt"), "-o",
                      str(out), "--device", "cpu"]) == 0
    got, want = _rows(out), _rows(mab / "atomic_regression_atom_mapped_preds.csv")
    assert len(got) == len(want) == 500
    matched = 0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_values(g["charges"]), _values(w["charges"]), rtol=1e-3,
                                   atol=3e-4, err_msg=f"molecule {i}")
        matched += 1
    assert matched == 500


def test_extras_checkpoint_matches_its_golden(data_dir, tmp_path):
    """The checkpoint with molecule, atom and bond descriptors and extra atom
    and bond features against ``extras_preds_golden.csv``."""
    out = tmp_path / "preds.csv"
    ckpt = "regression_with_extras.pt"
    assert port_main(["predict", *_mab_argv(data_dir, ckpt), "--model-paths",
                      str(data_dir / MODELS / ckpt), "-o", str(out), "--device", "cpu"]) == 0
    assert assert_csvs_match(out, data_dir / "mol_atom_bond/extras_preds_golden.csv",
                             rtol=2e-4, atol=2e-4) == 11


# the uncertainty runs: checkpoints and flags (an ensemble of two files of the
# same heads' shapes; a head with its own uncertainty). Monte-Carlo dropout
# draws each package's own masks, so only its columns and shapes are held
UNCERTAINTY = {
    "ensemble": (["regression.pt", "classification.pt"], ["--uncertainty-method", "ensemble"]),
    "mve": (["regression_mve.pt"], ["--uncertainty-method", "mve"]),
    "classification": (["classification.pt"], ["--uncertainty-method", "classification"]),
}


@pytest.mark.parametrize("case", sorted(UNCERTAINTY))
def test_predict_uncertainty_matches_jax(data_dir, tmp_path, converted, case):
    names, flags = UNCERTAINTY[case]
    argv = ["predict", "-i", str(data_dir / "mol_atom_bond/regression.csv"), "--keep-h", *flags]
    want = tmp_path / "jax.csv"
    assert jax_main([*argv, "--model-paths", *(str(converted(n)) for n in names), "-o",
                     str(want)]) == 0
    got = tmp_path / "port.csv"
    assert port_main([*argv, "--model-paths", *(str(data_dir / MODELS / n) for n in names),
                      "-o", str(got), "--device", "cpu"]) == 0
    assert any(c.endswith("_unc") for c in _rows(got)[0])
    assert_csvs_match(got, want, rtol=1e-5, atol=1e-6)


def test_predict_mc_dropout_columns_match_jax(data_dir, tmp_path, converted):
    argv = ["predict", "-i", str(data_dir / "mol_atom_bond/regression.csv"), "--keep-h",
            "--uncertainty-method", "dropout", "--dropout-sampling-size", "3"]
    want = tmp_path / "jax.csv"
    assert jax_main([*argv, "--model-paths", str(converted("regression.pt")), "-o",
                     str(want)]) == 0
    got = tmp_path / "port.csv"
    assert port_main([*argv, "--model-paths", str(data_dir / MODELS / "regression.pt"), "-o",
                      str(got), "--device", "cpu"]) == 0
    g, w = _rows(got), _rows(want)
    assert list(g[0]) == list(w[0]) and len(g) == len(w)
    for rg, rw in zip(g, w):
        for col in rw:
            if col != "smiles":
                assert _values(rg[col]).shape == _values(rw[col]).shape
    # the variances are not zero: dropout was drawn
    assert any(float(r["mol_y1_unc"]) > 0 for r in g)


# train: the CSV, its flags and the target columns of each run
TARGETS = ["--mol-target-columns", "mol_y1", "mol_y2", "--atom-target-columns", "atom_y1",
           "atom_y2", "--bond-target-columns", "bond_y1", "bond_y2"]
TRAINS = {
    "regression": ("regression.csv", ["--weight-column", "weight", *TARGETS]),
    "bounded": ("bounded.csv", ["--loss-function", "bounded-mse", *TARGETS]),
    "classification": ("classification.csv", ["-t", "classification", *TARGETS]),
    "multiclass": ("multiclass.csv", ["-t", "multiclass", *TARGETS]),
    "constrained": ("constrained_regression.csv", [
        "--mol-target-columns", "mol_y", "--atom-target-columns", "atom_y1", "atom_y2",
        "--bond-target-columns", "bond_y1", "bond_y2", "--constraints-path",
        "{mab}/constrained_regression_constraints.csv", "--tracking-metric", "rmse-atom"]),
}


def train_both(tmp_path: Path, monkeypatch, argv: list[str]) -> tuple[Path, Path]:
    """One epoch of ``train`` of each command line from the same initial
    parameters (the port's model for ``argv``, seeded, set into both
    trainers as they start): the two output directories."""
    args = construct_parser().parse_args(["train", *argv, "--device", "cpu"])
    args.data_paths, args.data_path = args.data_path, args.data_path[0]
    process_train_args(args)
    ds = MolAtomBondDataset(tmab.build_MAB_datapoints(args)[0])
    model = tmab.build_MAB_model(args, ds, [None] * 3)
    init_parameters(model, "lecun", torch.Generator().manual_seed(11))
    warm = serialize.to_jax_params(dict(model.named_parameters()))["params"]
    jax_init, port_init = JaxMABTrainer.init_state, MABTrainer.init_state

    def jax_warm(self, batch, steps_per_epoch):
        state = jax_init(self, batch, steps_per_epoch)
        params = jax.tree_util.tree_map(jnp.asarray, warm)
        return state.replace(params=params, opt_state=self.tx.init(params))

    def port_warm(self, *a, **k):
        state = port_init(self, *a, **k)
        serialize.load_variables(self.model, {"params": warm})
        return state

    monkeypatch.setattr(JaxMABTrainer, "init_state", jax_warm)
    monkeypatch.setattr(MABTrainer, "init_state", port_warm)
    full = ["train", *argv, "--epochs", "1"]
    assert jax_main(full + ["-o", str(tmp_path / "jax")]) == 0
    assert port_main(full + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    return tmp_path / "jax", tmp_path / "port"


@pytest.mark.parametrize("case", sorted(TRAINS))
def test_train_matches_jax(data_dir, tmp_path, monkeypatch, case):
    """The same splits, each epoch's losses (and per-head validation losses
    and metrics) at rtol 1e-5, ``best.ckpt`` within twice the steps' rates
    and rtol 1e-4 / atol 1e-6 for all but one element in a thousand, the
    test predictions within 1e-4; JAX's ``load_model`` reads the port's
    ``best.ckpt``."""
    name, flags = TRAINS[case]
    mab = data_dir / "mol_atom_bond"
    argv = ["-i", str(mab / name), "--keep-h", "-b", "4", "--message-hidden-dim", "32",
            "--ffn-hidden-dim", "16", *(f.format(mab=mab) for f in flags)]
    jax_dir, port_dir = train_both(tmp_path, monkeypatch, argv)
    assert (json.loads((port_dir / "splits.json").read_text())
            == json.loads((jax_dir / "splits.json").read_text()))
    want = json.loads((jax_dir / "history.json").read_text())
    got = json.loads((port_dir / "history.json").read_text())
    keys = [k for k in want[0] if k.startswith(("train_loss", "val_"))]
    assert keys and set(keys) <= set(got[0])
    # a constrainer's output bias has no gradient (the softmax within each
    # molecule ignores a shift of its logits: rounding noise, whose sign
    # Adam's step takes in each package its own, as the attentive readout's
    # bias; ROADMAP.md section 3), and moves the constrained losses by up to
    # 3e-5 of themselves after one epoch; atol: a head's loss near zero (the
    # constrained set's molecule head validates at 1.3e-6) differs by
    # summation noise of 1e-11
    rtol = 1e-4 if case == "constrained" else 1e-5
    for key in keys:
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want], rtol=rtol,
                                   atol=1e-9, err_msg=key)
    w = _flat(serialize.read_checkpoint(jax_dir / "best.ckpt")[1]["params"])
    g = _flat(serialize.read_checkpoint(port_dir / "best.ckpt")[1]["params"])
    assert set(g) == set(w)
    n_bad = n_all = 0
    for key in w:
        err = np.abs(g[key] - w[key])
        assert err.max() <= 2 * CLI_STEPS_LRS, key
        if not key.endswith("constrainer/ffn/block1/bias"):  # no gradient, as above
            n_bad += int((err > 1e-6 + 1e-4 * np.abs(w[key])).sum())
            n_all += err.size
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)
    assert_csvs_match(port_dir / "test_predictions.csv", jax_dir / "test_predictions.csv",
                      rtol=0, atol=1e-4)
    jmodel, _, extra = jserialize.load_model(port_dir / "best.ckpt")
    assert type(jmodel).__name__ == "MolAtomBondMPNN"
    assert (case == "constrained") == (jmodel.atom_constrainer is not None)
    assert extra["output_columns"][-2:] == ["bond_y1", "bond_y2"]


def test_fingerprint_matches_jax(data_dir, tmp_path, converted):
    """The ``.npz`` of each kind of fingerprint, of two models (one file
    each)."""
    names = ["regression.pt", "regression_no_mol.pt"]
    argv = ["fingerprint", "-i", str(data_dir / "mol_atom_bond/regression.csv"), "--keep-h"]
    assert jax_main([*argv, "--model-paths", *(str(converted(n)) for n in names), "-o",
                     str(tmp_path / "jax.npz")]) == 0
    assert port_main([*argv, "--model-paths", *(str(data_dir / MODELS / n) for n in names),
                      "-o", str(tmp_path / "port.npz"), "--device", "cpu"]) == 0
    for k, kinds in enumerate((("mol", "atom", "bond"), ("atom", "bond"))):
        with np.load(tmp_path / f"jax_model_{k}.npz") as f:
            want = {key: f[key] for key in f.files}
        with np.load(tmp_path / f"port_model_{k}.npz") as f:
            got = {key: f[key] for key in f.files}
        assert sorted(got) == sorted(want) == sorted(kinds)
        for key in want:
            assert got[key].shape == want[key].shape, key
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)
