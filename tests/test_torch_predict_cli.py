"""The port's ``predict`` against the JAX package's CLI on the CPU (float32):
ensembles, every uncertainty method on its head, every calibration method
with ``--cal-path``, every evaluation method's printed JSON, the extra
inputs of a descriptor model, Monte-Carlo dropout with JAX's masks carried
across, and every refusal.

Each case runs both CLIs on 20 rows (tests/data/regression/mol/mol.csv or
the matching classification file) and compares the CSVs: header and names
equal; point, probability and ``_unc`` columns within rtol 1e-5 / atol
1e-5; class labels and conformal sets equal. The JAX CLI reads
``CPTPU001`` files only, so it takes the JAX package's ``convert`` of each
reference checkpoint, where the port takes the checkpoint itself."""

from __future__ import annotations

import csv
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu_torch.cli import parsing
from chemprop_tpu_torch.cli.common import find_models
from chemprop_tpu_torch.cli.main import main as port_main
from chemprop_tpu_torch.models import load_model, serialize
from test_torch_per_iteration import _Masks

CKPTS = {
    "reg": "example_model_v2_regression_mol.pt",
    "reg_ckpt": "example_model_v2_regression_mol.ckpt",
    "mve": "example_model_v2_regression_mve_mol.pt",
    "evidential": "example_model_v2_regression_evidential_mol.pt",
    "quantile": "example_model_v2_regression_quantile_mol.pt",
    "binary": "example_model_v2_classification_mol.pt",
    "binary_dirichlet": "example_model_v2_classification_dirichlet_mol.pt",
    "multiclass": "example_model_v2_classification_mol_multiclass.pt",
    "multiclass_dirichlet": "example_model_v2_multiclass_dirichlet_mol.pt",
}
DATA = {"reg": "regression/mol/mol.csv", "cls": "classification/mol.csv",
        "mc": "classification/mol_multiclass.csv"}
N_ROWS = 20


def _write_rows(path, header, rows):
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows([header] + rows)
    return path


@pytest.fixture(scope="module")
def env(data_dir, tmp_path_factory):
    """The inputs (20 rows, and a calibration set of 40 others), each
    checkpoint converted by the JAX package, and a training-output directory
    whose ``best.ckpt`` is the regression checkpoint with seeded noise on its
    parameters (``find_models`` must pass over ``last.ckpt`` and the copy
    under ``checkpoints/``), and its unscaling's mean 0.3 higher. The shift
    keeps the two members apart on every row, as independently trained
    members are: a variance of two members carries their float32 rounding
    (about 1e-6 between the packages) over their difference, which the
    calibrators and evaluators then scale by the errors over the spread (a
    row where the members agree to 0.01 puts 1e-4 of relative noise into
    ``zelikman-interval``'s ``_unc``, in either package)."""
    root = tmp_path_factory.mktemp("predict_cli")
    inputs = {}
    for kind, rel in DATA.items():
        with open(data_dir / rel, newline="") as f:
            header, *rows = list(csv.reader(f))
        inputs[kind] = _write_rows(root / f"{kind}.csv", header, rows[:N_ROWS])
        inputs[kind + "_cal"] = _write_rows(root / f"{kind}_cal.csv", header,
                                            rows[N_ROWS::3][:40])
    jax_ckpts = {}
    for key, name in CKPTS.items():
        jax_ckpts[key] = root / f"{key}.jax.ckpt"
        assert jax_main(["convert", "-i", str(data_dir / name), "-o", str(jax_ckpts[key])]) in (
            0, None)
    member = root / "member"
    model, cols = load_model(data_dir / CKPTS["reg"], "cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
        model.predictor.output_transform.mean += 0.3
    serialize.save_model(member / "best.ckpt", model, cols)
    (member / "checkpoints").mkdir()
    shutil.copy(member / "best.ckpt", member / "checkpoints/best.ckpt")
    shutil.copy(member / "best.ckpt", member / "last.ckpt")
    return dict(root=root, inputs=inputs, jax=jax_ckpts, member=member, data_dir=data_dir)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the port's float32 sums then do not depend on the
    machine's cores, so that the Nelder-Mead fits of ``zscaling`` and
    ``platt``, which inputs 1e-7 apart can end elsewhere within their
    tolerance (1e-4), see the same inputs in every run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _evaluations(out: str) -> dict | None:
    lines = [ln for ln in out.splitlines() if ln.startswith('{"uncertainty_evaluations"')]
    return json.loads(lines[-1])["uncertainty_evaluations"] if lines else None


def _run_both(env, capsys, models, data, flags, tag):
    """Both CLIs on the same input: ``(port header, rows, evaluations)`` and
    JAX's. ``models`` are keys of ``CKPTS`` or ``"member"``."""
    port_paths = [env["member"] if m == "member" else env["data_dir"] / CKPTS[m] for m in models]
    jax_paths = [env["member"] if m == "member" else env["jax"][m] for m in models]
    # a calibration set is named by its key in env["inputs"]
    flags = [str(env["inputs"][f]) if i and flags[i - 1] == "--cal-path" else f
             for i, f in enumerate(flags)]
    common = ["-i", str(env["inputs"][data]), *flags]
    out = {}
    for who, main, paths, extra in (("port", port_main, port_paths, ["--device", "cpu"]),
                                    ("jax", jax_main, jax_paths, [])):
        path = env["root"] / f"{tag}.{who}.csv"
        assert main(["predict", "--model-paths", *map(str, paths), *common, "-o", str(path),
                     *extra]) in (0, None)
        out[who] = (*_read(path), _evaluations(capsys.readouterr().out))
    return out["port"], out["jax"]


def _cells(value: str) -> list[float]:
    return [float(x) for x in value.split(",")]


def assert_same_csv(port, jax_):
    (ph, prows, _), (jh, jrows, _) = port, jax_
    assert ph == jh
    assert [r[0] for r in prows] == [r[0] for r in jrows] and len(prows) == N_ROWS
    for j, col in enumerate(ph[1:], start=1):
        got = [r[j] for r in prows]
        want = [r[j] for r in jrows]
        if col.endswith("_unc") and any("," in w for w in want) and all(
                set(w) <= set("01,") for w in want):
            assert got == want, col  # conformal sets
        elif any("," in w for w in want) or col.endswith("_unc") or col.endswith("_prob"):
            np.testing.assert_allclose([_cells(g) for g in got], [_cells(w) for w in want],
                                       rtol=1e-5, atol=1e-5, err_msg=col)
        elif f"{col}_prob" in ph:
            assert got == want, col  # class labels
        else:
            np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want],
                                       rtol=1e-5, atol=1e-5, err_msg=col)


REGRESSION_EVALS = ["nll-regression", "miscalibration_area", "ence", "spearman",
                    "conformal-coverage-regression"]
# name: (models, input, flags)
CASES = {
    "ensemble_pt_ckpt": (["reg", "reg_ckpt"], "reg", ["--uncertainty-method", "ensemble"]),
    "ensemble_directory": (["reg", "member"], "reg",
                           ["--uncertainty-method", "ensemble", "--evaluation-methods",
                            *REGRESSION_EVALS]),
    "mve": (["mve"], "reg", ["--uncertainty-method", "mve", "--evaluation-methods",
                             *REGRESSION_EVALS]),
    "evidential_total": (["evidential"], "reg", ["--uncertainty-method", "evidential-total"]),
    "evidential_epistemic": (["evidential"], "reg",
                             ["--uncertainty-method", "evidential-epistemic"]),
    "evidential_aleatoric": (["evidential"], "reg",
                             ["--uncertainty-method", "evidential-aleatoric"]),
    "quantile": (["quantile"], "reg", ["--uncertainty-method", "quantile-regression"]),
    "binary": (["binary"], "cls", ["--uncertainty-method", "classification",
                                   "--evaluation-methods", "nll-classification"]),
    "binary_dirichlet": (["binary_dirichlet"], "cls",
                         ["--uncertainty-method", "classification-dirichlet"]),
    "multiclass": (["multiclass"], "mc", ["--uncertainty-method", "classification",
                                          "--evaluation-methods", "nll-multiclass"]),
    "multiclass_dirichlet": (["multiclass_dirichlet"], "mc",
                             ["--uncertainty-method", "multiclass-dirichlet"]),
    # each calibration method on the head it takes
    "zscaling": (["mve"], "reg", ["--uncertainty-method", "mve", "--calibration-method",
                                  "zscaling", "--cal-path", "reg_cal", "--evaluation-methods",
                                  "nll-regression"]),
    "zelikman_interval": (["reg", "member"], "reg",
                          ["--uncertainty-method", "ensemble", "--calibration-method",
                           "zelikman-interval", "--cal-path", "reg_cal",
                           "--calibration-interval-percentile", "80"]),
    "conformal_regression": (["quantile"], "reg",
                             ["--uncertainty-method", "quantile-regression",
                              "--calibration-method", "conformal-regression", "--cal-path",
                              "reg_cal", "--conformal-alpha", "0.2", "--evaluation-methods",
                              "conformal-coverage-regression"]),
    "platt": (["binary"], "cls", ["--uncertainty-method", "classification",
                                  "--calibration-method", "platt", "--cal-path", "cls_cal"]),
    "isotonic": (["binary"], "cls", ["--uncertainty-method", "classification",
                                     "--calibration-method", "isotonic", "--cal-path", "cls_cal",
                                     "--evaluation-methods", "nll-classification"]),
    "conformal_multilabel": (["binary"], "cls",
                             ["--uncertainty-method", "classification", "--calibration-method",
                              "conformal-multilabel", "--cal-path", "cls_cal",
                              "--evaluation-methods", "conformal-coverage-classification"]),
    "conformal_multiclass": (["multiclass"], "mc",
                             ["--uncertainty-method", "classification", "--calibration-method",
                              "conformal-multiclass", "--cal-path", "mc_cal",
                              "--conformal-alpha", "0.3", "--evaluation-methods",
                              "conformal-coverage-multiclass"]),
    "conformal_adaptive": (["multiclass"], "mc",
                           ["--uncertainty-method", "classification", "--calibration-method",
                            "conformal-adaptive", "--cal-path", "mc_cal"]),
    "isotonic_multiclass": (["multiclass"], "mc",
                            ["--uncertainty-method", "classification", "--calibration-method",
                             "isotonic-multiclass", "--cal-path", "mc_cal",
                             "--evaluation-methods", "nll-multiclass"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_matches_the_jax_cli(env, capsys, case):
    models, data, flags = CASES[case]
    port, jax_ = _run_both(env, capsys, models, data, flags, case)
    assert_same_csv(port, jax_)
    unc_cols = [c for c in port[0] if c.endswith("_unc")]
    assert unc_cols and len(unc_cols) == len([c for c in port[0][1:]
                                              if not c.endswith(("_unc", "_prob"))])
    if "--evaluation-methods" in flags:
        got, want = port[2], jax_[2]
        assert got is not None and set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def test_ensemble_directory_is_an_ensemble(env, capsys):
    """The directory gives its best.ckpt alone, and the two members differ."""
    assert find_models([env["member"]]) == [env["member"] / "best.ckpt"]
    (_, rows, _), _ = _run_both(env, capsys, ["reg", "member"], "reg",
                                ["--uncertainty-method", "ensemble"], "ensemble_check")
    unc = np.array([float(r[2]) for r in rows])
    assert (unc > 0).all()


def test_mve_weighting_needs_the_members_variances(env):
    """``mve-weighting`` takes ``[m, n, t]`` variances, which neither CLI's
    estimators give: both raise."""
    argv = ["predict", "-i", str(env["inputs"]["reg"]), "--uncertainty-method", "mve",
            "--calibration-method", "mve-weighting", "--cal-path", str(env["inputs"]["reg_cal"])]
    with pytest.raises(ValueError):
        jax_main(argv + ["--model-paths", str(env["jax"]["mve"]),
                         "-o", str(env["root"] / "w.jax.csv")])
    with pytest.raises(ValueError):
        port_main(argv + ["--model-paths", str(env["data_dir"] / CKPTS["mve"]),
                          "-o", str(env["root"] / "w.port.csv"), "--device", "cpu"])


def test_find_models(tmp_path):
    (tmp_path / "a/checkpoints").mkdir(parents=True)
    (tmp_path / "b/sub").mkdir(parents=True)
    for p in ("a/best.ckpt", "a/last.ckpt", "a/checkpoints/best.ckpt", "b/x.pt",
              "b/sub/y.ckpt", "b/last.ckpt"):
        (tmp_path / p).touch()
    assert find_models([tmp_path / "a", tmp_path / "b", tmp_path / "z.pt"]) == [
        tmp_path / "a/best.ckpt", tmp_path / "b/sub/y.ckpt", tmp_path / "b/x.pt",
        tmp_path / "z.pt"]
    with pytest.raises(ValueError):
        find_models([tmp_path / "nothing.txt"])


# ------------------------------------------------------------ extra inputs
@pytest.fixture(scope="module")
def descriptor_model(data_dir, tmp_path_factory):
    """A model with every extra input the port's predict reads, trained by the
    port's ``train`` for one epoch at a small width on mol.csv."""
    root = tmp_path_factory.mktemp("descriptors")
    mol = data_dir / "regression/mol"
    assert port_main(["train", "-i", str(mol / "mol.csv"), "-o", str(root), "--epochs", "1",
                      "--message-hidden-dim", "32", "--ffn-hidden-dim", "16", "--device", "cpu",
                      "--descriptors-path", str(mol / "descriptors.npz"),
                      "--atom-features-path", str(mol / "atom_features.npz"),
                      "--bond-features-path", str(mol / "bond_features.npz"),
                      "--atom-descriptors-path", str(mol / "atom_descriptors.npz")]) == 0
    return root / "best.ckpt"


def test_extra_inputs_match_the_jax_cli(descriptor_model, data_dir, tmp_path, capsys):
    mol = data_dir / "regression/mol"
    flags = ["-i", str(mol / "mol.csv"), "--model-paths", str(descriptor_model),
             "--descriptors-path", str(mol / "descriptors.npz"),
             "--atom-features-path", str(mol / "atom_features.npz"),
             "--bond-features-path", str(mol / "bond_features.npz"),
             "--atom-descriptors-path", str(mol / "atom_descriptors.npz")]
    assert port_main(["predict", *flags, "-o", str(tmp_path / "p.csv"), "--device", "cpu"]) == 0
    assert jax_main(["predict", *flags, "-o", str(tmp_path / "j.csv")]) in (0, None)
    (ph, prows), (jh, jrows) = _read(tmp_path / "p.csv"), _read(tmp_path / "j.csv")
    assert ph == jh == ["name", "lipo"] and len(prows) == 100
    assert [r[0] for r in prows] == [r[0] for r in jrows]
    np.testing.assert_allclose([float(r[1]) for r in prows], [float(r[1]) for r in jrows],
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):  # without its descriptors the model cannot run
        port_main(["predict", "-i", str(mol / "mol.csv"), "--model-paths", str(descriptor_model),
                   "-o", str(tmp_path / "q.csv"), "--device", "cpu"])


# ---------------------------------------------------------- MC dropout
def test_mc_dropout_matches_jax_with_its_masks(env, monkeypatch, capsys):
    """``--uncertainty-method dropout`` (rate 0.1 on every dropout layer, 3
    samples): the JAX CLI eagerly with its masks recorded, then the port's
    with the same masks handed out in the same order; the means and
    variances agree."""
    flags = ["--uncertainty-method", "dropout", "--dropout-sampling-size", "3"]
    masks = _Masks(monkeypatch)
    jpath, ppath = env["root"] / "mc.jax.csv", env["root"] / "mc.port.csv"
    with jax.disable_jit():
        assert jax_main(["predict", "-i", str(env["inputs"]["reg"]), "--model-paths",
                         str(env["jax"]["reg"]), "-o", str(jpath), *flags]) in (0, None)
    n_masks = len(masks.masks)
    assert n_masks == 3 * 4  # each sample: two iterations, the node table, the FFN
    assert port_main(["predict", "-i", str(env["inputs"]["reg"]), "--model-paths",
                      str(env["data_dir"] / CKPTS["reg"]), "-o", str(ppath), "--device", "cpu",
                      *flags]) == 0
    assert not masks.masks
    (ph, prows), (jh, jrows) = _read(ppath), _read(jpath)
    assert ph == jh == ["name", "pred_0", "pred_0_unc"]
    got = np.array([[float(x) for x in r[1:]] for r in prows])
    want = np.array([[float(x) for x in r[1:]] for r in jrows])
    assert (want[:, 1] > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _port_dropout(env, out, *flags):
    assert port_main(["predict", "-i", str(env["inputs"]["reg"]), "--model-paths",
                      str(env["data_dir"] / CKPTS["reg"]), "-o", str(out), "--device", "cpu",
                      *flags]) == 0
    return _read(out)


def test_mc_dropout_rate_zero_is_plain_predict(env):
    _, plain = _port_dropout(env, env["root"] / "plain.csv")
    header, mc = _port_dropout(env, env["root"] / "p0.csv", "--uncertainty-method", "dropout",
                               "--uncertainty-dropout-p", "0", "--dropout-sampling-size", "2")
    assert header == ["name", "pred_0", "pred_0_unc"]
    assert [r[:2] for r in mc] == plain and all(float(r[2]) == 0.0 for r in mc)


def test_mc_dropout_is_reproducible(env):
    flags = ["--uncertainty-method", "dropout", "--dropout-sampling-size", "4"]
    a = _port_dropout(env, env["root"] / "r1.csv", *flags)
    b = _port_dropout(env, env["root"] / "r2.csv", *flags)
    assert a == b and any(float(r[2]) > 0 for r in a[1])


# ------------------------------------------------------------ refusals
# constraints and bond descriptors are read since mol-atom-bond models were
# ported (tests/test_torch_mab_cli.py), --callback since interpretation was
# (tests/test_torch_interpret_cli.py), --use-cuikmolmaker-featurization since
# the native featurizer was (tests/test_torch_native.py), --edge-partition
# and --devices since multi-GPU inference was (tests/test_torch_parallel_cli.py):
# their cases now hold what stays refused, edge partition with Monte-Carlo
# dropout (as in the JAX CLI) and a device count below one. Each case:
# (flags, the message's pattern)
REFUSALS = {
    "edge_partition": (["--edge-partition", "--uncertainty-method", "dropout"],
                       "--edge-partition predict does not support --uncertainty-method dropout"),
    "devices": (["--devices", "0"], "--devices takes 'auto' or a number"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_unported_options_are_refused(env, case):
    flags, pattern = REFUSALS[case]
    out = env["root"] / f"refused_{case}.csv"
    with pytest.raises(ValueError, match=pattern):
        port_main(["predict", "-i", str(env["inputs"]["reg"]), "--model-paths",
                   str(env["data_dir"] / CKPTS["reg"]), "-o", str(out), "--device", "cpu",
                   *flags])
    assert not out.exists()


# mol-atom-bond checkpoints are served since they were ported, and a v1 file
# of several molecules since item 7's last part was: the case builds the
# two-molecule file from the v1 file named (chip_smoke.two_molecule_v1) and
# predicts on mol+mol.csv with it, its featurizer mode found by predict, as
# the library predicts (tests/test_torch_v1_multi.py holds both against JAX)
@pytest.mark.parametrize("path,item", [("example_model_v1_regression_mol.pt", "item 7")])
def test_unported_models_are_refused(env, path, item, capsys):
    from chip_smoke import two_molecule_v1
    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.train import Trainer

    assert path == "example_model_v1_regression_mol.pt" and item == "item 7"
    src = two_molecule_v1(env["root"] / "two_molecules.pt")
    with open(env["data_dir"] / "regression/mol+mol/mol+mol.csv", newline="") as f:
        header, *rows = list(csv.reader(f))
    in_csv = _write_rows(env["root"] / "mol_mol.csv", header, rows[:N_ROWS])
    out = env["root"] / "m.csv"
    assert port_main(["predict", "-i", str(in_csv), "-s", "smiles", "solvent",
                      "--model-paths", str(src), "-o", str(out), "--device", "cpu"]) == 0
    assert "switching atom featurizer mode 'v2' -> 'v1'" in capsys.readouterr().err
    got = list(csv.reader(open(out, newline="")))
    assert got[0] == ["name", "logSolubility"]
    assert [r[0] for r in got[1:]] == [str((r[0], r[1])) for r in rows[:N_ROWS]]
    model, _ = load_model(src, "cpu")
    smis, rxns, Y, w, lt, gt = parsing.parse_csv(in_csv, ["smiles", "solvent"], None, [])[:6]
    ds = parsing.build_datasets(parsing.make_datapoints(smis, rxns, np.full((N_ROWS, 1), np.nan),
                                                        w, lt, gt),
                                multi_hot_atom_featurizer_mode="v1")
    trainer = Trainer(model, device="cpu")
    trainer.init_state(keep_parameters=True)
    want = trainer.predict(DataLoader(ds, batch_size=64))
    np.testing.assert_allclose([[float(r[1])] for r in got[1:]], want, rtol=0, atol=1e-6)


# the inputs and model the port refused before it took reactions, several
# SMILES columns and molecule featurizers: (reference checkpoint, CSV and its
# first rows' count, flags)
LIFTED = {
    "reactions": ("example_model_v2_regression_rxn.pt", "regression/rxn/rxn.csv",
                  ["--reaction-columns", "smiles"]),
    "two_smiles_columns": ("example_model_v2_regression_mol+mol.pt",
                           "regression/mol+mol/mol+mol.csv", ["-s", "smiles", "solvent"]),
    "molecule_featurizers": ("example_model_v2_regression_mol.pt", "regression/mol/mol.csv",
                             ["--molecule-featurizers", "morgan_binary"]),
    "rxn+mol_model": ("example_model_v2_regression_rxn+mol.pt", "regression/rxn+mol/rxn+mol.csv",
                      ["--reaction-columns", "rxn_smiles", "-s", "solvent_smiles"]),
}


@pytest.mark.parametrize("case", sorted(LIFTED))
def test_formerly_refused_inputs_match_the_jax_cli(env, capsys, case):
    """Each input that ``test_unported_options_are_refused`` and
    ``test_unported_models_are_refused`` refused before (reactions, two
    SMILES columns, a molecule featurizer, the rxn+mol checkpoint) served by
    both command lines: the same CSV. The molecule featurizer's 2048 bits
    reach a model that reads no ``X_d`` only in the manifest's check, so its
    case serves a model trained with them: the port's ``train`` output."""
    ckpt, rel, flags = LIFTED[case]
    root = env["root"] / f"lifted_{case}"
    root.mkdir()
    with open(env["data_dir"] / rel, newline="") as f:
        header, *rows = list(csv.reader(f))
    data = _write_rows(root / "in.csv", header, rows[:N_ROWS])
    model = env["data_dir"] / ckpt
    if case == "molecule_featurizers":
        assert port_main(["train", "-i", str(data), "-o", str(root / "trained"), "--epochs",
                          "1", "--message-hidden-dim", "16", "--ffn-hidden-dim", "16",
                          "--device", "cpu", *flags]) == 0
        model = jax_model = root / "trained" / "best.ckpt"
    else:
        jax_model = root / "model.ckpt"
        assert jax_main(["convert", "-i", str(model), "-o", str(jax_model)]) in (0, None)
    out = {}
    for who, main, path, extra in (("port", port_main, model, ["--device", "cpu"]),
                                   ("jax", jax_main, jax_model, [])):
        assert main(["predict", "--model-paths", str(path), "-i", str(data), *flags,
                     "-o", str(root / f"{who}.csv"), *extra]) in (0, None)
        out[who] = (*_read(root / f"{who}.csv"), None)
    assert_same_csv(out["port"], out["jax"])


def test_pkl_output_is_refused(env):
    """A divergence by design: the JAX CLI writes a ``.pkl`` with pandas, which
    the port does not use."""
    out = env["root"] / "out.pkl"
    with pytest.raises(ValueError, match="pandas"):
        port_main(["predict", "-i", str(env["inputs"]["reg"]), "--model-paths",
                   str(env["data_dir"] / CKPTS["reg"]), "-o", str(out), "--device", "cpu"])
    assert not out.exists()
