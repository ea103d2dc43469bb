"""The port's ``train`` command against the JAX package's on the CPU: one
run of each, in float32 at full width, warm-started from one ``CPTPU001``
file, then the port's own options at a small width, and every refusal."""

from __future__ import annotations

import csv
import json

import numpy as np
import pytest
import torch

from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu.models.serialize import load_model as jax_load_model
from chemprop_tpu.train.schedulers import noam_lr_host
from chemprop_tpu_torch.cli.main import construct_parser, main
from chemprop_tpu_torch.cli.parsing import build_datasets, make_datapoints, parse_csv
from chemprop_tpu_torch.cli.train import build_model
from chemprop_tpu_torch.models import serialize
from chemprop_tpu_torch.nn.init import init_parameters
from chemprop_tpu_torch.ops import UNSERVED
from chemprop_tpu_torch.utils import msgpack_codec

# both runs: 2 epochs of 2 steps (80 training rows in batches of 64)
COMMON = ["--epochs", "2", "--batch-norm", "--split", "scaffold_balanced", "--data-seed", "2",
          "--seed", "5"]
STEPS_LRS = sum(noam_lr_host(k, 4, 1, 1e-4, 1e-3, 1e-4) for k in range(4))


def _warm_start(path, mol_csv) -> None:
    """A CPTPU001 file of the default model with batch norm, its parameters
    made from a seed."""
    args = construct_parser().parse_args(["train", "-i", str(mol_csv), "--batch-norm",
                                          "--device", "cpu"])
    ds = build_datasets(make_datapoints(*parse_csv(mol_csv, None, None, None)[:6]))
    model = build_model(args, ds)
    init_parameters(model, "lecun", torch.Generator().manual_seed(11))
    serialize.save_model(path, model)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, data_dir):
    root = tmp_path_factory.mktemp("cli_train")
    mol_csv = data_dir / "regression/mol/mol.csv"
    warm = root / "warm.ckpt"
    _warm_start(warm, mol_csv)
    argv = ["train", "-i", str(mol_csv), "--checkpoint", str(warm), *COMMON]
    assert jax_main(argv + ["-o", str(root / "jax")]) == 0
    assert main(argv + ["-o", str(root / "port"), "--device", "cpu"]) == 0
    return root / "jax", root / "port"


def _json(path):
    return json.loads(path.read_text())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree, dtype=np.float64)}


def _variables(path):
    _, variables = serialize.read_checkpoint(path)
    return _flat({k: variables[k] for k in ("params", "batch_stats")})


def _preds(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [r[0] for r in rows[1:]], np.array([[float(x) for x in r[1:]]
                                                        for r in rows[1:]])


def test_splits_equal_jax(runs):
    jax_dir, port_dir = runs
    assert _json(port_dir / "splits.json") == _json(jax_dir / "splits.json")


def test_history_matches_jax(runs):
    jax_dir, port_dir = runs
    want, got = _json(jax_dir / "history.json"), _json(port_dir / "history.json")
    assert [set(r) for r in got] == [set(r) for r in want]
    for key in ("train_loss", "val_loss", "lr"):
        # test_three_adam_steps_match_jax_f32's limit on losses
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in want], rtol=1e-5,
                                   err_msg=key)


def test_best_checkpoint_matches_jax(runs):
    """test_three_adam_steps_match_jax_f32's limits over the run's four steps:
    no element further than twice their learning rates, rtol 1e-4 / atol
    1e-6 for all but one in a thousand."""
    jax_dir, port_dir = runs
    want, got = _variables(jax_dir / "best.ckpt"), _variables(port_dir / "best.ckpt")
    assert set(got) == set(want)
    n_bad = n_all = 0
    for name in want:
        err = np.abs(got[name] - want[name])
        assert err.max() <= 2 * STEPS_LRS, name
        n_bad += int((err > 1e-6 + 1e-4 * np.abs(want[name])).sum())
        n_all += err.size
    assert n_bad <= 1e-3 * n_all, (n_bad, n_all)


def test_test_predictions_match_jax(runs):
    jax_dir, port_dir = runs
    jh, jn, jp = _preds(jax_dir / "test_predictions.csv")
    th, tn, tp = _preds(port_dir / "test_predictions.csv")
    assert (th, tn) == (jh, jn) and th == ["name", "pred_lipo"]
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    want, got = _json(jax_dir / "test_scores.json"), _json(port_dir / "test_scores.json")
    assert set(got[0]) == set(want[0]) == {"rmse", "mae"}
    np.testing.assert_allclose([got[0][k] for k in want[0]], [want[0][k] for k in want[0]],
                               atol=1e-4)


def test_config_has_jax_keys_and_the_device(runs):
    jax_dir, port_dir = runs
    want, got = _json(jax_dir / "config.json"), _json(port_dir / "config.json")
    assert set(got) == set(want) | {"device", "dtype"}
    assert got["device"] == "cpu" and got["dtype"] == "float32"


def test_jax_loads_the_ports_best_checkpoint(runs):
    jax_dir, port_dir = runs
    model, variables, extra = jax_load_model(port_dir / "best.ckpt")
    assert extra["output_columns"] == ["lipo"]
    assert model.batch_norm and set(variables) == {"params", "batch_stats"}
    # and every artefact of a run is there
    for name in ("best.ckpt", "history.json", "test_predictions.csv",
                 "checkpoints/best.ckpt", "checkpoints/last.ckpt"):
        assert (port_dir / name).is_file(), name


# ------------------------------------------- chip_smoke.py phase 9's checks
def test_first_epoch_check_counts_the_parted_elements(tmp_path, data_dir, monkeypatch):
    """``chip_smoke.first_epoch_params`` finds the tensor whose elements part,
    counts exactly those beyond the dtype's limit, and fails past its share."""
    monkeypatch.syspath_prepend(str(data_dir.parent.parent))
    import chip_smoke

    args = construct_parser().parse_args(["train", "-i", str(data_dir / "regression/mol/mol.csv"),
                                          "--batch-norm", "--device", "cpu"] + SMALL)
    ds = build_datasets(make_datapoints(*parse_csv(data_dir / "regression/mol/mol.csv", None,
                                                   None, None)[:6]))
    model = build_model(args, ds)
    init_parameters(model, "lecun", torch.Generator().manual_seed(3))
    serialize.save_model(tmp_path / "a.ckpt", model)
    tau = chip_smoke.CLI_PARAM_TAU
    with torch.no_grad():
        W = model.message_passing.W_h.weight.view(-1)
        W[:7] += 2 * tau  # beyond the limit
        W[7:20] += tau / 2  # within it
    serialize.save_model(tmp_path / "b.ckpt", model)
    got = chip_smoke.first_epoch_params(tmp_path / "b.ckpt", tmp_path / "a.ckpt")
    assert got["worst"] == "message_passing/W_h/kernel"
    assert got["worst_share"] == 7 / W.numel()
    assert sum(got["shares"].values()) == got["worst_share"]
    assert got["max_diff"] == pytest.approx(2 * tau, rel=1e-3)
    drift = chip_smoke.param_drift(tmp_path / "b.ckpt", tmp_path / "a.ckpt",
                                   {"quarter": tau / 4})
    assert drift["message_passing/W_h/kernel"]["quarter"] == 20


def test_unserved_since_reads_without_clearing(monkeypatch, data_dir):
    """A phase reads its own unserved calls as a difference and leaves the
    counter whole for the final gate."""
    monkeypatch.syspath_prepend(str(data_dir.parent.parent))
    import chip_smoke

    saved = dict(UNSERVED)
    try:
        UNSERVED["message"] += 2
        before = dict(UNSERVED)
        assert chip_smoke.unserved_since(before) == {}
        UNSERVED["message"] += 3
        UNSERVED["bwd_message_nodes"] += 1
        assert chip_smoke.unserved_since(before) == {"message": 3, "bwd_message_nodes": 1}
        assert UNSERVED["message"] == saved.get("message", 0) + 5
    finally:
        UNSERVED.clear()
        UNSERVED.update(saved)


# ------------------------------------------------------------ the port alone
SMALL = ["--message-hidden-dim", "32", "--ffn-hidden-dim", "16", "--depth", "2",
         "--device", "cpu", "--epochs", "2"]


def _train(tmp_path, *extra, data="regression/mol/mol.csv", data_dir=None):
    out = tmp_path / "out"
    assert main(["train", "-i", *(str(data_dir / d) for d in np.atleast_1d(data)), "-o", str(out),
                 *SMALL, *extra]) == 0
    return out


def test_replicates_ensembles_and_options(tmp_path, data_dir):
    """Two replicates of two models, class-balanced BCE on Tox21's first 150
    rows with a tracked metric, TensorBoard events and a profile, and saved
    splits."""
    lines = (data_dir / "classification/mol.csv").read_text().splitlines()[:151]
    (tmp_path / "tox21.csv").write_text("\n".join(lines) + "\n")
    out = _train(tmp_path, "-t", "classification", "--class-balance", "--num-replicates", "2",
                 "--ensemble-size", "2", "--tracking-metric", "roc", "--metrics", "roc", "prc",
                 "--tensorboard", "--profile", "--save-smiles-splits", "--save-data-splits",
                 "--remove-checkpoints", "--epochs", "1", "--batch-size", "16",
                 data="tox21.csv", data_dir=tmp_path)
    splits = _json(out / "splits.json")
    assert len(splits) == 2 and splits[0] != splits[1]
    for rep in range(2):
        assert (out / f"replicate_{rep}/train_smiles.csv").is_file()
        header = (out / f"replicate_{rep}/test_full.csv").read_text().splitlines()[0]
        assert header == "smiles,NR-AhR,NR-ER,SR-ARE,SR-MMP"
        for m in range(2):
            d = out / f"replicate_{rep}/model_{m}"
            assert (d / "best.ckpt").is_file() and not (d / "checkpoints").exists()
            assert "val_roc" in _json(d / "history.json")[0]
            assert len(list((d / "tensorboard").glob("events.out.tfevents.*"))) == 1
            trace = json.loads((d / "profile/trace.json").read_text())
            assert trace["traceEvents"]
    scores = _json(out / "test_scores.json")
    assert len(scores) == 4 and all(set(s) == {"roc", "prc"} for s in scores)


def test_splits_column_and_file_and_three_inputs(tmp_path, data_dir):
    out = _train(tmp_path, "--splits-column", "split",
                 data="regression/mol/mol_with_splits.csv", data_dir=data_dir)
    with open(data_dir / "regression/mol/mol_with_splits.csv", newline="") as f:
        col = [r[2] for r in list(csv.reader(f))[1:]]
    split = _json(out / "splits.json")[0]
    assert split["train"] == [i for i, s in enumerate(col) if s == "train"]
    (tmp_path / "s.json").write_text(json.dumps(
        [{"train": list(range(60)), "val": list(range(60, 80)), "test": list(range(80, 100))}]))
    out2 = tmp_path / "file"
    assert main(["train", "-i", str(data_dir / "regression/mol/mol.csv"), "-o", str(out2),
                 "--splits-file", str(tmp_path / "s.json"), *SMALL]) == 0
    assert _json(out2 / "splits.json")[0]["test"] == list(range(80, 100))
    lines = (data_dir / "regression/mol/mol.csv").read_text().splitlines()
    parts = []
    for name, rows in (("a", lines[1:41]), ("b", lines[41:61]), ("c", lines[61:81])):
        parts.append(tmp_path / f"{name}.csv")
        parts[-1].write_text("\n".join([lines[0], *rows]) + "\n")
    out3 = tmp_path / "three"
    assert main(["train", "-i", *map(str, parts), "-o", str(out3), *SMALL]) == 0
    assert _json(out3 / "splits.json") == [
        {"train": list(range(40)), "val": list(range(40, 60)), "test": list(range(60, 80))}]
    with open(out3 / "test_predictions.csv", newline="") as f:
        assert [r[0] for r in list(csv.reader(f))[1:]] == [r.split(",")[0] for r in lines[61:81]]


def test_descriptors_freeze_and_resume(tmp_path, data_dir):
    """Extra inputs from the repo's .npz files, a frozen encoder warm-started
    from a run's best.ckpt, then a resumed run."""
    mol = data_dir / "regression/mol"
    first = _train(tmp_path, "--descriptors-path", str(mol / "descriptors.npz"),
                   "--atom-features-path", str(mol / "atom_features.npz"),
                   "--bond-features-path", str(mol / "bond_features.npz"),
                   "--atom-descriptors-path", str(mol / "atom_descriptors.npz"),
                   data="regression/mol/mol.csv", data_dir=data_dir)
    best = first / "best.ckpt"
    frozen = tmp_path / "frozen"
    assert main(["train", "-i", str(mol / "mol.csv"), "-o", str(frozen), *SMALL,
                 "--descriptors-path", str(mol / "descriptors.npz"),
                 "--atom-features-path", str(mol / "atom_features.npz"),
                 "--bond-features-path", str(mol / "bond_features.npz"),
                 "--atom-descriptors-path", str(mol / "atom_descriptors.npz"),
                 "--checkpoint", str(best), "--freeze-encoder"]) == 0
    a, b = _variables(best), _variables(frozen / "best.ckpt")
    assert all(np.array_equal(a[k], b[k]) for k in a if k.startswith("params/message_passing"))
    assert not all(np.array_equal(a[k], b[k]) for k in a if k.startswith("params/predictor"))
    resumed = tmp_path / "resumed"
    assert main(["train", "-i", str(mol / "mol.csv"), "-o", str(resumed), *SMALL, "--epochs", "3",
                 "--descriptors-path", str(mol / "descriptors.npz"),
                 "--atom-features-path", str(mol / "atom_features.npz"),
                 "--bond-features-path", str(mol / "bond_features.npz"),
                 "--atom-descriptors-path", str(mol / "atom_descriptors.npz"),
                 "--resume", str(first / "checkpoints/last.ckpt")]) == 0
    assert [r["epoch"] for r in _json(resumed / "history.json")] == [2]


def test_config_file_defaults(tmp_path, data_dir):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"epochs": 1, "message_hidden_dim": 16, "batch_norm": True,
                               "split_sizes": [0.7, 0.2, 0.1]}))
    out = tmp_path / "out"
    assert main(["train", "-i", str(data_dir / "regression/mol/mol.csv"), "-o", str(out),
                 "--device", "cpu", "--config-path", str(cfg), "--epochs", "2"]) == 0
    config = _json(out / "config.json")
    assert config["epochs"] == 2 and config["message_hidden_dim"] == 16
    assert config["batch_norm"] and config["split_sizes"] == [0.7, 0.2, 0.1]


def test_the_model_is_the_jax_packages(tmp_path, data_dir):
    """``best.ckpt``'s manifest names the JAX modules and the port's dtype."""
    out = _train(tmp_path, "--dtype", "bfloat16", "--aggregation", "mean", "--epochs", "1",
                 data_dir=data_dir)
    manifest, variables = serialize.read_checkpoint(out / "best.ckpt")
    assert manifest["model"]["message_passing"]["compute_dtype"] == "bfloat16"
    assert manifest["model"]["agg"]["cls"] == "MeanAggregation"
    assert manifest["extra"]["output_columns"] == ["lipo"]
    msgpack_codec.packb(variables)  # a tree the codec writes back


# atom and bond targets train since mol-atom-bond models were ported
# (tests/test_torch_mab_cli.py), --split kmeans and
# --use-cuikmolmaker-featurization since k-means and the native featurizer
# were (tests/test_torch_native.py, tests/test_torch_kmeans.py),
# --edge-partition and --devices since multi-GPU training was
# (tests/test_torch_parallel_cli.py): their cases now hold what stays
# refused, edge partition with batch norm (as in the JAX package) and a
# device count below one; a named foundation model raises the JAX CLI's
# FileNotFoundError (only a local path is taken). Each case: (flags, the
# exception, the message's pattern)
REFUSALS = {
    "edge_partition": (["--edge-partition", "--batch-norm"], ValueError,
                       "--edge-partition does not support --batch-norm"),
    "devices": (["--devices", "0"], ValueError, "--devices takes 'auto' or a number"),
    "foundation": (["--from-foundation", "chemeleon"], FileNotFoundError,
                   "expects a local checkpoint path.*got chemeleon"),
}


# the options train refused before it took reactions, several SMILES columns
# and molecule featurizers: the CSV (its first 40 rows) and the flags
LIFTED = {
    "reactions": ("regression/rxn/rxn.csv", ["--reaction-columns", "smiles"]),
    "two_smiles_columns": ("regression/mol+mol/mol+mol.csv", ["-s", "smiles", "solvent"]),
    "molecule_featurizers": ("regression/mol/mol.csv",
                             ["--molecule-featurizers", "morgan_binary", "charge"]),
}


@pytest.mark.parametrize("case", sorted(LIFTED))
def test_formerly_refused_options_match_jax(tmp_path, data_dir, case):
    """Each option ``test_unported_options_are_refused`` refused before, in one
    epoch of both command lines from one warm start: the same splits, losses
    at rtol 1e-5, ``best.ckpt`` within the two steps' limits, and the test
    predictions within 1e-4."""
    from test_torch_multicomponent import CLI_STEPS_LRS, _head, assert_runs_match, train_both

    rel, flags = LIFTED[case]
    csv_in = _head(data_dir / rel, tmp_path / "in.csv", 40)
    jax_dir, port_dir = train_both(tmp_path, ["-i", str(csv_in), *flags, "--batch-norm", "-b",
                                              "16", "--message-hidden-dim", "32",
                                              "--ffn-hidden-dim", "16"])
    assert_runs_match(jax_dir, port_dir, CLI_STEPS_LRS)


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_unported_options_are_refused(tmp_path, data_dir, case):
    flags, exc, pattern = REFUSALS[case]
    out = tmp_path / "out"
    with pytest.raises(exc, match=pattern):
        main(["train", "-i", str(data_dir / "regression/mol/mol.csv"), "-o", str(out), *SMALL,
              *flags])
    if case != "edge_partition":  # the model's scope is checked once the data is read
        assert not out.exists()


def test_trainer_writes_events_logs_and_a_trace(tmp_path, data_dir, monkeypatch, caplog):
    """``tensorboard_dir`` gets the JAX writer's bytes for the fit's records,
    ``log_every`` logs every other epoch, ``profile_dir`` a Chrome trace of
    the first epoch's steps after the first."""
    import logging

    from chemprop_tpu.utils import tbevents as jax_tbevents
    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.train import Trainer
    from chemprop_tpu_torch.utils import tbevents

    for module in (jax_tbevents, tbevents):
        monkeypatch.setattr(module.time, "time", lambda: 1700000000.5)
    args = construct_parser().parse_args(["train", "-i", "x.csv", "--message-hidden-dim", "16",
                                          "--ffn-hidden-dim", "8", "--device", "cpu"])
    ds = build_datasets(make_datapoints(*parse_csv(data_dir / "regression/mol/mol.csv", None,
                                                   None, None)[:6]))
    ds.normalize_targets()
    trainer = Trainer(build_model(args, ds), max_epochs=3, device="cpu", log_every=2,
                      tensorboard_dir=tmp_path / "tb", profile_dir=tmp_path / "prof",
                      profile_steps=2)
    with caplog.at_level(logging.INFO, logger="chemprop_tpu_torch.train.trainer"):
        trainer.fit(DataLoader(ds, batch_size=25, shuffle=True, seed=0),
                    DataLoader(ds, batch_size=50))
    logged = [r.getMessage() for r in caplog.records if r.getMessage().startswith("epoch=")]
    assert [m.split()[0] for m in logged] == ["epoch=0", "epoch=2"]
    (got,) = (tmp_path / "tb").glob("events.out.tfevents.*")
    with jax_tbevents.ScalarEventWriter(tmp_path / "jax") as w:
        for record in trainer.history:
            w.add_scalars(record, step=record["epoch"])
    assert got.read_bytes() == w.path.read_bytes()
    trace = json.loads((tmp_path / "prof/trace.json").read_text())
    # the traced steps' backward passes
    assert any("autograd::engine" in e.get("name", "") for e in trace["traceEvents"])
