"""The port's ``hpopt`` against the JAX package's on the CPU: the search
space's draws, the tree-structured Parzen estimator and the keyword
expansion; FIFO, TPE, ASHA and the grace period under a rigged trial
function (the same deterministic function of a trial's config in both
packages), whose ``all_progress.json`` and ``best_config.json`` must equal
JAX's byte for byte; the arguments each package hands to its ``train``; a
real run of the port and its retrain from ``best_config.json``; a trial that
raises; and what each package does when ASHA resumes a trial a second
time, a divergence by design (``ROADMAP.md`` §3)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from chemprop_tpu.cli import hpopt as jax_hpopt
from chemprop_tpu.cli import train as jax_train
from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu_torch.cli import hpopt
from chemprop_tpu_torch.cli import train as port_train
from chemprop_tpu_torch.cli.main import main as port_main
from chemprop_tpu_torch.models import serialize

# a tiny model, so that a trial of the real run takes a fraction of a second
TINY = ["--message-hidden-dim", "16", "--ffn-hidden-dim", "16", "--batch-size", "50"]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("keywords", [["all"], ["basic"], ["learning_rate", "activation"]])
def test_draws_and_keywords_equal_jax(seed, keywords):
    keys = hpopt._expand_keywords(keywords)
    assert keys == jax_hpopt._expand_keywords(keywords)
    assert hpopt.SEARCH_SPACE == jax_hpopt.SEARCH_SPACE
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    assert [hpopt._sample(rng, keys) for _ in range(8)] == [
        jax_hpopt._sample(jrng, keys) for _ in range(8)]
    with pytest.raises(ValueError, match="unknown search keyword"):
        hpopt._expand_keywords(["width"])


def test_tpe_sampler_equals_jax():
    """Both estimators fed the same scores (inf included, which neither
    observes) propose the same configs."""
    keys = hpopt._expand_keywords(["all"])
    ours = hpopt.TPESampler(keys, np.random.default_rng(3), n_startup=3)
    theirs = jax_hpopt.TPESampler(keys, np.random.default_rng(3), n_startup=3)
    for k in range(12):
        cfg, jcfg = ours.suggest(), theirs.suggest()
        assert cfg == jcfg, k
        score = float("inf") if k == 4 else float(np.cos(cfg["depth"] + 10 * cfg["max_lr"]))
        ours.observe(cfg, score)
        theirs.observe(jcfg, score)
    assert len(ours.observations) == 11


def _rigged(args, out_dir, trial, cfg, epochs, resume):
    """A deterministic function of the trial's config and budget."""
    x = sum(len(v) if isinstance(v, str) else float(v) for v in cfg.values())
    return float(np.sin(3 * x + trial) + 1.0 / epochs + (0.25 if resume else 0.0))


SEARCHES = {
    "fifo_random": ["--search-algorithm", "random", "--num-trials", "6"],
    "fifo_tpe": ["--search-algorithm", "hyperopt", "--num-trials", "9", "--startup-trials", "3",
                 "--search-parameter-keywords", "all"],
    "asha": ["--scheduler", "asha", "--num-trials", "9", "--epochs", "9",
             "--search-parameter-keywords", "basic", "learning_rate"],
    "asha_grace": ["--raytune-trial-scheduler", "AsyncHyperBand", "--num-trials", "8",
                   "--epochs", "8", "--raytune-grace-period", "3", "--asha-eta", "2",
                   "--hyperopt-random-state-seed", "5"],
}


@pytest.mark.parametrize("search", SEARCHES)
def test_rigged_search_files_equal_jax(data_dir, tmp_path, monkeypatch, capsys, search):
    monkeypatch.setattr(jax_hpopt, "_run_trial", _rigged)
    monkeypatch.setattr(hpopt, "_run_trial", _rigged)
    argv = ["hpopt", "-i", str(data_dir / "regression/mol/mol.csv"), *SEARCHES[search]]
    assert jax_main(argv + ["-o", str(tmp_path / "jax")]) == 0
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_main(argv + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == jax_line
    for name in ("all_progress.json", "best_config.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    progress = json.loads((tmp_path / "port" / "all_progress.json").read_text())
    if "asha" in search:
        assert len({r["rung"] for r in progress}) > 1  # survivors were resumed


def test_trial_arguments_equal_jax(data_dir, tmp_path, monkeypatch):
    """The Namespace each package hands to its ``train.main`` for a trial,
    equal on the JAX package's keys (the subcommand's function apart)."""
    seen = {}

    def capture(name):
        def main(targs):
            seen.setdefault(name, []).append(vars(targs).copy())
            targs.output_dir.mkdir(parents=True, exist_ok=True)
            (targs.output_dir / "history.json").write_text('[{"train_loss": 1.0}]')
            return 0
        return main

    monkeypatch.setattr(jax_train, "main", capture("jax"))
    monkeypatch.setattr(port_train, "main", capture("port"))
    argv = ["hpopt", "-i", str(data_dir / "regression/mol/mol.csv"), "--num-trials", "3",
            "--search-algorithm", "random", "--search-parameter-keywords", "all", "--epochs", "4",
            "-o", str(tmp_path)]
    assert jax_main(argv) == 0
    assert port_main(argv + ["--device", "cpu"]) == 0
    assert len(seen["jax"]) == len(seen["port"]) == 3
    for jargs, pargs in zip(seen["jax"], seen["port"]):
        keys = set(jargs) - {"func"}
        assert keys <= set(pargs)
        assert {k: pargs[k] for k in keys} == {k: jargs[k] for k in keys}
        assert pargs["final_lr"] == pytest.approx(jargs["final_lr"])
        assert (pargs["num_replicates"], pargs["ensemble_size"], pargs["epochs"]) == (1, 1, 4)
        assert pargs["device"] == "cpu"


def test_real_search_retrains_from_its_best_config(data_dir, tmp_path, capsys):
    """Two trials of the port on the CPU, then ``train --config-path`` with
    the best trial's arguments."""
    mol = str(data_dir / "regression/mol/mol.csv")
    out = tmp_path / "search"
    assert port_main(["hpopt", "-i", mol, "-o", str(out), "--num-trials", "2", "--epochs", "1",
                      "--search-algorithm", "random", "--search-parameter-keywords", "depth",
                      "max_lr", "final_lr_ratio", "--device", "cpu", *TINY]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    progress = json.loads((out / "all_progress.json").read_text())
    assert [r["trial"] for r in progress] == [0, 1]
    assert all(np.isfinite(r["score"]) for r in progress)
    best = json.loads((out / "best_config.json").read_text())
    assert last["best_config"] == best and set(best) == {"depth", "max_lr", "final_lr"}
    assert last["best_score"] == min(r["score"] for r in progress)
    for k in range(2):
        assert (out / f"trial_{k}" / "best.ckpt").is_file()
    retrain = tmp_path / "retrain"
    assert port_main(["--config-path", str(out / "best_config.json"), "train", "-i", mol, "-o",
                      str(retrain), "--epochs", "1", "--device", "cpu", *TINY]) == 0
    config = json.loads((retrain / "config.json").read_text())
    assert {k: config[k] for k in best} == best
    manifest, _ = serialize.read_checkpoint(retrain / "best.ckpt")
    assert manifest["model"]["message_passing"]["depth"] == best["depth"]


def test_a_trial_that_raises_scores_inf_and_is_logged(data_dir, tmp_path, monkeypatch, capsys):
    def fail_second(targs):
        if targs.output_dir.name == "trial_1":
            raise RuntimeError("kernel failed")
        targs.output_dir.mkdir(parents=True, exist_ok=True)
        (targs.output_dir / "history.json").write_text('[{"train_loss": 2.0, "val_loss": 1.5}]')
        return 0

    monkeypatch.setattr(port_train, "main", fail_second)
    assert port_main(["hpopt", "-i", str(data_dir / "regression/mol/mol.csv"), "-o",
                      str(tmp_path), "--num-trials", "3", "--search-algorithm", "random",
                      "--device", "cpu"]) == 0
    scores = [r["score"] for r in json.loads((tmp_path / "all_progress.json").read_text())]
    assert scores == [1.5, float("inf"), 1.5]
    # the command line logs to stderr; the warning carries the traceback
    log = capsys.readouterr().err
    assert log.count("WARNING chemprop_tpu_torch.cli.hpopt: trial 1 failed: kernel failed") == 1
    assert 'raise RuntimeError("kernel failed")' in log.split("trial 1 failed")[1]


def test_hpopt_refuses_before_any_trial(data_dir, tmp_path, monkeypatch):
    """What ``train`` refuses raises before a trial runs, and so does a
    missing GPU: no search of trials that all score inf."""
    argv = ["hpopt", "-i", str(data_dir / "regression/mol/mol.csv"), "-o", str(tmp_path / "o")]
    with pytest.raises(FileNotFoundError, match="expects a local checkpoint path"):
        port_main(argv + ["--from-foundation", "chemeleon", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(argv)
    assert not (tmp_path / "o").exists()


def test_asha_second_resume_diverges_by_design(data_dir, tmp_path, monkeypatch):
    """One trial run to 1 epoch, resumed to 3, resumed again to 4, through
    each package's ``_run_trial``, as ASHA's rungs do. The first resume runs
    epochs 1-2 in both. The JAX package's ``last.ckpt`` then records 2, the
    epochs its resumed trainer ran (``len(history)``), where the port's
    records 3, the epoch after the last one run; so the second resume runs
    epochs 2-3 in the JAX package and epoch 3 alone in the port."""
    argv = ["hpopt", "-i", str(data_dir / "regression/mol/mol.csv"), "--num-trials", "1",
            "--search-algorithm", "random", *TINY]
    histories, stored = {}, {}
    for name, module, main_ in (("jax", jax_hpopt, jax_main), ("port", hpopt, port_main)):
        runs = []

        def record(args, out_dir, trial, cfg, epochs, resume, _run=module._run_trial, runs=runs):
            for budget, again in ((1, False), (3, True), (4, True)):
                _run(args, out_dir, trial, cfg, budget, again)
                trial_dir = out_dir / f"trial_{trial}"
                runs.append((json.loads((trial_dir / "history.json").read_text()),
                             int(serialize.read_checkpoint(
                                 trial_dir / "checkpoints" / "last.ckpt")[1]["epoch"])))
            return 0.0

        monkeypatch.setattr(module, "_run_trial", record)
        extra = ["--device", "cpu"] if name == "port" else []
        assert main_(argv + ["-o", str(tmp_path / name), *extra]) == 0
        histories[name] = [len(h) for h, _ in runs]
        stored[name] = [epoch for _, epoch in runs]
    assert histories["jax"] == [1, 2, 2] and stored["jax"] == [1, 2, 2]
    assert histories["port"] == [1, 2, 1] and stored["port"] == [1, 3, 4]
