"""The port's examples (``examples_torch/``): every script of ``examples/``
has a twin of the same name there, listed in its README; each defaults to
``--device cuda`` and raises where there is no GPU; ``training.py`` (the
library API), ``convert_reference_checkpoint.py`` and ``mpnn_fingerprints.py``
(the command line) run end to end on the CPU with ``--device cpu --quick``,
the converted reference checkpoint's predictions within the f32 limit of
PERF.md (rtol 1e-5, atol 1e-4) of the JAX command line's on the same rows.
(``tests/test_torch_imports.py`` holds the scripts to the port's forbidden
imports.)"""

from __future__ import annotations

import csv
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chemprop_tpu.cli.main import main as jax_main

REPO = Path(__file__).resolve().parent.parent
TWINS = REPO / "examples_torch"
JAX_SCRIPTS = sorted(p.name for p in (REPO / "examples").glob("*.py")
                     if not p.name.startswith("_"))


def load(script: str):
    """An example script as a module of its own name, with its ``_common``
    importable."""
    if str(TWINS) not in sys.path:
        sys.path.insert(0, str(TWINS))
    spec = importlib.util.spec_from_file_location(f"examples_torch_{Path(script).stem}",
                                                  TWINS / script)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_every_script_has_a_twin_in_the_readme():
    twins = sorted(p.name for p in TWINS.glob("*.py") if not p.name.startswith("_"))
    assert twins == JAX_SCRIPTS and len(twins) == 19
    readme = (TWINS / "README.md").read_text()
    for script in twins:
        assert f"`{script}`" in readme, script


@pytest.mark.parametrize("script", JAX_SCRIPTS)
def test_default_device_is_cuda_and_raises_without_a_gpu(script, monkeypatch):
    module = load(script)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--device", "cuda", "--quick"])
    assert module.parse_args(module.__doc__, ["--device", "cpu"]).quick is False


@pytest.fixture
def quick(monkeypatch, tmp_path):
    """Run a script with ``--device cpu --quick``, its artefacts in
    ``tmp_path``: the script's output directory."""

    def run(script: str) -> Path:
        module = load(script)
        dirs = []

        def out_dir(name):
            dirs.append(tmp_path / name)
            dirs[-1].mkdir(parents=True, exist_ok=True)
            return dirs[-1]

        monkeypatch.setattr(module, "out_dir", out_dir)
        module.main(["--device", "cpu", "--quick"])
        return dirs[0]

    return run


def test_training_runs_on_the_cpu(quick):
    out = quick("training.py")
    assert {p.name for p in (out / "ckpts").iterdir()} >= {"best.ckpt", "last.ckpt"}


def test_mpnn_fingerprints_runs_on_the_cpu(quick):
    out = quick("mpnn_fingerprints.py")
    with open(out / "fps.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 25 and len(rows[0]) == 301


def test_convert_reference_checkpoint_matches_the_jax_cli(quick, tmp_path):
    out = quick("convert_reference_checkpoint.py")
    rows = out / "smis_head24.csv"
    jax_ckpt, jax_preds = tmp_path / "jax.ckpt", tmp_path / "jax_preds.csv"
    data = REPO / "tests" / "data"
    assert jax_main(["convert", "-i", str(data / "example_model_v2_regression_mol.pt"),
                     "-o", str(jax_ckpt)]) in (0, None)
    assert jax_main(["predict", "-i", str(rows), "--model-paths", str(jax_ckpt),
                     "-o", str(jax_preds)]) in (0, None)
    tables = []
    for path in (out / "preds.csv", jax_preds):
        with open(path, newline="") as f:
            got = list(csv.reader(f))
        tables.append((got[0], [r[0] for r in got[1:]],
                       np.array([[float(x) for x in r[1:]] for r in got[1:]])))
    (ph, pn, pv), (jh, jn, jv) = tables
    assert ph == jh and pn == jn and pv.shape == (24, 1)
    np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-4)
    assert (out / "regression_mol_v1.ckpt").exists()
