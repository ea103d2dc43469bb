"""``predict --callback myerson|mcts`` of the port against the JAX
package's CLI on the CPU (float32), on the reference checkpoint
``example_model_v2_regression_mol.pt`` (full width) and two molecules of
eleven heavy atoms (exact Myerson: 2^11 subsets).

Both CLIs write the same files: ``<stem>_myerson_explanation[_i].npz`` (or
``.json`` with ``save_as_json``) and ``<stem>_mcts_rationales[_i].json``,
``_i`` for each member of an ensemble. Tolerances: attributions within
``2 n`` times 1e-5 (``n`` the atoms; 1e-5 the per-subgraph float32 limit of
``test_torch_interpret.py``), rationales' atom sets and SMILES equal and
their scores within 1e-5. The JAX CLI reads ``CPTPU001`` files only, so it
takes its own ``convert`` of the checkpoint."""

from __future__ import annotations

import csv
import json

import numpy as np
import pytest

from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu_torch.cli.main import main as port_main

SMIS = ["CC(=O)Nc1ccc(O)cc1", "CNC(C)Cc1ccccc1"]
N_ATOMS = 11
CKPT = "example_model_v2_regression_mol.pt"


@pytest.fixture(scope="module")
def env(data_dir, tmp_path_factory):
    root = tmp_path_factory.mktemp("interpret_cli")
    inputs = root / "two.csv"
    with open(inputs, "w", newline="") as f:
        csv.writer(f).writerows([["smiles"]] + [[s] for s in SMIS])
    jax_ckpt = root / "reg.jax.ckpt"
    assert jax_main(["convert", "-i", str(data_dir / CKPT), "-o", str(jax_ckpt)]) in (0, None)
    return dict(root=root, inputs=inputs, port=data_dir / CKPT, jax=jax_ckpt)


def _run_both(env, tag, members, *flags):
    """Both CLIs with ``members`` copies of the checkpoint: each one's
    output path."""
    out = {}
    for who, main, path, extra in (("port", port_main, env["port"], ["--device", "cpu"]),
                                   ("jax", jax_main, env["jax"], [])):
        out[who] = env["root"] / who / f"{tag}.csv"
        out[who].parent.mkdir(exist_ok=True)
        assert main(["predict", "--model-paths", *[str(path)] * members, "-i",
                     str(env["inputs"]), "-o", str(out[who]), *flags, *extra]) in (0, None)
    return out


def _hold_attributions(got, want):
    assert len(got) == len(want) == len(SMIS)
    for g, w in zip(got, want):
        assert np.shape(g) == np.shape(w) == (N_ATOMS,)
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * N_ATOMS * 1e-5)


@pytest.mark.parametrize("members", [1, 2])
def test_myerson_npz_matches_jax(env, members):
    out = _run_both(env, f"myerson{members}", members, "--callback", "myerson")
    suffixes = [""] if members == 1 else ["_0", "_1"]
    for s in suffixes:
        files = {who: p.parent / f"{p.stem}_myerson_explanation{s}.npz" for who, p in out.items()}
        with np.load(files["port"]) as a, np.load(files["jax"]) as b:
            assert sorted(a.files) == sorted(b.files) == ["arr_0", "arr_1"]
            _hold_attributions([a[k] for k in sorted(a.files)], [b[k] for k in sorted(b.files)])
    # the efficiency axiom: each molecule's attributions sum to its prediction
    with open(out["port"], newline="") as f:
        preds = [float(r[1]) for r in list(csv.reader(f))[1:]]
    with np.load(out["port"].parent / f"{out['port'].stem}_myerson_explanation{suffixes[0]}.npz") as a:
        np.testing.assert_allclose([a[k].sum() for k in sorted(a.files)], preds, atol=1e-4)


def test_myerson_json_matches_jax(env):
    out = _run_both(env, "myerson_json", 1, "--callback", "myerson", "--callback-params",
                    '{"save_as_json": true, "sampling_threshold": 8, "n_samples": 20}')
    got, want = (json.loads((p.parent / f"{p.stem}_myerson_explanation.json").read_text())
                 for p in (out["port"], out["jax"]))
    _hold_attributions(got, want)


@pytest.mark.parametrize("members", [1, 2])
def test_mcts_rationales_match_jax(env, members):
    out = _run_both(env, f"mcts{members}", members, "--callback", "mcts", "--callback-params",
                    '{"n_rollout": 4, "prop_delta": 0.0}')
    for s in [""] if members == 1 else ["_0", "_1"]:
        got, want = (json.loads((p.parent / f"{p.stem}_mcts_rationales{s}.json").read_text())
                     for p in (out["port"], out["jax"]))
        assert len(got) == len(want) == len(SMIS) and any(got)
        for g, w in zip(got, want):
            assert [(r["atoms"], r["smiles"], r["n_atoms"]) for r in g] == [
                (r["atoms"], r["smiles"], r["n_atoms"]) for r in w]
            np.testing.assert_allclose([r["score"] for r in g], [r["score"] for r in w],
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("callback", ["myerson", "mcts"])
def test_callbacks_refuse_other_heads_before_writing(env, data_dir, callback):
    """A multiclass head is refused by both callbacks, before any file is
    written (the JAX package's MCTS callback has no such guard)."""
    out = env["root"] / f"refused_{callback}.csv"
    with pytest.raises(NotImplementedError, match="regression and binary classification"):
        port_main(["predict", "--model-paths",
                   str(data_dir / "example_model_v2_classification_mol_multiclass.pt"), "-i",
                   str(env["inputs"]), "-o", str(out), "--callback", callback, "--device", "cpu"])
    assert not out.exists()


@pytest.mark.parametrize("callback", ["myerson", "mcts"])
def test_callbacks_refuse_multicomponent_models(env, data_dir, callback):
    mm = data_dir / "regression/mol+mol/mol+mol.csv"
    out = env["root"] / f"refused_mm_{callback}.csv"
    with pytest.raises(ValueError, match="single-molecule.*item 7"):
        port_main(["predict", "--model-paths",
                   str(data_dir / "example_model_v2_regression_mol+mol.pt"), "-i", str(mm),
                   "-s", "smiles", "solvent", "-o", str(out), "--callback", callback,
                   "--device", "cpu"])
    assert not out.exists()
