"""The port's molecule featurizers (``chemprop_tpu_torch/featurizers/molecule.py``
over its own copies of ``chem/{smarts,charges,estate,fragments,surface,
descriptors}.py``) against the JAX package's, on the CPU: each registry
entry's vector equal to JAX's element for element, NaNs equal, on 20
molecules of mol.csv and on the reference's RDKit fixture molecule; the
SMARTS counts of the fragment patterns; and ``--molecule-featurizers`` in
``train`` and ``predict`` against the JAX command line."""

from __future__ import annotations

import csv

import numpy as np
import pytest

from chemprop_tpu.chem import make_mol as jax_make_mol
from chemprop_tpu.chem import smarts as jax_smarts
from chemprop_tpu.chem.fragments import FRAGMENT_SMARTS as JAX_PATTERNS
from chemprop_tpu.cli.main import main as jax_main
from chemprop_tpu.featurizers.molecule import MoleculeFeaturizerRegistry as JaxRegistry
from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.chem import smarts
from chemprop_tpu_torch.chem.descriptors import DESCLIST_NAMES, RDKIT2D_NAMES
from chemprop_tpu_torch.chem.fragments import FRAGMENT_SMARTS
from chemprop_tpu_torch.cli.main import main as port_main
from chemprop_tpu_torch.featurizers.molecule import MoleculeFeaturizerRegistry

# the reference's RDKit fixture molecule (tests/unit/chem/test_desclist_217.py)
FIXTURE_SMI = "Fc1cccc(C2(c3nnc(Cc4cccc5ccccc45)o3)CCOCC2)c1"
N_MOLS = 20
NAMES = ["morgan_binary", "morgan_count", "charge", "rdkit_2d", "v1_rdkit_2d",
         "v1_rdkit_2d_normalized"]


@pytest.fixture(scope="module")
def smiles(data_dir):
    with open(data_dir / "regression/mol/mol.csv") as f:
        rows = [r[0] for r in list(csv.reader(f))[1:]]
    # a charged and a stereo molecule besides the first rows
    return [FIXTURE_SMI, "C[C@H](N)C(=O)[O-]", "C/C=C/c1ccccc1[N+](=O)[O-]", *rows[:N_MOLS - 3]]


def test_registry_has_the_jax_entries():
    assert sorted(MoleculeFeaturizerRegistry) == sorted(JaxRegistry) == sorted(NAMES)
    assert len(DESCLIST_NAMES) == 217 and len(RDKIT2D_NAMES) == 200


@pytest.mark.parametrize("name", NAMES)
def test_vectors_equal_jax(smiles, name):
    port, jax = MoleculeFeaturizerRegistry[name](), JaxRegistry[name]()
    assert len(port) == len(jax)
    for smi in smiles:
        got, want = port(make_mol(smi)), jax(jax_make_mol(smi))
        assert got.shape == want.shape == (len(port),) and got.dtype == want.dtype, smi
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {smi}")


@pytest.mark.parametrize("name", ["rdkit_2d", "v1_rdkit_2d"])
def test_fixture_vector_is_finite(name):
    """The fixture's vectors have no NaN (JAX's pins them against RDKit)."""
    x = MoleculeFeaturizerRegistry[name]()(make_mol(FIXTURE_SMI))
    assert np.isfinite(x).all() and np.count_nonzero(x) > 50


def test_smarts_counts_equal_jax(smiles):
    assert FRAGMENT_SMARTS == JAX_PATTERNS
    for smi in smiles[:8]:
        mol, jmol = make_mol(smi), jax_make_mol(smi)
        for name, pattern in FRAGMENT_SMARTS.items():
            assert (smarts.count_matches(mol, pattern)
                    == jax_smarts.count_matches(jmol, pattern)), (smi, name)


# ------------------------------------------------------------- command line
@pytest.fixture(scope="module")
def small_csv(tmp_path_factory, data_dir):
    """The first 24 rows of mol.csv."""
    path = tmp_path_factory.mktemp("molfeat") / "mol24.csv"
    with open(data_dir / "regression/mol/mol.csv") as f:
        rows = list(csv.reader(f))[:25]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return path


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_train_with_molecule_featurizers_matches_jax(tmp_path, small_csv):
    """One epoch of each package's ``train`` with two featurizers: the same
    splits and first loss, and the FFN's input widened by 2049 columns."""
    argv = ["train", "-i", str(small_csv), "--epochs", "1", "--message-hidden-dim", "16",
            "--ffn-hidden-dim", "16", "--molecule-featurizers", "morgan_binary", "charge",
            "--split-sizes", "0.5", "0.25", "0.25"]
    assert jax_main(argv + ["-o", str(tmp_path / "jax")]) == 0
    assert port_main(argv + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    from chemprop_tpu.models.serialize import load_model as jax_load_model
    from chemprop_tpu_torch.models import serialize

    manifest, variables = serialize.read_checkpoint(tmp_path / "port" / "best.ckpt")
    assert manifest["model"]["predictor"]["input_dim"] == 16 + 2049
    assert manifest["model"]["X_d_transform"]["__transform__"] == "scale"
    jmodel, jvars, _ = jax_load_model(tmp_path / "port" / "best.ckpt")
    assert jmodel.predictor.input_dim == 16 + 2049
    assert (tmp_path / "port/splits.json").read_text() == (tmp_path / "jax/splits.json").read_text()


def test_predict_with_molecule_featurizers_matches_jax(tmp_path, small_csv):
    """A model trained by the port with ``v1_rdkit_2d`` served by both
    command lines from its ``CPTPU001`` file: the same columns and values."""
    train = ["train", "-i", str(small_csv), "--epochs", "1", "--message-hidden-dim", "16",
             "--ffn-hidden-dim", "16", "--molecule-featurizers", "v1_rdkit_2d",
             "-o", str(tmp_path / "model"), "--device", "cpu"]
    assert port_main(train) == 0
    pred = ["predict", "-i", str(small_csv), "--model-paths", str(tmp_path / "model/best.ckpt"),
            "--molecule-featurizers", "v1_rdkit_2d"]
    assert jax_main(pred + ["-o", str(tmp_path / "jax.csv")]) == 0
    assert port_main(pred + ["-o", str(tmp_path / "port.csv"), "--device", "cpu"]) == 0
    want, got = _rows(tmp_path / "jax.csv"), _rows(tmp_path / "port.csv")
    assert got[0] == want[0] and [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([float(r[1]) for r in got[1:]], [float(r[1]) for r in want[1:]],
                               rtol=1e-5, atol=1e-6)
