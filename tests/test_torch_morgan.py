"""The hashed Morgan fingerprints of the port (``chem/morgan.py``) against
the JAX package's (``chemprop_tpu/chem/morgan.py``) on the 100 molecules of
tests/data/regression/mol/mol.csv, each parsed by its own package: the
environment identifiers and the binary and count fingerprints equal bit for
bit at radii 0-3 and lengths 1024 and 2048."""

from __future__ import annotations

import csv

import numpy as np
import pytest

from chemprop_tpu.chem import make_mol as jax_make_mol
from chemprop_tpu.chem import morgan as jax_morgan
from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.chem import morgan


@pytest.fixture(scope="module")
def mols(data_dir):
    with open(data_dir / "regression/mol/mol.csv") as f:
        smis = [row[0] for row in csv.reader(f)][1:]
    assert len(smis) == 100
    return [(make_mol(s), jax_make_mol(s)) for s in smis]


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
def test_morgan_fingerprints_equal_jax(mols, radius):
    for mol, jmol in mols:
        ids = morgan.morgan_identifiers(mol, radius)
        assert ids == jax_morgan.morgan_identifiers(jmol, radius)
        assert len(ids) == (radius + 1) * mol.num_atoms
        for length in (1024, 2048):
            for name in ("morgan_binary_fingerprint", "morgan_count_fingerprint"):
                got = getattr(morgan, name)(mol, radius, length)
                want = getattr(jax_morgan, name)(jmol, radius, length)
                assert got.dtype == want.dtype and got.shape == (length,)
                np.testing.assert_array_equal(got, want, err_msg=f"{name} r={radius} {length}")
