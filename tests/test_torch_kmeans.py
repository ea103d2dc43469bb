"""The port's ``kmeans`` split and its numpy k-means against the JAX
package's split and scikit-learn's ``KMeans``, on the CPU. scikit-learn is
imported here only: the port clusters without it."""

from __future__ import annotations

import csv

import numpy as np
import pytest

from chemprop_tpu.chem import make_mol as jax_make_mol
from chemprop_tpu.data.splitting import make_split_indices as jax_split
from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.data.kmeans import kmeans_fit_predict
from chemprop_tpu_torch.data.splitting import make_split_indices

CSVS = ["regression/mol/mol.csv", "smis.csv"]


@pytest.fixture(scope="module")
def mols(data_dir):
    out = {}
    for name in CSVS:
        with open(data_dir / name, newline="") as f:
            smis = [row[0] for row in csv.reader(f)][1:]
        out[name] = ([jax_make_mol(s) for s in smis], [make_mol(s) for s in smis])
    return out


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("name", CSVS)
def test_kmeans_split_matches_jax(mols, name, seed):
    jmols, tmols = mols[name]
    want = jax_split(jmols, "kmeans", (0.8, 0.1, 0.1), seed=seed, num_replicates=3)
    got = make_split_indices(tmols, "kmeans", (0.8, 0.1, 0.1), seed=seed, num_replicates=3)
    assert got == want
    for tr, va, te in zip(*got):
        assert sorted(tr + va + te) == list(range(len(tmols)))


# (rows, bits, density, clusters): below and above one 256-row chunk, with
# and without a width that is a multiple of four
SHAPES = [(100, 2048, 0.02, 10), (60, 66, 0.3, 6), (200, 512, 0.1, 20), (400, 256, 0.2, 40)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:2])))
@pytest.mark.parametrize("seed", range(3))
def test_labels_match_sklearn(shape, seed):
    from sklearn.cluster import KMeans

    n, bits, density, k = shape
    rng = np.random.default_rng(seed)
    X = rng.random((n, bits)) < density
    state = int(rng.integers(2**31))
    want = KMeans(n_clusters=k, random_state=state, n_init=3).fit_predict(X.astype(np.float32))
    got = kmeans_fit_predict(X, k, random_state=state, n_init=3)
    np.testing.assert_array_equal(got, want)


def test_duplicate_rows_and_too_few_rows():
    from sklearn.cluster import KMeans

    # many identical rows: empty clusters are relocated (or not) as scikit-learn does
    X = np.repeat(np.eye(4, 16, dtype=bool), [10, 1, 1, 1], axis=0)
    want = KMeans(n_clusters=5, random_state=7, n_init=3).fit_predict(X.astype(np.float32))
    np.testing.assert_array_equal(kmeans_fit_predict(X, 5, random_state=7), want)
    with pytest.raises(ValueError, match="n_samples=3 should be >= n_clusters=4"):
        kmeans_fit_predict(np.eye(3, 8), 4, random_state=0)
