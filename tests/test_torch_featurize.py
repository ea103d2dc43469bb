"""The port's copied featurizer and its collate against the JAX package's, on
the 100 molecules of tests/data/smis.csv: the graphs must be equal exactly."""

from __future__ import annotations

import numpy as np
import pytest

from chemprop_tpu.chem import make_mol as jax_make_mol
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import (
    SimpleMoleculeMolGraphFeaturizer as JaxFeaturizer,
)
from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer


@pytest.fixture(scope="module")
def graphs(smis):
    extra = ["C", "[Na+]", "CC(=O)[O-].[NH4+]", "C[C@H](N)C(=O)O", "F/C=C/F"]
    smis = list(smis) + extra
    port = SimpleMoleculeMolGraphFeaturizer()
    ref = JaxFeaturizer()
    return [port(make_mol(s)) for s in smis], [ref(jax_make_mol(s)) for s in smis]


def test_featurizer_matches_jax_exactly(graphs):
    ours, theirs = graphs
    assert len(ours) == len(theirs) == 105
    for a, b in zip(ours, theirs):
        for field in ("V", "E", "edge_index", "rev_edge_index"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and x.shape == y.shape, field
            np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("pad", [None, (4096, 8192, 128)])
def test_collate_matches_jax_exactly(graphs, pad):
    ours, theirs = graphs
    tb, perm = batch_mol_graphs(ours, PadSpec(*pad) if pad else None, return_perm=True)
    jb, jperm = jax_batch(theirs, JaxPadSpec(*pad) if pad else None, return_perm=True)
    assert tb.n_graphs == jb.n_graphs
    np.testing.assert_array_equal(perm, jperm)
    for field in ("V", "E", "src", "dst", "rev", "batch", "node_mask", "edge_mask"):
        x, y = getattr(tb, field).numpy(), np.asarray(getattr(jb, field))
        assert x.dtype == y.dtype and x.shape == y.shape, field
        np.testing.assert_array_equal(x, y, err_msg=field)


def test_csr_pointers(graphs):
    tb = batch_mol_graphs(graphs[0])
    dst, batch = tb.dst.numpy(), tb.batch.numpy()
    edge_ptr, node_ptr = tb.edge_ptr.numpy(), tb.node_ptr.numpy()
    n_nodes = tb.V.shape[0]
    assert edge_ptr.shape == (n_nodes + 1,) and node_ptr.shape == (tb.n_graphs + 2,)
    assert edge_ptr[0] == 0 and edge_ptr[-1] == len(dst)
    assert node_ptr[0] == 0 and node_ptr[-1] == n_nodes
    for v in (0, n_nodes // 2, n_nodes - 1):  # in-edges of v, padding node included
        assert (dst[edge_ptr[v] : edge_ptr[v + 1]] == v).all()
        assert (dst == v).sum() == edge_ptr[v + 1] - edge_ptr[v]
    np.testing.assert_array_equal(np.diff(node_ptr), np.bincount(batch, minlength=tb.n_graphs + 1))
    # the reverse of a reverse edge is the edge itself, on padding too
    rev = tb.rev.numpy()
    np.testing.assert_array_equal(rev[rev], np.arange(len(rev)))


def test_batch_moves_between_devices(graphs):
    tb = batch_mol_graphs(graphs[0][:4])
    moved = tb.to("cpu")
    assert moved.n_graphs == 4 and moved.V.dtype == tb.V.dtype
    assert moved.edge_ptr.device.type == "cpu"


def test_pad_spec_matches_jax(graphs):
    ours, theirs = graphs
    for k in (1, 7, 64, len(ours)):
        assert tuple(PadSpec.for_graphs(ours[:k])) == tuple(JaxPadSpec.for_graphs(theirs[:k]))


def test_undersized_pad_is_refused(graphs):
    with pytest.raises(ValueError):
        batch_mol_graphs(graphs[0], PadSpec(16, 4096, 128))
