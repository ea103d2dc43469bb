"""The port's LazyMoleculeDatapoint: deferred SMILES parsing (the port of
``tests/unit/data/test_datapoints_lazy.py``)."""

import numpy as np

from chemprop_tpu_torch.data.datapoints import LazyMoleculeDatapoint, MoleculeDatapoint


def test_mol_parsed_on_first_access():
    dp = LazyMoleculeDatapoint.from_smi("CCO", y=np.array([1.0]))
    assert "_mol" not in dp.__dict__  # nothing parsed yet
    assert dp.mol.num_atoms == 3
    assert "_mol" in dp.__dict__  # cached now
    assert dp.mol is dp.mol


def test_matches_eager_datapoint():
    lazy = LazyMoleculeDatapoint.from_smi("c1ccccc1O", keep_h=False)
    eager = MoleculeDatapoint.from_smi("c1ccccc1O", keep_h=False)
    assert lazy.mol.num_atoms == eager.mol.num_atoms
    assert lazy.mol.num_bonds == eager.mol.num_bonds
    assert lazy.name == eager.name == "c1ccccc1O"


def test_parse_flags_respected():
    lazy = LazyMoleculeDatapoint.from_smi("[H][H]", keep_h=True)
    assert lazy.mol.num_atoms == 2


def test_works_in_dataset():
    from chemprop_tpu_torch.data import MoleculeDataset

    dps = [LazyMoleculeDatapoint.from_smi(s, y=np.array([float(i)]))
           for i, s in enumerate(["CCO", "CC", "c1ccccc1"])]
    ds = MoleculeDataset(dps)
    d = ds[0]
    assert d.mg.V.shape[0] == 3


def test_graph_matches_the_eager_datapoint_and_jax():
    """The lazy datapoint's graph is the eager one's, and the JAX package's
    lazy datapoint's."""
    from chemprop_tpu.data import MoleculeDataset as JaxDataset
    from chemprop_tpu.data.datapoints import LazyMoleculeDatapoint as JaxLazy
    from chemprop_tpu_torch.data import MoleculeDataset

    smis = ["CC(=O)Nc1ccc(O)cc1", "[NH4+]", "C1CC1"]
    lazy = MoleculeDataset([LazyMoleculeDatapoint.from_smi(s) for s in smis])
    eager = MoleculeDataset([MoleculeDatapoint.from_smi(s) for s in smis])
    jax_ = JaxDataset([JaxLazy.from_smi(s) for s in smis])
    for i in range(len(smis)):
        for a, b, c in zip(lazy[i].mg, eager[i].mg, jax_[i].mg):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
