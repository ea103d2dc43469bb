from chemprop_tpu_torch.data.collate import (
    BatchMolGraph,
    MABTrainingBatch,
    PadSpec,
    TrainingBatch,
    batch_mol_graphs,
    collate_batch,
    collate_mol_atom_bond_batch,
    pad_to_bucket,
)
from chemprop_tpu_torch.data.dataloader import DataLoader
from chemprop_tpu_torch.data.datapoints import MolAtomBondDatapoint, MoleculeDatapoint
from chemprop_tpu_torch.data.datasets import (
    Datum, MABDatum, MolAtomBondDataset, MoleculeDataset, StandardScaler,
)
from chemprop_tpu_torch.data.samplers import SeededSampler

# the JAX package's aliases of the mol-atom-bond types
BatchMolAtomBondGraph = BatchMolGraph
MolAtomBondDatum = MABDatum
MolAtomBondTrainingBatch = MABTrainingBatch

__all__ = [
    "BatchMolAtomBondGraph",
    "BatchMolGraph",
    "DataLoader",
    "Datum",
    "MABDatum",
    "MABTrainingBatch",
    "MolAtomBondDataset",
    "MolAtomBondDatapoint",
    "MolAtomBondDatum",
    "MolAtomBondTrainingBatch",
    "MoleculeDatapoint",
    "MoleculeDataset",
    "PadSpec",
    "SeededSampler",
    "StandardScaler",
    "TrainingBatch",
    "batch_mol_graphs",
    "collate_batch",
    "collate_mol_atom_bond_batch",
    "pad_to_bucket",
]
