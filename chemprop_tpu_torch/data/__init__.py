from chemprop_tpu_torch.data.collate import (
    BatchMolGraph,
    PadSpec,
    TrainingBatch,
    batch_mol_graphs,
    collate_batch,
    pad_to_bucket,
)
from chemprop_tpu_torch.data.dataloader import DataLoader
from chemprop_tpu_torch.data.datapoints import MoleculeDatapoint
from chemprop_tpu_torch.data.datasets import Datum, MoleculeDataset, StandardScaler
from chemprop_tpu_torch.data.samplers import SeededSampler

__all__ = [
    "BatchMolGraph",
    "DataLoader",
    "Datum",
    "MoleculeDatapoint",
    "MoleculeDataset",
    "PadSpec",
    "SeededSampler",
    "StandardScaler",
    "TrainingBatch",
    "batch_mol_graphs",
    "collate_batch",
    "pad_to_bucket",
]
