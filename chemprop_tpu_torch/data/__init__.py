from chemprop_tpu_torch.data.collate import (
    BatchMolGraph,
    MABTrainingBatch,
    PadSpec,
    TrainingBatch,
    batch_mol_graphs,
    collate_batch,
    collate_mol_atom_bond_batch,
    collate_multicomponent,
    pad_to_bucket,
)
from chemprop_tpu_torch.data.dataloader import DataLoader, build_dataloader
from chemprop_tpu_torch.data.datapoints import (
    LazyMoleculeDatapoint,
    LazyReactionDatapoint,
    MolAtomBondDatapoint,
    MoleculeDatapoint,
    ReactionDatapoint,
)
from chemprop_tpu_torch.data.datasets import (
    CuikmolmakerDataset,
    CuikmolmakerReactionDataset,
    Datum,
    MABDatum,
    MolAtomBondDataset,
    MoleculeDataset,
    MulticomponentDataset,
    ReactionDataset,
    StandardScaler,
)
from chemprop_tpu_torch.data.molgraph import MolGraph
from chemprop_tpu_torch.data.samplers import ClassBalanceSampler, SeededSampler
from chemprop_tpu_torch.data.splitting import (
    SplitType,
    make_split_indices,
    split_data_by_indices,
)

# the JAX package's names: the mol-atom-bond types, a multicomponent batch
# (a TrainingBatch holding a tuple of graphs) and the datasets of one graph
# per row
BatchMolAtomBondGraph = BatchMolGraph
MolAtomBondDatum = MABDatum
MolAtomBondTrainingBatch = MABTrainingBatch
MulticomponentTrainingBatch = TrainingBatch
MolGraphDataset = MoleculeDataset | ReactionDataset | MolAtomBondDataset

__all__ = [
    "BatchMolAtomBondGraph",
    "BatchMolGraph",
    "ClassBalanceSampler",
    "CuikmolmakerDataset",
    "CuikmolmakerReactionDataset",
    "DataLoader",
    "Datum",
    "LazyMoleculeDatapoint",
    "LazyReactionDatapoint",
    "MABDatum",
    "MABTrainingBatch",
    "MolAtomBondDataset",
    "MolAtomBondDatapoint",
    "MolAtomBondDatum",
    "MolAtomBondTrainingBatch",
    "MolGraph",
    "MolGraphDataset",
    "MoleculeDatapoint",
    "MoleculeDataset",
    "MulticomponentDataset",
    "MulticomponentTrainingBatch",
    "PadSpec",
    "ReactionDatapoint",
    "ReactionDataset",
    "SeededSampler",
    "SplitType",
    "StandardScaler",
    "TrainingBatch",
    "batch_mol_graphs",
    "build_dataloader",
    "collate_batch",
    "collate_mol_atom_bond_batch",
    "collate_multicomponent",
    "make_split_indices",
    "pad_to_bucket",
    "split_data_by_indices",
]
