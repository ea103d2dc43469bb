from chemprop_tpu_torch.data.collate import BatchMolGraph, PadSpec, batch_mol_graphs, pad_to_bucket

__all__ = ["BatchMolGraph", "PadSpec", "batch_mol_graphs", "pad_to_bucket"]
