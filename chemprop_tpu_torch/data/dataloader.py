"""Batch iteration (cf. ``chemprop_tpu/data/dataloader.py``): every batch is
padded to bucketed node and edge counts and to a constant graph count, as in
the JAX package, so that both packages train on the same tables. Batches lie
on the CPU; the trainer moves them. ``class_balance`` takes the
``ClassBalanceSampler`` over the dataset's targets (shuffled where
``shuffle`` is), as the JAX loader does. A ``MulticomponentDataset``'s rows
collate into one padded graph per component (``collate_multicomponent``),
each padded to its own bucket; a ``MolAtomBondDataset``'s rows collate into
a ``MABTrainingBatch`` (``collate_mol_atom_bond_batch``). With ``n_shards``
each batch is cut into that many whole-graph shards and the loader yields
shard ``shard_index`` of each (``collate_sharded``, a ``Shard``): every rank
of a process group iterates the same batches and collates only its own
shard (the JAX loader stacks all of them); mol-atom-bond rows with shards
are refused, as the JAX loader refuses them. Not ported: the JAX
loader's isolation of molecules wider than its kernel's window (more than 192
bonds) into batches of their own; the port's kernels take such a molecule's
split tile table instead. So ``emitted_order`` is the dataset's order
wherever it is not None: ``Trainer.predict`` leaves its rows as they are, and
the mol-atom-bond trainer and ``fingerprint`` need no counterpart of the JAX
package's ``restore_mab_order``."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from chemprop_tpu_torch.data.collate import (
    PadSpec, TrainingBatch, collate_batch, collate_mol_atom_bond_batch, collate_multicomponent,
    collate_sharded,
)
from chemprop_tpu_torch.data.datasets import MABDatum, MoleculeDataset
from chemprop_tpu_torch.data.samplers import ClassBalanceSampler, SeededSampler


class DataLoader:
    def __init__(
        self,
        dataset: MoleculeDataset,
        batch_size: int = 64,
        shuffle: bool = False,
        seed: int | None = None,
        class_balance: bool = False,
        drop_last: bool = False,
        pad_spec: PadSpec | None = None,
        n_shards: int = 0,
        shard_index: int = 0,
    ):
        """``n_shards > 0`` yields shard ``shard_index`` of each batch, a
        ``Shard``; ``pad_spec`` is then each shard's."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.pad_spec = pad_spec
        self.n_shards, self.shard_index = n_shards, shard_index
        self._reshuffles = bool(shuffle or class_balance)
        if class_balance:
            self.sampler = ClassBalanceSampler(dataset.Y, seed, shuffle)
        elif shuffle:
            self.sampler = SeededSampler(len(dataset), 0 if seed is None else seed)
        else:
            self.sampler = range(len(dataset))

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def emitted_order(self) -> np.ndarray | None:
        """Dataset indices in emission order, or None for a loader whose
        order changes between iterations (shuffle, class balance)."""
        if self._reshuffles:
            return None
        idxs = [i for batch in self._index_batches() for i in batch]
        return np.asarray(idxs, dtype=np.int64)

    def _index_batches(self) -> Iterator[list[int]]:
        batch: list[int] = []
        for i in self.sampler:
            batch.append(i)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __iter__(self) -> Iterator[TrainingBatch]:
        for idxs in self._index_batches():
            data = [self.dataset[i] for i in idxs]
            if self.n_shards:
                if isinstance(data[0], MABDatum):
                    raise NotImplementedError("sharded MAB batches are not supported yet")
                yield collate_sharded(data, self.n_shards, self.pad_spec, self.shard_index)
                continue
            if isinstance(data[0], list):  # multicomponent rows: a pad per component
                pads = self.pad_spec or [
                    PadSpec.for_graphs([row[c].mg for row in data], n_graphs=self.batch_size)
                    for c in range(len(data[0]))]
                yield collate_multicomponent(data, pads)
                continue
            pad = self.pad_spec or PadSpec.for_graphs(
                [d.mg for d in data], n_graphs=self.batch_size
            )
            if isinstance(data[0], MABDatum):
                yield collate_mol_atom_bond_batch(data, pad)
                continue
            yield collate_batch(data, pad)


def build_dataloader(
    dataset: MoleculeDataset,
    batch_size: int = 64,
    num_workers: int = 0,
    class_balance: bool = False,
    seed: int | None = None,
    shuffle: bool = True,
    **kwargs,
) -> DataLoader:
    """The reference's loader factory (cf. ``build_dataloader`` of
    ``chemprop_tpu/data/dataloader.py``) over the port's ``DataLoader``.
    ``num_workers`` featurises the dataset once, up front, in that many
    processes (the JAX package's dataset-level parallel featurisation)."""
    if num_workers and hasattr(dataset, "_featurize"):
        from chemprop_tpu_torch.utils.utils import parallel_execute

        dataset._cache = parallel_execute(dataset._featurize, range(len(dataset)), num_workers)
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle, seed=seed,
                      class_balance=class_balance, **kwargs)
