"""Batch iteration (cf. ``chemprop_tpu/data/dataloader.py``): every batch is
padded to bucketed node and edge counts and to a constant graph count, as in
the JAX package, so that both packages train on the same tables. Batches lie
on the CPU; the trainer moves them. Shards and class balance are not ported
yet."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from chemprop_tpu_torch.data.collate import PadSpec, TrainingBatch, collate_batch
from chemprop_tpu_torch.data.datasets import MoleculeDataset
from chemprop_tpu_torch.data.samplers import SeededSampler


class DataLoader:
    def __init__(
        self,
        dataset: MoleculeDataset,
        batch_size: int = 64,
        shuffle: bool = False,
        seed: int | None = None,
        drop_last: bool = False,
        pad_spec: PadSpec | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.pad_spec = pad_spec
        self._reshuffles = bool(shuffle)
        if shuffle:
            self.sampler = SeededSampler(len(dataset), 0 if seed is None else seed)
        else:
            self.sampler = range(len(dataset))

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def emitted_order(self) -> np.ndarray | None:
        """Dataset indices in emission order, or None for a loader whose
        order changes between iterations (shuffle)."""
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
            pad = self.pad_spec or PadSpec.for_graphs(
                [d.mg for d in data], n_graphs=self.batch_size
            )
            yield collate_batch(data, pad)
