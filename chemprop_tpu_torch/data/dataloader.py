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
are refused, as the JAX loader refuses them.

A molecule of more than ``SPAN_LIMIT`` (385) directed edges goes into a
batch of its own kind, as in the JAX loader: every loader, shuffled,
class-balanced or fixed-order, keeps such molecules (``_oversized``: twice
``dataset.data[i].mol.num_bonds``, so a datum without ``.mol``, such as a
reaction's, never is one) in a second list, yields that list whenever it
holds ``batch_size`` of them and what is left of it after the last ordinary
batch (not with ``drop_last``), so that such a molecule no longer takes the
small molecules of its batch off the kernels' tile tables. The shards of
such a batch and the ``prefetch`` thread take it as it is. ``len`` keeps the
JAX formula, which counts one batch fewer where both lists end in a short
batch that would fit in one. For a fixed-order loader ``emitted_order`` is
then a permutation of the dataset's rows (a subset of them with
``drop_last``), which ``Trainer.predict``, ``MABTrainer.predict``
(``restore_mab_order``) and ``fingerprint`` invert to give their rows in
dataset order.

With ``prefetch > 0`` (the default, 2, as in the JAX package) one daemon
thread collates the batches ahead into a queue of that many, so that the
host's collate overlaps the caller's work on each batch; the batches and
their order are those of ``prefetch=0``, which collates each one when it is
asked for. A producer's exception is raised in the caller. Where the JAX
loader's thread stays blocked when its caller stops early, closing the
port's iterator (``next(iter(loader))``, a ``break``, an exception in the
loop) stops and joins its producer. The producer only collates on the host:
it touches no CUDA state and no launch counter."""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from chemprop_tpu_torch.data.collate import (
    PadSpec, TrainingBatch, collate_batch, collate_mol_atom_bond_batch, collate_multicomponent,
    collate_sharded,
)
from chemprop_tpu_torch.data.datasets import MABDatum, MoleculeDataset
from chemprop_tpu_torch.data.samplers import ClassBalanceSampler, SeededSampler

# the JAX message kernel's widest window of one molecule, 3 * 128 + 1
# directed edges (chemprop_tpu/ops/fused_message.py:57,76: SPAN_LIMIT[3])
SPAN_LIMIT = 3 * 128 + 1


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
        prefetch: int = 2,
        n_shards: int = 0,
        shard_index: int = 0,
    ):
        """``prefetch`` batches are collated ahead in a background thread (0:
        none). ``n_shards > 0`` yields shard ``shard_index`` of each batch, a
        ``Shard``; ``pad_spec`` is then each shard's."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.pad_spec = pad_spec
        self.prefetch = prefetch
        self.n_shards, self.shard_index = n_shards, shard_index
        self._reshuffles = bool(shuffle or class_balance)
        self._isolate_oversized = True
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
        order changes between iterations (shuffle, class balance): a
        permutation of the rows where oversized molecules were set apart."""
        if self._reshuffles:
            return None
        idxs = [i for batch in self._index_batches() for i in batch]
        return np.asarray(idxs, dtype=np.int64)

    def _oversized(self, i: int) -> bool:
        """Whether datum ``i``'s molecule has more than ``SPAN_LIMIT`` directed
        edges, read from its ``.mol`` without featurising it."""
        data = getattr(self.dataset, "data", None)
        if not data:
            return False
        mol = getattr(data[i], "mol", None)
        return mol is not None and 2 * mol.num_bonds > SPAN_LIMIT

    def _index_batches(self) -> Iterator[list[int]]:
        batch: list[int] = []
        big: list[int] = []  # oversized molecules, in batches of their own
        for i in self.sampler:
            if self._isolate_oversized and self._oversized(i):
                big.append(i)
                if len(big) == self.batch_size:
                    yield big
                    big = []
                continue
            batch.append(i)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch
        if big and not self.drop_last:
            yield big

    def _make_batch(self, idxs: list[int]):
        data = [self.dataset[i] for i in idxs]
        if self.n_shards:
            if isinstance(data[0], MABDatum):
                raise NotImplementedError("sharded MAB batches are not supported yet")
            return collate_sharded(data, self.n_shards, self.pad_spec, shard_index=self.shard_index)
        if isinstance(data[0], list):  # multicomponent rows: a pad per component
            pads = self.pad_spec or [
                PadSpec.for_graphs([row[c].mg for row in data], n_graphs=self.batch_size)
                for c in range(len(data[0]))]
            return collate_multicomponent(data, pads)
        pad = self.pad_spec or PadSpec.for_graphs([d.mg for d in data], n_graphs=self.batch_size)
        if isinstance(data[0], MABDatum):
            return collate_mol_atom_bond_batch(data, pad)
        return collate_batch(data, pad)

    def __iter__(self) -> Iterator[TrainingBatch]:
        if self.prefetch <= 0:
            for idxs in self._index_batches():
                yield self._make_batch(idxs)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def produce():
            try:
                for idxs in self._index_batches():
                    if stop.is_set():
                        return
                    q.put(self._make_batch(idxs))
            except BaseException as e:  # raised in the consumer
                q.put(e)
                return
            q.put(done)

        producer = threading.Thread(target=produce, name="DataLoader-prefetch", daemon=True)
        producer.start()
        try:
            while (item := q.get()) is not done:
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # a consumer that stops early: free the queue until the producer,
            # blocked on a put or collating, sees the stop and ends
            stop.set()
            while producer.is_alive():
                try:
                    q.get(timeout=0.01)
                except queue.Empty:
                    pass
            producer.join()


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
    ``chemprop_tpu/data/dataloader.py``) over the port's ``DataLoader``;
    ``kwargs`` (``prefetch``, ...) go to the loader. ``num_workers`` sets the
    dataset's ``n_workers``, the processes that featurise its cache when the
    cache is filled, as in the JAX package; the cache is left as it is."""
    if num_workers:
        dataset.n_workers = num_workers
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle, seed=seed,
                      class_balance=class_balance, **kwargs)
