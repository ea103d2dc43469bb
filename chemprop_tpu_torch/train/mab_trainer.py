"""The trainer of mol-atom-bond models (cf.
``chemprop_tpu/train/mab_trainer.py``): the ``Trainer``'s step, fit,
checkpoints and Adam, with the loss the sum of the heads' criteria, each
over the finite targets of its own table (molecule rows, node rows,
directed-edge rows, whose weights count each bond once), with that table's
weights and bounds.

Validation records ``val_loss``, the mean over the batches of the summed
loss, and ``val_loss-<kind>`` for each head, as the JAX trainer does; a
metric of ``val_metrics`` named ``<metric>-<kind>`` (``rmse-atom``) is taken
over that head's criterion-space predictions (channel 0 of a head with
several outputs per task) and targets, every row of the table with a finite
target, weight 1 and no bounds. ``predict`` and ``predict_mc_dropout`` return
``(mol, atom, bond)``: padding rows cut, one row per bond in the molecule's
bond order (:func:`collect_mab_rows`), None for an absent head, in dataset
order: where the loader set oversized molecules apart, each table's rows are
put back by :func:`restore_mab_order` (a molecule's group of atom or bond
rows moved whole)."""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from chemprop_tpu_torch.data.collate import MABTrainingBatch
from chemprop_tpu_torch.train.trainer import Trainer

logger = logging.getLogger(__name__)

HEADS = ("mol", "atom", "bond")


@dataclass
class MABTrainer(Trainer):
    def _losses(self, preds, batch: MABTrainingBatch) -> dict[str, torch.Tensor]:
        """Each head's criterion on its table, by kind."""
        parts = {}
        for kind, p, crit, Y, w, lt, gt in zip(HEADS, preds, self.model.criterions(), batch.Ys,
                                                batch.ws, batch.lt_masks, batch.gt_masks):
            if p is None or crit is None or Y is None:
                continue
            mask = torch.isfinite(Y)
            lt = torch.zeros_like(mask) if lt is None else lt
            gt = torch.zeros_like(mask) if gt is None else gt
            parts[kind] = crit(p, torch.nan_to_num(Y), mask, w[:, 0], lt, gt)
        return parts

    def loss(self, batch: MABTrainingBatch) -> torch.Tensor:
        preds = self.model.train_step_preds(batch.bmg, batch.V_d, batch.E_d, batch.X_d,
                                            batch.constraints, is_training=True,
                                            generator=self.state.rng)
        return sum(self._losses(preds, batch).values())

    @torch.inference_mode()
    def _validate(self, loader, metrics: bool) -> dict[str, float]:
        sums: dict[str, float] = {}
        n = 0
        collected = {kind: [] for kind in HEADS}
        for host in loader:
            batch = host.to(self.device)
            preds = self.model.train_step_preds(batch.bmg, batch.V_d, batch.E_d, batch.X_d,
                                                batch.constraints, is_training=False)
            parts = self._losses(preds, batch)
            for kind, v in (("total", sum(parts.values())), *parts.items()):
                sums[kind] = sums.get(kind, 0.0) + float(v)
            n += 1
            if metrics:
                for kind, p, Y in zip(HEADS, preds, host.Ys):
                    if p is not None and Y is not None:
                        collected[kind].append((p.float().cpu(), Y))
        record = {"val_loss": sums.get("total", float("nan")) / max(n, 1)}
        for kind in HEADS:
            if kind in sums:
                record[f"val_loss-{kind}"] = sums[kind] / max(n, 1)
        for name, metric in self.val_metrics.items():
            _, _, kind = name.rpartition("-")
            if kind not in HEADS or not collected[kind]:
                continue
            p, Y = (torch.cat(parts) for parts in zip(*collected[kind]))
            if p.ndim == 3:
                p = p[..., 0]
            mask = torch.isfinite(Y)
            try:
                if metric.needs_collection:
                    value = metric.compute_from_arrays(p.numpy(), Y.numpy(), mask.numpy())
                else:
                    no_bounds = torch.zeros_like(mask)
                    value = metric.compute(metric.update_state(
                        metric.init_state(), p, torch.nan_to_num(Y), mask, torch.ones(len(Y)),
                        no_bounds, no_bounds))
                value = float(value)
            except Exception as e:  # a failed metric must not stop the fit
                logger.warning(f"val metric {name} failed: {e}")
                value = float("nan")
            record[f"val_{name}"] = value
        return record

    def evaluate(self, loader) -> float:
        return self._validate(loader, False)["val_loss"]

    @torch.inference_mode()
    def predict(self, loader, use_batch_statistics: bool = False) -> tuple:
        """``(mol, atom, bond)`` inference-space predictions over ``loader``
        from ``best_variables`` after a fit, the constraints of the batches
        applied."""
        if self.state is None:
            raise RuntimeError("fit or init_state first")
        gen = self._generator(0) if use_batch_statistics else None
        with self._best():
            return self._collect_heads(loader, lambda b: self.model(
                b.bmg, b.V_d, b.E_d, b.X_d, b.constraints, is_training=use_batch_statistics,
                generator=gen))

    @torch.inference_mode()
    def predict_mc_dropout(self, loader, sampling_size: int = 10, seed: int = 0) -> tuple:
        """``sampling_size`` Monte-Carlo-dropout passes: per head a
        ``[sampling_size, n, ...]`` stack (None for an absent head), the
        masks from one generator made from ``seed``."""
        if self.state is None:
            raise RuntimeError("fit or init_state first")
        gen = self._generator(seed)
        with self._best():
            samples = [self._collect_heads(loader, lambda b: self.model.mc_dropout_preds(
                b.bmg, b.V_d, b.E_d, b.X_d, b.constraints, gen)) for _ in range(sampling_size)]
        return tuple(None if samples[0][k] is None else np.stack([s[k] for s in samples])
                     for k in range(3))

    def _collect_heads(self, loader, apply) -> tuple:
        chunks = ([], [], [])
        for host in loader:
            preds = apply(host.to(self.device))
            collect_mab_rows(host, *(None if p is None else p.float().cpu().numpy()
                                     for p in preds), *chunks)
        return restore_mab_order(loader, *(np.concatenate(c, 0) if c else None for c in chunks))


def collect_mab_rows(batch, mol_p, atom_p, bond_p, mol_chunks, atom_chunks, bond_chunks):
    """Cut one host batch's per-head outputs to their real rows and append
    them to the lists (shared with ``fingerprint``): the real molecules'
    rows, every real atom's (a molecule without atoms has one zero node row),
    and each bond's primary edge (``e < rev[e]``) in the molecule's bond
    order (``edge_origin // 2``)."""
    bmg = batch.bmg
    if mol_p is not None:
        keep = (bmg.node_ptr[1:] > bmg.node_ptr[:-1])[: bmg.n_graphs].numpy()
        mol_chunks.append(np.asarray(mol_p)[keep])
    if atom_p is not None:
        atom_chunks.append(np.asarray(atom_p)[bmg.node_mask.numpy()])
    if bond_p is not None:
        primary = (np.arange(bmg.E.shape[0]) < bmg.rev.numpy()) & bmg.edge_mask.numpy()
        rows = np.asarray(bond_p)[primary]
        if batch.edge_origin is not None:
            rows = rows[np.argsort(np.asarray(batch.edge_origin)[primary] // 2, kind="stable")]
        bond_chunks.append(rows)


def restore_mab_order(loader, mol_cat, atom_cat, bond_cat):
    """The three tables concatenated over ``loader``'s batches, put back in
    dataset order where the loader's isolation of oversized molecules
    reordered them (``DataLoader.emitted_order``): the molecule rows one by
    one, the atom and bond rows in each molecule's group. An identity order,
    or none, leaves them as they are; under ``drop_last`` the emitted subset
    comes back in ascending dataset order."""
    order_fn = getattr(loader, "emitted_order", None)
    order = order_fn() if order_fn is not None else None
    if order is None or np.array_equal(order, np.arange(len(order))):
        return mol_cat, atom_cat, bond_cat
    data = loader.dataset.data
    if mol_cat is not None and len(mol_cat) == len(order):
        mol_cat = mol_cat[np.argsort(order, kind="stable")]
    if atom_cat is not None:  # a molecule without atoms has one zero node row
        atom_cat = _regroup_rows(atom_cat, order, [max(1, d.mol.num_atoms) for d in data])
    if bond_cat is not None:
        bond_cat = _regroup_rows(bond_cat, order, [d.mol.num_bonds for d in data])
    return mol_cat, atom_cat, bond_cat


def _regroup_rows(arr: np.ndarray, order: np.ndarray, counts: list[int]) -> np.ndarray:
    """``arr``'s groups of rows, emitted in ``order`` (dataset indices, a
    subset under ``drop_last``), in ascending dataset order; ``counts[i]`` is
    molecule ``i``'s group size. Where the emitted counts do not tile ``arr``
    it comes back as it is."""
    counts = np.asarray(counts, np.int64)
    emitted = counts[order]
    if arr.shape[0] != int(emitted.sum()):
        return arr
    starts = np.concatenate([[0], np.cumsum(emitted)])
    take = [np.arange(starts[p], starts[p] + emitted[p]) for p in np.argsort(order, kind="stable")]
    return arr[np.concatenate(take)] if take else arr
