"""``MolAtomBondMPNN``: up to three heads, over molecules, atoms and bonds,
on one MAB message passing (cf. ``chemprop_tpu/models/mol_atom_bond.py``),
with the JAX package's adaptations to padded batches:

* a bond's fingerprint is ``[H_e ; H_e[rev]]`` on each directed edge, and
  its prediction the mean over the pair, ``(p + p[rev]) / 2``;
* the bond constrainer runs over directed edges with doubled constraints
  (each bond is counted twice), the same sums as per bond;
* ``atom_constrainer`` / ``bond_constrainer`` (``nn.ffn.ConstrainerFFN``)
  move the point predictions (channel 0 of a head with several outputs per
  task) so that each molecule's sum meets its constraint.

With ``batch_norm`` each head's fingerprint has its own batch norm
(``bn_mol``, ``bn_atom``, ``bn_bond``) over the real rows. Gradients are on:
a caller that only predicts wraps its calls in ``torch.inference_mode()``."""

from __future__ import annotations

import torch
from torch import nn

from chemprop_tpu_torch.data.collate import BatchMolGraph
from chemprop_tpu_torch.nn.batchnorm import BatchNorm
from chemprop_tpu_torch.nn.ffn import ConstrainerFFN
from chemprop_tpu_torch.nn.message_passing.mol_atom_bond import (
    MABAtomMessagePassing, MABBondMessagePassing,
)
from chemprop_tpu_torch.nn.predictors import _FFNPredictorBase
from chemprop_tpu_torch.nn.transforms import ScaleTransform

KINDS = ("mol", "atom", "bond")


class MolAtomBondMPNN(nn.Module):
    def __init__(
        self,
        message_passing: MABBondMessagePassing | MABAtomMessagePassing,
        agg: nn.Module | None = None,
        mol_predictor: _FFNPredictorBase | None = None,
        atom_predictor: _FFNPredictorBase | None = None,
        bond_predictor: _FFNPredictorBase | None = None,
        atom_constrainer: ConstrainerFFN | None = None,
        bond_constrainer: ConstrainerFFN | None = None,
        batch_norm: bool = False,
        X_d_transform: ScaleTransform | None = None,
    ):
        super().__init__()
        self.message_passing, self.agg = message_passing, agg
        self.mol_predictor, self.atom_predictor = mol_predictor, atom_predictor
        self.bond_predictor = bond_predictor
        self.atom_constrainer, self.bond_constrainer = atom_constrainer, bond_constrainer
        self.batch_norm = batch_norm
        d_v, d_e = message_passing.output_dims
        for kind, head, width in zip(KINDS, self.predictors, (d_v, d_v, d_e)):
            setattr(self, f"bn_{kind}",
                    BatchNorm(width) if batch_norm and head is not None else None)
        self.X_d_transform = X_d_transform

    @property
    def predictors(self) -> tuple:
        return (self.mol_predictor, self.atom_predictor, self.bond_predictor)

    def criterions(self) -> tuple:
        return tuple(None if p is None else p.get_criterion() for p in self.predictors)

    def fingerprint(
        self, bmg: BatchMolGraph, V_d: torch.Tensor | None = None,
        E_d: torch.Tensor | None = None, X_d: torch.Tensor | None = None,
        is_training: bool = False, mc_dropout: bool = False,
        generator: torch.Generator | None = None, taps: dict | None = None,
    ) -> tuple:
        """``(H_g [n_graphs, .], H_v [N_pad, .], H_e [E_pad, 2 .])`` float32
        at their real widths (None where there is no such embedding or no
        readout): the graph fingerprints with ``X_d`` after the batch norm,
        the node embeddings, and each directed edge's with its reverse's."""
        mp = self.message_passing
        H_v, H_e = mp(bmg, V_d, E_d, is_training, mc_dropout, generator, taps)
        d_v, d_e = mp.output_dims
        H_g = None
        if H_v is not None:
            if self.agg is not None:
                H_g = self.agg(H_v, bmg).float()[:, :d_v]
            H_v = H_v[:, :d_v]
        if H_e is not None:
            H_e = H_e[:, :d_e]
        if self.batch_norm:
            if H_g is not None and self.bn_mol is not None:
                # real graphs have at least one node
                H_g = self.bn_mol(H_g, (bmg.node_ptr[1:] > bmg.node_ptr[:-1])[: bmg.n_graphs],
                                  is_training)
            if H_v is not None and self.bn_atom is not None:
                H_v = self.bn_atom(H_v, bmg.node_mask, is_training)
            if H_e is not None and self.bn_bond is not None:
                H_e = self.bn_bond(H_e, bmg.edge_mask, is_training)
        if H_g is not None and X_d is not None:
            if self.X_d_transform is not None:
                X_d = self.X_d_transform(X_d, is_training)
            H_g = torch.cat([H_g, X_d], dim=1)
        if H_e is not None:
            H_e = torch.cat([H_e, H_e[bmg.rev.long()]], dim=1)
        return H_g, H_v, H_e

    def _headwise(self, fps, bmg, constraints, is_training: bool, mode: str, generator):
        """Each head on its fingerprint (``mode``: ``predict``, ``train`` for
        the criterion's space, ``mc`` for Monte-Carlo dropout), bond
        predictions averaged over the direction pair, then the
        constrainers."""
        outs = []
        for kind, fp, head in zip(KINDS, fps, self.predictors):
            if head is None or fp is None:
                outs.append(None)
                continue
            if mode == "mc":
                preds = head.mc_step(fp, generator)
            elif mode == "train":
                preds = head.train_step(fp, is_training, generator)
            else:
                preds = head(fp, is_training, generator)
            if kind == "bond":
                preds = (preds + preds[bmg.rev.long()]) / 2
            outs.append(preds)
        if constraints is not None:
            atom_c, bond_c = constraints
            for k, constrainer, fp, c, batch in (
                    (1, self.atom_constrainer, fps[1], atom_c, bmg.batch),
                    (2, self.bond_constrainer, fps[2], bond_c, bmg.batch[bmg.src.long()])):
                if constrainer is None or c is None or outs[k] is None:
                    continue
                preds = outs[k]
                point = preds[..., 0] if preds.ndim == 3 else preds
                # directed edges count each bond twice: so do the constraints
                fixed = constrainer(fp, point, batch, c if k == 1 else 2 * c, is_training,
                                    generator)
                if preds.ndim == 3:
                    preds = preds.clone()
                    preds[..., 0] = fixed
                    outs[k] = preds
                else:
                    outs[k] = fixed
        return tuple(outs)

    def forward(
        self, bmg: BatchMolGraph, V_d=None, E_d=None, X_d=None, constraints=None,
        is_training: bool = False, generator: torch.Generator | None = None,
    ) -> tuple:
        """Inference-space ``(mol [n_graphs, ...], atom [N_pad, ...], bond
        [E_pad, ...])`` predictions, None for an absent head."""
        fps = self.fingerprint(bmg, V_d, E_d, X_d, is_training, generator=generator)
        return self._headwise(fps, bmg, constraints, is_training, "predict", generator)

    def train_step_preds(
        self, bmg: BatchMolGraph, V_d=None, E_d=None, X_d=None, constraints=None,
        is_training: bool = True, generator: torch.Generator | None = None,
    ) -> tuple:
        """Criterion-space predictions of the three heads."""
        fps = self.fingerprint(bmg, V_d, E_d, X_d, is_training, generator=generator)
        return self._headwise(fps, bmg, constraints, is_training, "train", generator)

    def mc_dropout_preds(
        self, bmg: BatchMolGraph, V_d=None, E_d=None, X_d=None, constraints=None,
        generator: torch.Generator | None = None,
    ) -> tuple:
        """One Monte-Carlo-dropout sample of the inference-space predictions:
        the dropout layers on, all else as in inference."""
        fps = self.fingerprint(bmg, V_d, E_d, X_d, False, mc_dropout=True, generator=generator)
        return self._headwise(fps, bmg, constraints, False, "mc", generator)

    def encoding(
        self, bmg: BatchMolGraph, V_d=None, E_d=None, X_d=None, i: int = -1,
        is_training: bool = False,
    ) -> tuple:
        """Each head's fingerprint through its FFN's blocks ``[:i]``."""
        fps = self.fingerprint(bmg, V_d, E_d, X_d, is_training)
        return tuple(None if p is None or fp is None else p.encode(fp, i, is_training)
                     for fp, p in zip(fps, self.predictors))
