"""The MPNN: message passing -> aggregation -> [batch norm] -> predictor
(cf. ``chemprop_tpu/models/model.py``). Gradients are on: a caller that only
predicts wraps its calls in ``torch.inference_mode()``."""

from __future__ import annotations

import torch
from torch import nn

from chemprop_tpu_torch.data.collate import BatchMolGraph
from chemprop_tpu_torch.nn.batchnorm import BatchNorm
from chemprop_tpu_torch.nn.message_passing import BondMessagePassing
from chemprop_tpu_torch.nn.metrics import ChempropMetric
from chemprop_tpu_torch.nn.predictors import RegressionFFN


class MPNN(nn.Module):
    def __init__(
        self,
        message_passing: BondMessagePassing,
        agg: nn.Module,
        predictor: RegressionFFN,
        batch_norm: bool = False,
    ):
        super().__init__()
        self.message_passing = message_passing
        self.agg = agg
        self.predictor = predictor
        self.bn = BatchNorm(message_passing.output_dim) if batch_norm else None

    @property
    def criterion(self) -> ChempropMetric:
        return self.predictor.get_criterion()

    def fingerprint(self, bmg: BatchMolGraph, is_training: bool = False) -> torch.Tensor:
        """``[n_graphs, d_h]`` float32 graph fingerprints; ``is_training``
        normalises with the batch's own statistics over the real graphs."""
        H_v = self.message_passing(bmg)
        # the readouts accumulate in f32; the lane padding is cut at graph level
        H = self.agg(H_v, bmg).float()[:, : self.message_passing.output_dim]
        if self.bn is None:
            return H
        # real graphs have at least one node
        mask = (bmg.node_ptr[1:] > bmg.node_ptr[:-1])[: bmg.n_graphs]
        return self.bn(H, mask, is_training)

    def forward(self, bmg: BatchMolGraph, is_training: bool = False) -> torch.Tensor:
        """Inference-space predictions ``[n_graphs, n_tasks]``; with
        ``is_training`` (batch statistics) the output is not unscaled."""
        Z = self.fingerprint(bmg, is_training)
        return self.predictor.train_step(Z) if is_training else self.predictor(Z)

    def train_step_preds(self, bmg: BatchMolGraph, is_training: bool = True) -> torch.Tensor:
        """Criterion-space predictions."""
        return self.predictor.train_step(self.fingerprint(bmg, is_training))

    def val_step_preds(self, bmg: BatchMolGraph) -> torch.Tensor:
        """Validation-metric predictions: evaluation statistics, no unscaling."""
        return self.predictor.val_step(self.fingerprint(bmg, False))
