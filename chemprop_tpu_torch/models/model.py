"""The MPNN: message passing -> aggregation -> [batch norm] -> predictor
(cf. ``chemprop_tpu/models/model.py``), inference only."""

from __future__ import annotations

import torch
from torch import nn

from chemprop_tpu_torch.data.collate import BatchMolGraph
from chemprop_tpu_torch.nn.batchnorm import BatchNorm
from chemprop_tpu_torch.nn.message_passing import BondMessagePassing
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

    @torch.no_grad()
    def fingerprint(self, bmg: BatchMolGraph) -> torch.Tensor:
        """``[n_graphs, d_h]`` float32 graph fingerprints."""
        H_v = self.message_passing(bmg)
        # the readouts accumulate in f32; the lane padding is cut at graph level
        H = self.agg(H_v, bmg).float()[:, : self.message_passing.output_dim]
        return H if self.bn is None else self.bn(H)

    @torch.no_grad()
    def forward(self, bmg: BatchMolGraph) -> torch.Tensor:
        """Inference-space predictions ``[n_graphs, n_tasks]``."""
        return self.predictor(self.fingerprint(bmg))
