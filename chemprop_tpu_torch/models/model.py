"""The MPNN: message passing -> aggregation -> [batch norm] -> predictor
(cf. ``chemprop_tpu/models/model.py``), with any of ``nn.predictors``'s
heads; each output keeps the head's trailing dimensions (``[n, t]``,
``[n, t, k]``). Gradients are on: a caller that only predicts wraps its calls
in ``torch.inference_mode()``."""

from __future__ import annotations

import torch
from torch import nn

from chemprop_tpu_torch.data.collate import BatchMolGraph
from chemprop_tpu_torch.nn.batchnorm import BatchNorm
from chemprop_tpu_torch.nn.message_passing import BondMessagePassing
from chemprop_tpu_torch.nn.metrics import ChempropMetric
from chemprop_tpu_torch.nn.predictors import _FFNPredictorBase
from chemprop_tpu_torch.nn.transforms import ScaleTransform


class MPNN(nn.Module):
    """``V_d`` are the ``[N_pad, d_vd]`` atom descriptors of a message passing
    with ``d_vd``; ``X_d`` the ``[n_graphs, d_xd]`` molecule descriptors,
    scaled at evaluation by ``X_d_transform`` and concatenated to the
    fingerprint after the batch norm, in float32 as in the JAX package."""

    def __init__(
        self,
        message_passing: BondMessagePassing,
        agg: nn.Module,
        predictor: _FFNPredictorBase,
        batch_norm: bool = False,
        X_d_transform: ScaleTransform | None = None,
    ):
        super().__init__()
        self.message_passing = message_passing
        self.agg = agg
        self.predictor = predictor
        self.bn = BatchNorm(message_passing.output_dim) if batch_norm else None
        self.X_d_transform = X_d_transform

    @property
    def criterion(self) -> ChempropMetric:
        return self.predictor.get_criterion()

    @property
    def n_targets(self) -> int:
        return self.predictor.n_targets

    def fingerprint(
        self, bmg: BatchMolGraph, V_d: torch.Tensor | None = None, X_d: torch.Tensor | None = None,
        is_training: bool = False, mc_dropout: bool = False,
        generator: torch.Generator | None = None, taps: dict | None = None,
    ) -> torch.Tensor:
        """``[n_graphs, output_dim (+ d_xd)]`` float32 graph fingerprints;
        ``is_training`` normalises with the batch's own statistics over the
        real graphs and turns dropout on, ``mc_dropout`` turns only dropout
        on; the masks are drawn from ``generator``. ``taps`` collects the
        message passing's activations (``BondMessagePassing.forward``)."""
        mp = self.message_passing
        H_v = mp(bmg, V_d, is_training, mc_dropout, generator, taps)
        # the readouts accumulate in f32; the lane padding is cut at graph level
        H = self.agg(H_v, bmg).float()[:, : mp.output_dim]
        if self.bn is not None:
            # real graphs have at least one node
            mask = (bmg.node_ptr[1:] > bmg.node_ptr[:-1])[: bmg.n_graphs]
            H = self.bn(H, mask, is_training)
        if X_d is None:
            return H
        if self.X_d_transform is not None:
            X_d = self.X_d_transform(X_d, is_training)
        return torch.cat([H, X_d], dim=1)

    def forward(
        self, bmg: BatchMolGraph, V_d: torch.Tensor | None = None, X_d: torch.Tensor | None = None,
        is_training: bool = False, generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Inference-space predictions ``[n_graphs, n_tasks(, k)]``; with
        ``is_training`` (batch statistics, dropout) the output is not unscaled."""
        Z = self.fingerprint(bmg, V_d, X_d, is_training, generator=generator)
        return self.predictor(Z, is_training, generator)

    def mc_dropout_preds(
        self, bmg: BatchMolGraph, V_d: torch.Tensor | None = None, X_d: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """One Monte-Carlo-dropout sample of the inference-space predictions:
        the dropout layers on, batch norm and the unscaling as in inference."""
        Z = self.fingerprint(bmg, V_d, X_d, False, mc_dropout=True, generator=generator)
        return self.predictor.mc_step(Z, generator)

    def train_step_preds(
        self, bmg: BatchMolGraph, V_d: torch.Tensor | None = None, X_d: torch.Tensor | None = None,
        is_training: bool = True, generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Criterion-space predictions."""
        Z = self.fingerprint(bmg, V_d, X_d, is_training, generator=generator)
        return self.predictor.train_step(Z, is_training, generator)

    def val_step_preds(
        self, bmg: BatchMolGraph, V_d: torch.Tensor | None = None, X_d: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Validation-metric predictions: evaluation statistics, no unscaling."""
        return self.predictor.val_step(self.fingerprint(bmg, V_d, X_d, False))
