"""The multicomponent MPNN (cf. ``chemprop_tpu/models/multi.py``): each
component's node table is aggregated on its own, the fingerprints are
concatenated in component order, batch norm is masked by component 0's
graphs, and ``X_d`` joins after it. Every method takes a tuple of graphs,
one per component, where ``MPNN``'s takes one, and ``V_d`` as a tuple of the
components' atom descriptors (None where none has them)."""

from __future__ import annotations

from typing import Sequence

import torch

from chemprop_tpu_torch.data.collate import BatchMolGraph
from chemprop_tpu_torch.models.model import MPNN


class MulticomponentMPNN(MPNN):
    def fingerprint(
        self, bmg: Sequence[BatchMolGraph], V_d: Sequence[torch.Tensor | None] | None = None,
        X_d: torch.Tensor | None = None, is_training: bool = False, mc_dropout: bool = False,
        generator: torch.Generator | None = None, taps: dict | None = None,
    ) -> torch.Tensor:
        """``[n_graphs, output_dim (+ d_xd)]`` float32 fingerprints of the
        components' graphs ``bmg``, each cut to its block's output width."""
        mp = self.message_passing
        H_vs = mp(bmg, V_d, is_training, mc_dropout, generator, taps)
        H = torch.cat([self.agg(H_v, g).float()[:, : block.output_dim]
                       for H_v, g, block in zip(H_vs, bmg, mp.components())], dim=1)
        if self.bn is not None:
            g0 = bmg[0]
            mask = (g0.node_ptr[1:] > g0.node_ptr[:-1])[: g0.n_graphs]
            H = self.bn(H, mask, is_training)
        if X_d is None:
            return H
        if self.X_d_transform is not None:
            X_d = self.X_d_transform(X_d, is_training)
        return torch.cat([H, X_d], dim=1)
