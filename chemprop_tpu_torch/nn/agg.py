"""Node->graph readouts (cf. ``chemprop_tpu/nn/agg.py``). Padding nodes
belong to the sacrificial graph ``n_graphs``, so every reduction runs over
``n_graphs + 1`` segments and drops the last one; the sums are the sorted
segment sum kernel over ``bmg.node_ptr``, accumulated in f32. As in the JAX
package, the sum and norm readouts round that sum once to ``H``'s dtype and
divide in it; the mean readout keeps f32 totals and counts."""

from __future__ import annotations

import torch
from torch import nn

from chemprop_tpu_torch.data.collate import BatchMolGraph
from chemprop_tpu_torch.ops.segment import sorted_segment_sum, sorted_segment_sum_counts
from chemprop_tpu_torch.utils.registry import ClassRegistry


class SumAggregation(nn.Module):
    def __init__(self):  # no options (``Factory.build`` reads the signature)
        super().__init__()

    def forward(self, H: torch.Tensor, bmg: BatchMolGraph) -> torch.Tensor:
        return sorted_segment_sum(H, bmg.batch, bmg.node_ptr, H.dtype)[: bmg.n_graphs]


class MeanAggregation(nn.Module):
    def __init__(self):
        super().__init__()

    def forward(self, H: torch.Tensor, bmg: BatchMolGraph) -> torch.Tensor:
        totals, counts = sorted_segment_sum_counts(H, bmg.batch, bmg.node_ptr, torch.float32)
        return totals[: bmg.n_graphs] / counts[: bmg.n_graphs, None].clamp_min(1.0)


class NormAggregation(nn.Module):
    def __init__(self, norm: float = 100.0):
        super().__init__()
        self.norm = norm

    def forward(self, H: torch.Tensor, bmg: BatchMolGraph) -> torch.Tensor:
        sums = sorted_segment_sum(H, bmg.batch, bmg.node_ptr, H.dtype)
        return sums[: bmg.n_graphs] / self.norm


AGGREGATIONS = {
    "SumAggregation": SumAggregation,
    "MeanAggregation": MeanAggregation,
    "NormAggregation": NormAggregation,
}
# the command line's names (``--aggregation``); attentive aggregation is not
# ported yet
AggregationRegistry = ClassRegistry()
for _alias, _cls in (("sum", SumAggregation), ("mean", MeanAggregation),
                     ("norm", NormAggregation)):
    AggregationRegistry.register(_alias)(_cls)
