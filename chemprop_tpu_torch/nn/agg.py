"""Node->graph readouts (cf. ``chemprop_tpu/nn/agg.py``). Padding nodes
belong to the sacrificial graph ``n_graphs``, so every reduction runs over
``n_graphs + 1`` segments and drops the last one; the sums are the sorted
segment sum kernel over ``bmg.node_ptr``, accumulated in f32. As in the JAX
package, the sum and norm readouts round that sum once to ``H``'s dtype and
divide in it; the mean readout keeps f32 totals and counts.

The attentive readout weighs each node by a softmax, within its graph, of
the logits ``W(H)``; as flax's ``nn.Dense(1)`` promotes a bfloat16 ``H``
with its float32 parameters, the logits, the weights and the weighted sum are
float32. The node table arrives lane-padded (``models/model.py`` cuts the
padding columns after the readout), so ``W`` reads only the first
``output_size`` columns; the weighted sum over all of them is kernel C over
the node pointers, and the padding columns are cut with the others."""

from __future__ import annotations

import torch
from torch import nn

from chemprop_tpu_torch.data.collate import BatchMolGraph
from chemprop_tpu_torch.ops.segment import (
    segment_softmax_weights, sorted_segment_sum, sorted_segment_sum_counts,
)
from chemprop_tpu_torch.utils.registry import ClassRegistry


class Aggregation(nn.Module):
    """The base of the readouts (the JAX package's ``Aggregation``):
    ``forward(H, bmg)`` reduces the ``[N_pad, d]`` node table to
    ``[n_graphs, d]``."""

    def forward(self, H: torch.Tensor, bmg: BatchMolGraph) -> torch.Tensor:
        raise NotImplementedError


class SumAggregation(Aggregation):
    def __init__(self):  # no options (``Factory.build`` reads the signature)
        super().__init__()

    def forward(self, H: torch.Tensor, bmg: BatchMolGraph) -> torch.Tensor:
        return sorted_segment_sum(H, bmg.batch, bmg.node_ptr, H.dtype)[: bmg.n_graphs]


class MeanAggregation(Aggregation):
    def __init__(self):
        super().__init__()

    def forward(self, H: torch.Tensor, bmg: BatchMolGraph) -> torch.Tensor:
        totals, counts = sorted_segment_sum_counts(H, bmg.batch, bmg.node_ptr, torch.float32)
        return totals[: bmg.n_graphs] / counts[: bmg.n_graphs, None].clamp_min(1.0)


class NormAggregation(Aggregation):
    def __init__(self, norm: float = 100.0):
        super().__init__()
        self.norm = norm

    def forward(self, H: torch.Tensor, bmg: BatchMolGraph) -> torch.Tensor:
        sums = sorted_segment_sum(H, bmg.batch, bmg.node_ptr, H.dtype)
        return sums[: bmg.n_graphs] / self.norm


class AttentiveAggregation(Aggregation):
    """``sum_v softmax_g(W(H))_v H_v`` over each graph's nodes; ``W`` is
    ``Linear(output_size, 1)``, the JAX package's ``W`` (a dense kernel of
    ``output_size`` x 1 and its bias)."""

    def __init__(self, output_size: int = 300):
        super().__init__()
        self.output_size = output_size
        self.W = nn.Linear(output_size, 1)

    def forward(self, H: torch.Tensor, bmg: BatchMolGraph) -> torch.Tensor:
        logits = self.W(H[:, : self.output_size].float())
        alphas = segment_softmax_weights(logits, bmg.batch, bmg.n_graphs + 1)
        return sorted_segment_sum(alphas * H, bmg.batch, bmg.node_ptr)[: bmg.n_graphs]


AGGREGATIONS = {
    "SumAggregation": SumAggregation,
    "MeanAggregation": MeanAggregation,
    "NormAggregation": NormAggregation,
    "AttentiveAggregation": AttentiveAggregation,
}
# the command line's names (``--aggregation``)
AggregationRegistry = ClassRegistry()
for _alias, _cls in (("sum", SumAggregation), ("mean", MeanAggregation),
                     ("norm", NormAggregation), ("attentive", AttentiveAggregation)):
    AggregationRegistry.register(_alias)(_cls)
