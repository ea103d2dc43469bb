"""Multicomponent message passing (cf.
``chemprop_tpu/nn/message_passing/multi.py``): one block per input component,
or one ``shared`` block that runs over every component. Each block is a
``BondMessagePassing`` or an ``AtomMessagePassing`` and runs over its own
component's graph, its tile table (or its split table with the row lists
of every tile kernel) included, so the kernels see one component at a
time. A shared block's weights take one gradient contribution from each
component in a step. Parameter names are the reference's,
``blocks.<i>.W_i.weight`` and so on, so a reference state dict loads as it
is."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from chemprop_tpu_torch.data.collate import BatchMolGraph


class MulticomponentMessagePassing(nn.Module):
    def __init__(self, blocks: Sequence[nn.Module], n_components: int, shared: bool = False):
        super().__init__()
        if len(blocks) == 0:
            raise ValueError("arg 'blocks' was empty!")
        if shared and len(blocks) > 1:
            raise ValueError("only one block may be given when 'shared' is True")
        if not shared and len(blocks) != n_components:
            raise ValueError(f"expected {n_components} blocks, got {len(blocks)}")
        self.blocks = nn.ModuleList(blocks)
        self.n_components = n_components
        self.shared = shared

    @property
    def output_dim(self) -> int:
        if self.shared:
            return self.blocks[0].output_dim * self.n_components
        return sum(b.output_dim for b in self.blocks)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.blocks[0].compute_dtype

    def components(self) -> list[nn.Module]:
        """The block that runs over each component, in component order."""
        return [self.blocks[0 if self.shared else i] for i in range(self.n_components)]

    def forward(
        self, bmgs: Sequence[BatchMolGraph], V_ds: Sequence[torch.Tensor | None] | None = None,
        is_training: bool = False, mc_dropout: bool = False,
        generator: torch.Generator | None = None, taps: dict | None = None,
    ) -> list[torch.Tensor]:
        """Each component's node table (``BondMessagePassing.forward``), its
        block's output width lane-padded; the dropout masks of all components
        come from ``generator`` in component order, and ``taps`` collects
        each component's activations in that order."""
        if len(bmgs) != self.n_components:
            raise ValueError(f"expected {self.n_components} component graphs, got {len(bmgs)}")
        V_ds = [None] * len(bmgs) if V_ds is None else V_ds
        return [block(bmg, V_d, is_training, mc_dropout, generator, taps)
                for block, bmg, V_d in zip(self.components(), bmgs, V_ds)]
