"""Mol-atom-bond (MAB) message passing (cf.
``chemprop_tpu/nn/message_passing/mol_atom_bond.py``): the depth loop of bond
or atom message passing, whose last edge states ``H`` give both node and
edge embeddings::

    H_v = dropout(tau(W_vo([V ; M_v])))      M_v = sum_{e: dst_e = v} H_e
    H_v = dropout(W_vd([H_v ; V_d]))          (with atom descriptors)
    H_e = dropout(tau(W_eo([E ; H])))
    H_e = dropout(W_ed([H_e ; E_d]))          (with bond descriptors)

each cast to float32 after the compute-dtype layers, as in the JAX package.
Either is left out (None) with ``return_vertex_embeddings`` /
``return_edge_embeddings`` off, and so are its layers.

The depth loop is the single-molecule classes' own (``_edge_states``), with
their dispatch, but never ``ops.loop_readout``: the last ``H`` takes two
cotangents here, one through ``M_v`` and one from ``W_eo``, and
``loop_readout``'s backward kernels take the readout's alone. So bond message
passing with ReLU runs ``ops.first_iter`` then ``ops.message_iter`` (or with
``kernel_options.depth_loop`` and no dropout drawn ``ops.depth_loop``), then
``M_v`` by ``sorted_segment_sum``, as the JAX package's MAB dispatch does;
each of those ops takes any cotangent on its output. The hidden width is
lane-padded in both classes (the JAX package pads only the bond class's;
zero weight columns, so the real columns are JAX's), and the output layers
read the real columns of the padded tables. Both embeddings come out at
their lane-padded widths; ``output_dims`` gives the real ones."""

from __future__ import annotations

import torch
from torch import nn

from chemprop_tpu_torch.data.collate import BatchMolGraph
from chemprop_tpu_torch.nn.message_passing.base import (
    AtomMessagePassing, BondMessagePassing, _sow,
)
from chemprop_tpu_torch.nn.transforms import ScaleTransform
from chemprop_tpu_torch.ops.segment import sorted_segment_sum


class _MABMessagePassing:
    """What the two MAB classes add to their single-molecule base: the
    output layers ``W_vo`` / ``W_vd`` and ``W_eo`` / ``W_ed`` under the
    reference's names, the bond descriptors' width ``d_ed`` and their
    ``E_d_transform``."""

    def __init__(self, *args, d_ed: int | None = None, return_vertex_embeddings: bool = True,
                 return_edge_embeddings: bool = True,
                 E_d_transform: ScaleTransform | None = None, **kwargs):
        # read by _output_layers, which the base's __init__ calls
        self.d_ed = d_ed or None
        self.return_vertex_embeddings = return_vertex_embeddings
        self.return_edge_embeddings = return_edge_embeddings
        super().__init__(*args, **kwargs)
        self.E_d_transform = E_d_transform

    def _output_layers(self) -> None:
        d_v, d_e, d_h = self.d_v, self.d_e, self.d_h
        if self.return_vertex_embeddings:
            self.W_vo = nn.Linear(d_v + d_h, d_h, bias=True)
            if self.d_vd:
                self.W_vd = nn.Linear(d_h + self.d_vd, d_h + self.d_vd, bias=True)
        if self.return_edge_embeddings:
            self.W_eo = nn.Linear(d_e + d_h, d_h, bias=True)
            if self.d_ed:
                self.W_ed = nn.Linear(d_h + self.d_ed, d_h + self.d_ed, bias=True)

    @property
    def output_dims(self) -> tuple[int | None, int | None]:
        """The real widths of the node and edge embeddings (None: left out)."""
        d_v = self.d_h + (self.d_vd or 0) if self.return_vertex_embeddings else None
        d_e = self.d_h + (self.d_ed or 0) if self.return_edge_embeddings else None
        return d_v, d_e

    def forward(
        self, bmg: BatchMolGraph, V_d: torch.Tensor | None = None,
        E_d: torch.Tensor | None = None, is_training: bool = False, mc_dropout: bool = False,
        generator: torch.Generator | None = None, taps: dict | None = None,
    ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
        """``(H_v [N_pad, .], H_e [E_pad, .])`` float32 at their lane-padded
        widths, columns past ``output_dims`` zero. ``V_d`` ``[N_pad, d_vd]``
        and ``E_d`` ``[E_pad, d_ed]`` (in the sorted edge order) are required
        with ``d_vd`` and ``d_ed``; dropout, the transforms and ``taps`` are
        as in ``BondMessagePassing.forward``."""
        if self.return_edge_embeddings and (E_d is None) != (self.d_ed is None):
            raise ValueError("E_d must be given exactly when d_ed is configured")
        bmg, drop_on = self._prologue(bmg, V_d, is_training, mc_dropout)
        H, _ = self._edge_states(bmg, drop_on, generator, taps, readout=False)
        dt, dp = self.compute_dtype, self.d_pad
        H_v = H_e = None
        if self.return_vertex_embeddings:
            M_v = sorted_segment_sum(H.contiguous(), bmg.dst, bmg.edge_ptr)
            _sow(taps, "M_v", M_v)
            H_v = self._node_output(bmg.V.to(dt), M_v, V_d, is_training, drop_on, generator,
                                    self.W_vo, getattr(self, "W_vd", None)).float()
        if self.return_edge_embeddings:
            # H's padding columns sit at the end of [E ; H]: zero kernel rows
            W_eo, b_eo = self._padded(self.W_eo, self.d_e + dp, dp)
            EH = torch.cat([bmg.E.to(dt), H], dim=1)
            H_e = self.drop(self.tau(EH @ W_eo + b_eo), drop_on, generator)
            if E_d is not None:
                H_e = self._descriptors(H_e, E_d, self.W_ed, self.E_d_transform, is_training,
                                        drop_on, generator)
            H_e = H_e.float()
        return H_v, H_e


class MABBondMessagePassing(_MABMessagePassing, BondMessagePassing):
    """Bond (D-MPNN) message passing with node and edge embeddings."""


class MABAtomMessagePassing(_MABMessagePassing, AtomMessagePassing):
    """Atom message passing with node and edge embeddings."""
