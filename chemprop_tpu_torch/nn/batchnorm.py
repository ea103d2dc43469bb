"""Padding-aware batch normalisation of the graph fingerprints (cf.
``chemprop_tpu/nn/batchnorm.py``). In training the moments are taken over the
real rows only (``mask``), the biased variance normalises and the unbiased
one goes into the running variance, with ``torch.nn.BatchNorm1d``'s momentum
0.1 (flax's 0.9); in evaluation the running statistics normalise every row.
Buffer and parameter names are ``torch.nn.BatchNorm1d``'s, so a reference
state dict loads as it is.

With ``mesh`` set (a ``parallel.sharding.Mesh``; the JAX module's
``axis_name``) the training moments ``n``, ``s`` and ``v`` are summed over
the mesh's process group, so that every rank normalises with the global
batch's statistics and sharded training equals single-device training. The
sum is differentiable: its backward sums the cotangents over the group too,
as a ``psum`` transposes in the JAX package."""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.mesh = None  # a parallel.sharding.Mesh to sum the moments over

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor | None = None, is_training: bool = False
    ) -> torch.Tensor:
        if is_training:
            w = x.new_ones((x.shape[0], 1)) if mask is None else mask.reshape(-1, 1).to(x.dtype)
            n, s = w.sum(), (x * w).sum(0)
            if self.mesh is not None:
                n, s = group_sum(n, self.mesh), group_sum(s, self.mesh)
            n = n.clamp_min(1.0)
            mean = s / n
            v = ((x - mean).square() * w).sum(0)
            if self.mesh is not None:
                v = group_sum(v, self.mesh)
            var = v / n
            if torch.is_grad_enabled():  # a training step, not a prediction with batch statistics
                with torch.no_grad():
                    m = self.momentum
                    unbiased = var * n / (n - 1).clamp_min(1.0)
                    self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                    self.running_var.mul_(1 - m).add_(unbiased, alpha=m)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def group_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's process group (its ``psum``),
    differentiable: the backward sums the cotangents over the group."""
    return _GroupSum.apply(x, mesh.group)
