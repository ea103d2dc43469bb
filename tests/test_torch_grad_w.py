"""The ``grad_w`` option of the port against itself and against the JAX
package: with it on in bfloat16, W_i's input ``[V[src] ; E]`` is zero-padded
to 128 columns and its weight gradient goes through ``ops.grad_weight``
(the kernel on the card, its plain version here), as the JAX package routes
it with ``CHEMPROP_TPU_GRAD_W=1``. Small size: d_h = 64 (padded to 128), the
100 molecules of tests/data/regression/mol/mol.csv in batches of 32."""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from chemprop_tpu_torch.data import DataLoader
from chemprop_tpu_torch.nn import BondMessagePassing
from chemprop_tpu_torch.ops import KernelOptions
from test_torch_per_iteration import (  # noqa: F401  (fixtures)
    D_H,
    check_three_adam_steps,
    datasets,
    one_torch_thread,
)

BF16_ULP = 2.0**-7  # relative spacing of bfloat16
# the module, which the package's function of the same name hides
gw_module = importlib.import_module("chemprop_tpu_torch.ops.grad_weight")


@pytest.mark.parametrize("fused_readout", [True, False], ids=["default", "per_iteration"])
def test_w_i_gradient_with_grad_w_equals_the_one_without(datasets, monkeypatch, fused_readout):
    bmg = next(iter(DataLoader(datasets[1], batch_size=32))).bmg
    routed = []
    plain = gw_module.grad_weight

    def spy(X, G, use_kernel=False):
        routed.append((X.shape[1], use_kernel))
        return plain(X, G, use_kernel)

    monkeypatch.setattr(gw_module, "grad_weight", spy)
    c = torch.from_numpy(np.random.default_rng(0).standard_normal((bmg.V.shape[0], 128)))
    grads, outs = [], []
    for grad_w in (False, True):
        mp = BondMessagePassing(d_h=D_H, compute_dtype=torch.bfloat16, kernel_options=KernelOptions(
            grad_w=grad_w, fused_readout=fused_readout))
        torch.manual_seed(0)
        for p in mp.parameters():
            torch.nn.init.normal_(p, std=0.1)
        out = mp(bmg, is_training=True)
        outs.append(out)
        (g,) = torch.autograd.grad((out.float() * c.float()).sum(), [mp.W_i.weight])
        grads.append(g)
    # only W_i's product goes through matmul: its input padded from 86 columns
    assert routed == [(128, True)]
    # the zero columns change nothing forward; the gradient is the same sum of
    # exact bf16 products, rounded once to bf16 from f32 sums taken in
    # another order
    assert torch.equal(outs[0], outs[1])
    assert grads[1].shape == (D_H, 86)
    torch.testing.assert_close(grads[1], grads[0], rtol=BF16_ULP, atol=1e-6)


@pytest.mark.parametrize("fused_readout", [True, False], ids=["default", "per_iteration"])
def test_three_adam_steps_with_grad_w_match_jax(datasets, monkeypatch, fused_readout):
    """Three bfloat16 Adam steps against the JAX package's with
    ``CHEMPROP_TPU_GRAD_W=1``: its grad_weight kernel in interpret mode for
    W_i and W_h, the port's plain version for both."""
    monkeypatch.setenv("CHEMPROP_TPU_GRAD_W", "1")
    monkeypatch.setenv("CHEMPROP_TPU_FUSED_READOUT", "1" if fused_readout else "0")
    options = KernelOptions(grad_w=True, fused_readout=fused_readout)
    check_three_adam_steps(datasets, monkeypatch, {}, "bfloat16", options)
