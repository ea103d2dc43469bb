"""The opt-in kernels of the message-passing path, as explicit options.

The JAX package gates its opt-in kernels and routes by environment variables;
:meth:`KernelOptions.from_env` reads the same names, so that a user of both
packages finds the same switches. ``BondMessagePassing`` reads them once, at
construction, and hands the options down to the ops as an argument: no op
reads the environment itself.

==================  ============================  =======
option              environment variable          default
==================  ============================  =======
``iter2``           ``CHEMPROP_TPU_ITER2``        off
``fused_bwd``       ``CHEMPROP_TPU_FUSED_BWD``    off
``grad_w``          ``CHEMPROP_TPU_GRAD_W``       off
``fused_readout``   ``CHEMPROP_TPU_FUSED_READOUT``  on
``depth_loop``      ``CHEMPROP_TPU_DEPTH_LOOP``   off
``window_gather``   ``CHEMPROP_TPU_WINDOW_GATHER``  off
==================  ============================  =======
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class KernelOptions:
    #: the first two bfloat16 iterations of ``loop_readout`` as one
    #: ``fused_iter2`` launch (depth >= 3, and a batch whose molecules fit a tile)
    iter2: bool = False
    #: the backward of a bfloat16 ``message_iter`` as one ``iter_bwd`` call
    fused_bwd: bool = False
    #: the bfloat16 weight gradients ``x^T G`` by the ``grad_weight`` kernel
    #: instead of the library product
    grad_w: bool = False
    #: the whole depth loop and the readout as ``loop_readout`` where nothing
    #: needs the iterations' outputs; off: the per-iteration ops
    fused_readout: bool = True
    #: the whole ReLU depth loop as one differentiable op that returns the last
    #: H (``ops.depth_loop``; its backward carries the running dH0 in kernel
    #: F's accumulator), taken before ``loop_readout`` where no dropout is drawn
    depth_loop: bool = False
    #: W_i's bfloat16 input gather ``V[src]`` by the ``row_gather`` kernel
    window_gather: bool = False

    @classmethod
    def from_env(cls) -> "KernelOptions":
        def flag(name: str, default: str) -> bool:
            return os.environ.get(name, default) == "1"

        return cls(
            iter2=flag("CHEMPROP_TPU_ITER2", "0"),
            fused_bwd=flag("CHEMPROP_TPU_FUSED_BWD", "0"),
            grad_w=flag("CHEMPROP_TPU_GRAD_W", "0"),
            fused_readout=flag("CHEMPROP_TPU_FUSED_READOUT", "1"),
            depth_loop=flag("CHEMPROP_TPU_DEPTH_LOOP", "0"),
            window_gather=flag("CHEMPROP_TPU_WINDOW_GATHER", "0"),
        )
