"""Is the port complete? Every public top-level function and class of every
module of the JAX package (``chemprop_tpu/**/*.py``) has a counterpart in
the port (``chemprop_tpu_torch/``): the same name defined or assigned at the
top level of one of its modules, or an entry of ``RENAMED`` (the port's
function or class of another name, which must exist) or of ``NOT_PORTED``
(why the port has no such name: a TPU gate, a flax or JAX pytree helper, or
a divergence that ``ROADMAP.md`` section 3 names). A second check fails on
an entry whose JAX name no longer exists, or that the port now defines under
that name, so that the tables cannot go stale. The test reads both packages
with ``ast`` and imports neither."""

from __future__ import annotations

import ast
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = REPO / "chemprop_tpu", REPO / "chemprop_tpu_torch"

# JAX name -> the port's counterpart under another name, as
# "module path relative to chemprop_tpu_torch/:name"
RENAMED = {
    # the Pallas entry points -> the wrappers of the hand-written kernels
    "fused_message": "ops/message.py:message",
    "fused_message_iter": "ops/message.py:message_iter",
    "fused_first_iter": "ops/message.py:first_iter",
    "fused_depth_loop": "ops/message.py:depth_loop",
    "fused_iter_readout": "ops/message.py:loop_readout",
    "fused_loop_readout": "ops/message.py:loop_readout",
    "window_gather": "ops/gather.py:row_gather",
    "segment_sum": "ops/segment.py:sorted_segment_sum",
    "segment_mean": "ops/segment.py:sorted_segment_sum_counts",
    # the message's transpose: kernel F forms G = (S - R)^T gz without the
    # gather at dst whose transpose JAX's fallback makes a segment sum
    "gather_dst": "ops/message.py:bwd_message",
    # the reference-checkpoint converter -> the port's loader (the port's
    # modules carry the reference's parameter names, so a state dict loads
    # as it is)
    "load_torch_checkpoint": "models/load.py:load_checkpoint",
    "convert_state_dict": "models/load.py:build_model",
    "convert_model": "models/load.py:load_model",
    "convert_v1_model": "models/load.py:build_v1_model",
    "module_config": "models/serialize.py:model_config",
    "module_from_config": "models/serialize.py:model_from_config",
    # flax initialisers chosen by a context variable -> one function that
    # initialises a built model's parameters by scheme
    "init_scheme": "nn/init.py:init_parameters",
    "current_scheme": "nn/init.py:init_parameters",
    "kernel_init": "nn/init.py:init_parameters",
    "bias_init": "nn/init.py:init_parameters",
    # the host-side Noam rate: the port's step reads it on the host anyway
    "noam_lr_host": "train/schedulers.py:noam_lr",
    # JAX stacks every rank's shard into one batch with a leading shard axis;
    # each rank of the port collates its own shard
    "stack_shards": "data/collate.py:collate_sharded",
}

_VMEM = ("a TPU VMEM gate; the CUDA kernels read the CSR pointers and the tile table, "
         "and a batch they cannot serve is counted in ops.UNSERVED")
# JAX name -> why the port has no counterpart
NOT_PORTED = {
    "iter_usable": _VMEM,
    "iter2_usable": _VMEM,
    "nodes_window_ok": _VMEM,
    "expand_window_ok": _VMEM,
    "grad_weight_usable": _VMEM,
    "PaddedDense": ("a flax Dense that pads its kernel to the TPU's lanes at apply time; the "
                    "port's modules hold padded widths themselves (BondMessagePassing.d_pad)"),
    "jax_tree_stack": "a JAX pytree helper of stack_shards",
    "native_available": ("a probe that lets the JAX package fall back to Python featurisation; "
                         "the port builds its featurizer at first use and raises where it "
                         "cannot, as no fallback hides a failed build (ops/build.py)"),
}


def _public_defs(tree: ast.Module) -> set[str]:
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _top_level_names(tree: ast.Module) -> set[str]:
    """Names a module defines or assigns at its top level (not its imports)."""
    names = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
    return names


def _modules(root: Path) -> dict[Path, ast.Module]:
    return {p: ast.parse(p.read_text(), str(p)) for p in sorted(root.rglob("*.py"))}


JAX_MODULES = _modules(JAX)
PORT_MODULES = _modules(PORT)
JAX_NAMES = {name: p.relative_to(REPO) for p, tree in JAX_MODULES.items()
             for name in _public_defs(tree)}
PORT_NAMES = {name for tree in PORT_MODULES.values() for name in _top_level_names(tree)}


def test_every_public_jax_name_has_a_counterpart():
    missing = {name: str(where) for name, where in sorted(JAX_NAMES.items())
               if name not in PORT_NAMES and name not in RENAMED and name not in NOT_PORTED}
    assert not missing, f"JAX names without a counterpart in the port: {missing}"
    for name, target in RENAMED.items():
        module, port_name = target.split(":")
        assert port_name in _top_level_names(PORT_MODULES[PORT / module]), (name, target)
    assert all(reason and "not ported yet" not in reason for reason in NOT_PORTED.values())


def test_no_stale_entry():
    for table in (RENAMED, NOT_PORTED):
        for name in table:
            assert name in JAX_NAMES, f"{name} is no longer a public name of the JAX package"
            assert name not in PORT_NAMES, f"the port now has {name}: drop its entry"
    assert not set(RENAMED) & set(NOT_PORTED)
