"""Deployment export (cf. ``chemprop_tpu/models/export.py``): a model's
inference forward as a ``torch.export`` program in which the node and edge
counts are dynamic, saved and loaded as ``.pt2``.

    exported = export_forward(model, example_batch)       # on the model's device
    preds = exported(bmg, V_d, X_d)                       # any padding of n_graphs
    save_exported("model.pt2", exported)
    preds = load_exported("model.pt2")(bmg, V_d, X_d)

The JAX package turns its Pallas kernels off to export (``_no_pallas``):
they need concrete tile-aligned shapes. The port's kernels take their sizes
at run time and are ``torch.library`` ops (``chemprop_tpu_torch::message``,
``::fused_iter``, ``::fused_iter2``, ``::seg_sum``, ``::seg_sum_counts``,
``::row_gather``), so the exported graph holds them: on the card the program
launches the same kernels as the eager forward, and counts them in
``ops.LAUNCHES`` and ``ops.UNSERVED``; on the CPU it takes their plain
versions. A saved program loads in a process that has imported
``chemprop_tpu_torch.ops``, without the model classes.

The program takes the batch's pytree leaves (``data.collate.TENSOR_FIELDS``),
then ``V_d`` and ``X_d``. Its graph count is static, as in the JAX package:
the segment reductions size their outputs with it. The node and edge counts,
the table's length and each row list's length are ``torch.export.Dim``s
with ``dynamic``. The program takes the batch's table, a tile table or a
split table (a molecule of more than a tile's rows), in the ``split_ptr``
leaf with its row lists (``cross_rows`` for A, ``y1_rows`` and ``y2_rows``
for D), each always a tensor: empty for a tile table's lists, which no pass
needs, and for a batch with no table at all, so that one program serves
every form and launches the passes wherever the eager forward does. The
table and its lists are checked on the host once per call, at the entry, as
``BatchMolGraph.to`` checks them (a table that ``to`` moved is not read
back), and a split table without its lists raises there."""

from __future__ import annotations

import json
from dataclasses import replace
from pathlib import Path

import torch
import torch.utils._pytree as pytree
from torch import nn

from chemprop_tpu_torch.data.collate import ROW_LISTS, TENSOR_FIELDS, BatchMolGraph
from chemprop_tpu_torch.ops.message import check_cross, check_tiles, table_arg

META_FILE = "chemprop_tpu_torch.json"
# the leaves' first dimension: the node count, the edge count, the node
# count plus one (the CSR of dst), the table's length, each row list's
# length; node_ptr is static (n_graphs + 2)
_ROWS = {"V": "n", "batch": "n", "node_mask": "n", "E": "e", "src": "e", "dst": "e", "rev": "e",
         "edge_mask": "e", "edge_ptr": "n+1", "split_ptr": "t", "cross_rows": "cross_rows",
         "y1_rows": "y1_rows", "y2_rows": "y2_rows"}


def _normalized(bmg: BatchMolGraph) -> BatchMolGraph:
    """``bmg`` as the program takes it: its table (the tile table, else the
    split table, else an empty one) as ``split_ptr`` with its row lists,
    each checked (once, on its own device, unless ``BatchMolGraph.to``
    checked it; a split table without all its lists raises) or empty, and
    the padding flags read."""
    n = bmg.E.shape[0]
    table, lists = bmg.tile_ptr, {name: None for name in ROW_LISTS}
    if table is None and bmg.split_ptr is not None:
        table, lists = bmg.split_ptr, {name: getattr(bmg, name) for name in ROW_LISTS}
        if any(rows is None for rows in lists.values()):
            raise ValueError(f"a split tile table comes with its row lists {ROW_LISTS}")
    if table is not None:  # neither check reads back what BatchMolGraph.to checked
        check_tiles(table, n, table.device)
    for rows in lists.values():
        if rows is not None:
            check_cross(rows, n, rows.device)
    return replace(bmg, tile_ptr=None, split_ptr=table_arg(table, bmg.src),
                   **{name: table_arg(rows, bmg.src) for name, rows in lists.items()},
                   last_node_padding=bmg.last_node_is_padding(),
                   last_edge_padding=bmg.last_edge_is_padding())


def program_inputs(bmg: BatchMolGraph, V_d: torch.Tensor | None = None,
                   X_d: torch.Tensor | None = None) -> tuple:
    """The exported program's arguments for a batch: its leaves (a tuple),
    ``V_d`` and ``X_d``; and the batch's pytree spec."""
    leaves, spec = pytree.tree_flatten(_normalized(bmg))
    return (tuple(leaves), V_d, X_d), spec


class _Forward(nn.Module):
    """The traced function: the model's inference forward on the batch that
    the leaves make with ``spec``."""

    def __init__(self, model: nn.Module, spec: pytree.TreeSpec):
        super().__init__()
        self.model, self.spec = model, spec

    def forward(self, leaves: tuple, V_d: torch.Tensor | None, X_d: torch.Tensor | None):
        return self.model(pytree.tree_unflatten(list(leaves), self.spec), V_d, X_d)


class ExportedForward:
    """A model's exported inference forward: call it with a
    ``BatchMolGraph`` of the exported graph count (and ``V_d``, ``X_d`` where
    the model takes them). ``program`` is the ``torch.export.ExportedProgram``."""

    def __init__(self, program: torch.export.ExportedProgram, spec: pytree.TreeSpec):
        self.program, self.spec = program, spec
        self._module = program.module()

    def __call__(self, bmg: BatchMolGraph, V_d: torch.Tensor | None = None,
                 X_d: torch.Tensor | None = None) -> torch.Tensor:
        args, spec = program_inputs(bmg, V_d, X_d)
        if spec != self.spec:
            raise ValueError(
                f"the program was exported for (n_graphs, last node padding, last edge padding) "
                f"= {self.spec.context}, not {spec.context}")
        with torch.no_grad():
            return self._module(*args)

    call = __call__


def export_forward(model: nn.Module, example_batch, dynamic: bool = True) -> ExportedForward:
    """Export ``model``'s inference forward (``model(bmg, V_d, X_d)``) on
    ``example_batch`` (a ``TrainingBatch``: its ``bmg``, ``V_d``, ``X_d``), on
    the device where the model and the batch are. With ``dynamic`` the node
    and edge counts, the table's length and its lists' are symbolic: any
    padding of the same graph count, feature widths and extra inputs can be
    fed, with a tile table, a split table or neither."""
    bmg = example_batch.bmg
    if bmg.tile_ptr is None and bmg.split_ptr is None:
        raise ValueError("export from a batch with a tile table (or a split table): the traced "
                         "program serves batches without one, but it is traced with one")
    args, spec = program_inputs(bmg, example_batch.V_d, example_batch.X_d)
    V_d = example_batch.V_d
    shapes = None
    if dynamic:
        n, e = torch.export.Dim("n", min=2), torch.export.Dim("e", min=2)
        dims = {"n": n, "e": e, "n+1": n + 1, "t": torch.export.Dim("t", min=0),
                **{name: torch.export.Dim(name, min=0) for name in ROW_LISTS}}
        shapes = (tuple({0: dims[_ROWS[name]]} if name in _ROWS else None
                        for name in TENSOR_FIELDS),
                  None if V_d is None else {0: n}, None)
        # a list of fewer than two rows would fix its length in the trace:
        # the trace takes two placeholder rows there (the ops are opaque to
        # it, and the values are never read), and the program any length
        leaves = list(args[0])
        for name in ROW_LISTS:
            i = TENSOR_FIELDS.index(name)
            if leaves[i].numel() < 2:
                leaves[i] = leaves[i].new_zeros(2)
        args = (tuple(leaves), *args[1:])
    with torch.no_grad():
        program = torch.export.export(_Forward(model, spec), args, dynamic_shapes=shapes)
    return ExportedForward(program, spec)


def save_exported(path: str | Path, exported: ExportedForward) -> None:
    """``exported`` as a ``.pt2`` file, with the batch's pytree spec beside
    the program."""
    meta = {"spec": pytree.treespec_dumps(exported.spec)}
    torch.export.save(exported.program, str(path), extra_files={META_FILE: json.dumps(meta)})


def load_exported(path: str | Path) -> ExportedForward:
    """A ``.pt2`` file written by :func:`save_exported`, callable as
    ``(bmg, V_d, X_d) -> predictions`` without the model's classes."""
    extra = {META_FILE: ""}
    program = torch.export.load(str(path), extra_files=extra)
    return ExportedForward(program, pytree.treespec_loads(json.loads(extra[META_FILE])["spec"]))
