"""Does the port take the JAX package's arguments? For every public
top-level function and every public class that both packages define under
one name (``tests/test_torch_coverage.py`` ties the names), the port's
parameters against the JAX package's, read with ``ast`` (neither package is
imported):

* a function, or a class's ``__init__``: the JAX parameters, less the
  JAX-only handles of ``JAX_ONLY``, are the first parameters of the port's
  in the same order, so that a call in the JAX package's form binds the same
  arguments in the port (the port may add its own after them: ``device``,
  ``shard_index``, ...);
* a dataclass or a ``NamedTuple`` (its fields, the bases' included): every
  JAX field, less those handles, is a field of the port's;
* ``REBUILT`` names each interface the port rebuilt around its CSR pointers
  and process groups, with the reason; its parameters are not held.

A second check fails on a stale entry: a handle no shared signature has, or
a rebuilt interface that now matches."""

from __future__ import annotations

import ast
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = REPO / "chemprop_tpu", REPO / "chemprop_tpu_torch"

# JAX parameter or field -> why the port has none: JAX-only handles
JAX_ONLY = {
    "variables": "flax's parameter tree; the port's modules hold their parameters",
    "tx": "an optax transformation; the port's trainer steps Adam itself",
    "axis": "a named mesh axis of shard_map; the port's ranks are a process group (Mesh)",
    "platforms": "jax.export's target platforms; torch.export traces for the tensors' device",
    "sort_edges": ("the JAX collate may leave edges unsorted for its TPU gates; the port's "
                   "kernels read the CSR of the sorted dst, so its batches are always sorted"),
    "data_sharding": ("a GSPMD sharding of the batch; each rank of the port collates its own "
                      "shard (collate_sharded)"),
    "opt_state": "optax's state; the port's TrainState holds Adam's moments as mu and nu",
}
# the collate-stamped TPU gates of the JAX package's BatchMolGraph: VMEM
# windows, where the CUDA kernels read the CSR pointers and the tile table
# (tests/test_torch_coverage.py:NOT_PORTED)
JAX_ONLY.update({gate: "a TPU gate of BatchMolGraph" for gate in (
    "edges_sorted", "fused_ok", "fused_window", "readout_ok", "edge_band", "agg_expand_ok")})

_CSR = ("rebuilt around the batch's CSR row pointers, which the CUDA kernels read in place of "
        "the TPU's segment ids and windows")
_GROUP = "rebuilt around a process group (parallel.sharding.Mesh) in place of shard_map"
# a shared name whose parameters the port rebuilt -> why
REBUILT = {
    "sorted_segment_sum": _CSR + " (ptr)",
    "sorted_segment_sum_counts": _CSR + " (ptr; the TPU's expand_w gate has no counterpart)",
    "gather_src": _CSR + " (src, edge_ptr)",
    "halo_message": _GROUP + ": the halo tables and the exchange (LocalExchange or "
                    "GroupExchange) in place of the padded shard arrays and the axis",
    "halo_node_accumulators": _GROUP + ", as halo_message",
    "make_sharded_train_step": _GROUP + ": the port's step is the trainer's own, so it takes "
                               "the trainer in place of the model, criterion and optax tx",
    "predict_MAB": ("the port's command line passes the loaded models and their output "
                    "columns in place of one flax module and its variables"),
}


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names[1:] if names and names[0] in ("self", "cls") else names


def _is_record(cls: ast.ClassDef) -> bool:
    """A dataclass or a NamedTuple."""
    dc = any("dataclass" in ast.unparse(d) for d in cls.decorator_list)
    return dc or any(ast.unparse(b).endswith("NamedTuple") for b in cls.bases)


def _signatures(root: Path) -> tuple[dict, dict]:
    """``(calls, records)``: public functions and explicit ``__init__``s by
    name -> [parameters per module]; public records by name -> fields, the
    bases' (by name, within the package) first."""
    classes, calls = {}, {}
    for path in sorted(root.rglob("*.py")):
        for node in ast.parse(path.read_text(), str(path)).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not node.name.startswith("_"):
                    calls.setdefault(node.name, []).append(_params(node))
            elif isinstance(node, ast.ClassDef):
                classes.setdefault(node.name, node)
                init = next((m for m in node.body if isinstance(m, ast.FunctionDef)
                             and m.name == "__init__"), None)
                if init is not None and not node.name.startswith("_"):
                    calls.setdefault(node.name, []).append(_params(init))

    def fields(cls: ast.ClassDef) -> list[str]:
        out = []
        for base in cls.bases:
            if isinstance(base, ast.Name) and base.id in classes:
                out += [f for f in fields(classes[base.id]) if f not in out]
        own = [m.target.id for m in cls.body if isinstance(m, ast.AnnAssign)
               and isinstance(m.target, ast.Name) and "ClassVar" not in ast.unparse(m.annotation)]
        return out + [f for f in own if f not in out]

    records = {name: fields(c) for name, c in classes.items()
               if not name.startswith("_") and _is_record(c)}
    return calls, records


JAX_CALLS, JAX_RECORDS = _signatures(JAX)
PORT_CALLS, PORT_RECORDS = _signatures(PORT)


def _held(names: list[str]) -> list[str]:
    return [n for n in names if n not in JAX_ONLY and not n.startswith("_")]


def test_shared_functions_take_the_jax_parameters():
    wrong = {}
    for name, jax_sigs in sorted(JAX_CALLS.items()):
        if name not in PORT_CALLS or name in REBUILT:
            continue
        for want in map(_held, jax_sigs):
            # a name defined in several modules: one of the port's must take it
            if not any(_held(got)[: len(want)] == want for got in PORT_CALLS[name]):
                wrong[name] = {"jax": want, "port": PORT_CALLS[name]}
    assert not wrong, f"the port does not take the JAX package's parameters: {wrong}"


def test_shared_records_have_the_jax_fields():
    wrong = {}
    for name, jax_fields in sorted(JAX_RECORDS.items()):
        if name not in PORT_RECORDS:
            continue
        missing = [f for f in _held(jax_fields) if f not in PORT_RECORDS[name]]
        if missing:
            wrong[name] = missing
    assert not wrong, f"fields the port lacks: {wrong}"


def test_no_stale_entry():
    shared_calls = [sig for name, sigs in JAX_CALLS.items() if name in PORT_CALLS
                    for sig in sigs]
    shared_fields = [f for name, fs in JAX_RECORDS.items() if name in PORT_RECORDS for f in fs]
    for handle in JAX_ONLY:
        assert any(handle in sig for sig in shared_calls) or handle in shared_fields, handle
    for name in REBUILT:
        assert name in JAX_CALLS and name in PORT_CALLS, name
        want = [_held(sig) for sig in JAX_CALLS[name]]
        assert not any(_held(got)[: len(w)] == w for w in want for got in PORT_CALLS[name]), (
            f"{name} now takes the JAX parameters: drop its entry")
    assert all(JAX_ONLY.values()) and all(REBUILT.values())
