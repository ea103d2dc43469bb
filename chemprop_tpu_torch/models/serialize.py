"""The JAX package's checkpoint format (cf. ``chemprop_tpu/models/serialize.py``),
read and written by the port, so that one file serves both packages:

    MAGIC (b"CPTPU001") | manifest length (8 bytes, little-endian) |
    manifest JSON | msgpack of the variables

The manifest (``{"model": ..., "extra": ...}``) describes the model by the
JAX modules' constructor arguments; the variables are the JAX package's flax
tree: ``params`` and ``batch_stats``, dense kernels in (in, out) layout, and
in a trainer's ``last.ckpt`` also ``opt_state`` (optax's Adam state),
``step`` and ``epoch``. The msgpack codec is the port's own
(:mod:`chemprop_tpu_torch.utils.msgpack_codec`). :func:`to_jax_params` is the
inverse of :func:`~chemprop_tpu_torch.models.load.from_jax_params`.

The port builds what it runs: a single-molecule ``MPNN`` with a
``BondMessagePassing`` or an ``AtomMessagePassing``, or a
``MulticomponentMPNN`` over a ``MulticomponentMessagePassing`` of such
blocks (the JAX manifest's ``blocks``, ``n_components`` and ``shared``), a
sum, mean, norm or
attentive readout and any of the JAX
package's heads, with its criterion (by ``__metric__`` and ``kwargs``),
``task_weights``, ``threshold``, ``n_classes`` and ``spectral_activation``;
or a ``MolAtomBondMPNN`` (``"model_cls": "MolAtomBondMPNN"``: a MAB message
passing with its ``d_ed``, ``return_vertex_embeddings`` /
``return_edge_embeddings`` and ``E_d_transform``, up to three such heads,
the constrainers, batch norm per head). A manifest that needs anything else
raises and names it, as ``load.build_model`` does for reference
checkpoints."""

from __future__ import annotations

import json
from dataclasses import fields
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from chemprop_tpu_torch.models.load import (
    HEADS, MAB_CONSTRAINERS, MAB_HEADS, MAB_MESSAGE_PASSINGS, MESSAGE_PASSINGS, feature_widths,
    from_jax_params, jax_path, mab_feature_widths,
)
from chemprop_tpu_torch.models.model import MPNN
from chemprop_tpu_torch.models.mol_atom_bond import MolAtomBondMPNN
from chemprop_tpu_torch.models.multi import MulticomponentMPNN
from chemprop_tpu_torch.nn.agg import AGGREGATIONS
from chemprop_tpu_torch.nn.ffn import ConstrainerFFN
from chemprop_tpu_torch.nn.message_passing import MulticomponentMessagePassing
from chemprop_tpu_torch.nn.metrics import ChempropMetric, LossFunctionRegistry, MetricRegistry
from chemprop_tpu_torch.nn.transforms import GraphTransform, ScaleTransform, UnscaleTransform
from chemprop_tpu_torch.ops.options import KernelOptions
from chemprop_tpu_torch.utils import msgpack_codec
from chemprop_tpu_torch.utils.device import resolve_device, use_full_float32

MAGIC = b"CPTPU001"
FORMAT = "chemprop_tpu.mpnn.v1"
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
METRICS = {cls.__name__: cls for cls in (*LossFunctionRegistry.values(), *MetricRegistry.values())}


# ------------------------------------------------------------------ manifest
def _encode_transform(t) -> dict | None:
    if t is None:
        return None
    if isinstance(t, GraphTransform):
        return {"__transform__": "graph", "V": _encode_transform(t.V_transform),
                "E": _encode_transform(t.E_transform)}
    kind = "unscale" if isinstance(t, UnscaleTransform) else "scale"
    return {"__transform__": kind, "mean": t.mean[0].tolist(), "scale": t.scale[0].tolist()}


def _decode_transform(v: dict | None):
    if v is None:
        return None
    kind = v["__transform__"]
    if kind == "graph":
        return GraphTransform(_decode_transform(v["V"]), _decode_transform(v["E"]))
    if kind == "unscale":
        t = UnscaleTransform(len(v["mean"]))
        t.mean.copy_(torch.tensor(v["mean"]).reshape(1, -1))
        t.scale.copy_(torch.tensor(v["scale"]).reshape(1, -1))
        return t
    return ScaleTransform(v["mean"], v["scale"])


def _encode_metric(m: ChempropMetric | None) -> dict | None:
    """A criterion as the JAX package writes it: its class name and the
    arguments of its constructor."""
    if m is None:
        return None
    kwargs = {}
    for f in fields(m):
        if f.init:
            v = getattr(m, f.name)
            kwargs[f.name] = np.asarray(v).tolist() if isinstance(v, (list, tuple, np.ndarray)) else v
    return {"__metric__": type(m).__name__, "kwargs": kwargs}


def _decode_metric(v: dict | None) -> ChempropMetric | None:
    return None if v is None else METRICS[v["__metric__"]](**v["kwargs"])


def _agg_config(agg) -> dict | None:
    if agg is None:
        return None
    cfg = {"cls": type(agg).__name__}
    for key in ("norm", "output_size"):
        if hasattr(agg, key):
            cfg[key] = getattr(agg, key)
    return cfg


def _head_config(pred) -> dict | None:
    if pred is None:
        return None
    head = {
        "cls": type(pred).__name__, "n_tasks": pred.n_tasks, "input_dim": pred.input_dim,
        "hidden_dim": pred.hidden_dim, "n_layers": pred.n_layers, "dropout": pred.dropout,
        "activation": pred.activation.lower(), "criterion": _encode_metric(pred.criterion),
        "task_weights": pred.task_weights, "threshold": pred.threshold,
        "output_transform": _encode_transform(pred.output_transform), "n_targets": pred.n_targets,
    }
    for key in ("n_classes", "spectral_activation"):
        if hasattr(pred, key):
            head[key] = getattr(pred, key)
    return head


def _constrainer_config(c: ConstrainerFFN | None) -> dict | None:
    if c is None:
        return None
    return {"cls": "ConstrainerFFN", "n_constraints": c.n_constraints, "fp_dim": c.fp_dim,
            "hidden_dim": c.hidden_dim, "n_layers": c.n_layers, "dropout": c.dropout,
            "activation": c.activation.lower()}


def _mab_config(model: MolAtomBondMPNN) -> dict:
    mp = model.message_passing
    return {
        "format": FORMAT,
        "model_cls": "MolAtomBondMPNN",
        "message_passing": {
            **_block_config(mp), "d_ed": mp.d_ed,
            "return_vertex_embeddings": mp.return_vertex_embeddings,
            "return_edge_embeddings": mp.return_edge_embeddings,
            "E_d_transform": _encode_transform(mp.E_d_transform)},
        "agg": _agg_config(model.agg),
        **{k: _head_config(getattr(model, k)) for k in MAB_HEADS},
        **{k: _constrainer_config(getattr(model, k)) for k in MAB_CONSTRAINERS},
        "batch_norm": model.batch_norm,
        "X_d_transform": _encode_transform(model.X_d_transform),
    }


def model_config(model: MPNN | MolAtomBondMPNN) -> dict:
    """The manifest's ``model`` entry for the port's ``model``: the JAX
    modules' constructor arguments, so that the JAX package rebuilds it."""
    if isinstance(model, MolAtomBondMPNN):
        return _mab_config(model)
    mp = model.message_passing
    agg_cfg, head = _agg_config(model.agg), _head_config(model.predictor)
    if isinstance(mp, MulticomponentMessagePassing):
        mp_cfg = {"cls": "MulticomponentMessagePassing",
                  "blocks": [{"__submodule__": _block_config(b)} for b in mp.blocks],
                  "n_components": mp.n_components, "shared": mp.shared}
    else:
        mp_cfg = _block_config(mp)
    return {
        "format": FORMAT,
        "model_cls": type(model).__name__,
        "message_passing": mp_cfg,
        "agg": agg_cfg,
        "predictor": head,
        "batch_norm": model.bn is not None,
        "X_d_transform": _encode_transform(model.X_d_transform),
    }


def _block_config(mp) -> dict:
    """A bond or atom message passing's constructor arguments."""
    return {
        "cls": type(mp).__name__, "d_h": mp.d_h, "bias": mp.W_i.bias is not None,
        "depth": mp.depth, "dropout": mp.dropout, "activation": mp.activation,
        "undirected": mp.undirected, "d_vd": mp.d_vd,
        "V_d_transform": _encode_transform(mp.V_d_transform),
        "graph_transform": _encode_transform(mp.graph_transform),
        "compute_dtype": DTYPE_NAMES[mp.compute_dtype],
    }


def _blocks(mp_cfg: Mapping) -> list[Mapping]:
    """The single-molecule message passings a manifest's entry holds."""
    if mp_cfg["cls"] == "MulticomponentMessagePassing":
        return [b["__submodule__"] for b in mp_cfg["blocks"]]
    return [mp_cfg]


def _check_config(cfg: Mapping) -> None:
    mp, agg = cfg["message_passing"], cfg["agg"]
    unsupported = []
    model_cls = cfg.get("model_cls", "MPNN")
    mab = model_cls == "MolAtomBondMPNN"
    if model_cls not in ("MPNN", "MulticomponentMPNN", "MolAtomBondMPNN"):
        unsupported.append(f"model {model_cls}")
    elif (model_cls == "MulticomponentMPNN") != (mp["cls"] == "MulticomponentMessagePassing"):
        unsupported.append(f"model {model_cls} over {mp['cls']}")
    for block in _blocks(mp):
        if block["cls"] not in (MAB_MESSAGE_PASSINGS if mab else MESSAGE_PASSINGS):
            unsupported.append(f"message passing {block['cls']}")
    if agg is not None and agg["cls"] not in AGGREGATIONS:
        unsupported.append(f"aggregation {agg['cls']}")
    for key in MAB_HEADS if mab else ("predictor",):
        pred = cfg.get(key)
        if pred is None:
            continue
        head = HEADS.get(pred["cls"])
        if head is None:
            unsupported.append(f"{key} {pred['cls']}")
        elif pred.get("n_targets", head.n_targets) != head.n_targets:
            unsupported.append(f"{pred['n_targets']} targets per task in a {pred['cls']}")
        crit = pred.get("criterion")
        if crit is not None and crit.get("__metric__") not in METRICS:
            unsupported.append(f"criterion {crit.get('__metric__')}")
    if unsupported:
        raise ValueError(f"checkpoint needs what the port does not run yet: {unsupported}")


def model_from_config(
    cfg: Mapping, params: Mapping | None = None, compute_dtype: torch.dtype | None = None,
    kernel_options: KernelOptions | None = None,
) -> MPNN:
    """The port's model for a manifest's ``model`` entry, with fresh
    parameters. The atom and bond feature widths, which the JAX modules infer
    from the data, come from the ``params`` tree where it is given (the
    kernels' input widths), else from the graph transform or the featurizer's
    defaults. ``compute_dtype`` overrides the manifest's."""
    _check_config(cfg)
    mp_cfg = cfg["message_passing"]
    multi = mp_cfg["cls"] == "MulticomponentMessagePassing"
    mab = cfg.get("model_cls") == "MolAtomBondMPNN"

    def block(b_cfg: Mapping, layers: Mapping | None):
        mp_cls = (MAB_MESSAGE_PASSINGS if mab else MESSAGE_PASSINGS)[b_cfg["cls"]]
        d_h = int(b_cfg["d_h"])
        graph = _decode_transform(b_cfg.get("graph_transform"))
        kw = {}
        if mab:
            kw = dict(d_ed=b_cfg.get("d_ed") or None,
                      return_vertex_embeddings=bool(b_cfg.get("return_vertex_embeddings", True)),
                      return_edge_embeddings=bool(b_cfg.get("return_edge_embeddings", True)),
                      E_d_transform=_decode_transform(b_cfg.get("E_d_transform")))
        if layers is not None:
            # bond message passing of depth 1 has no W_h in the JAX tree
            widths = mab_feature_widths if mab else feature_widths
            d_v, d_e = widths(mp_cls, d_h, *(
                np.shape(layers[w]["kernel"])[0] if w in layers else None
                for w in (("W_i", "W_h", "W_vo", "W_eo") if mab else ("W_i", "W_h", "W_o"))))
        else:
            V_t, E_t = (graph.V_transform, graph.E_transform) if graph else (None, None)
            d_v = 72 if V_t is None else V_t.mean.shape[1]
            d_e = 14 if E_t is None else E_t.mean.shape[1]
        dtype = compute_dtype or getattr(torch, b_cfg.get("compute_dtype", "float32"))
        return mp_cls(
            d_v=d_v, d_e=d_e, d_h=d_h, bias=bool(b_cfg.get("bias", False)),
            depth=int(b_cfg.get("depth", 3)), activation=b_cfg.get("activation", "relu"),
            compute_dtype=dtype, dropout=float(b_cfg.get("dropout", 0.0)),
            undirected=bool(b_cfg.get("undirected", False)), kernel_options=kernel_options,
            d_vd=b_cfg.get("d_vd") or None,
            V_d_transform=_decode_transform(b_cfg.get("V_d_transform")), graph_transform=graph,
            **kw,
        )

    layers = None if params is None else params["message_passing"]
    if multi:
        blocks = [block(b, None if layers is None else layers[f"blocks_{i}"])
                  for i, b in enumerate(_blocks(mp_cfg))]
        mp = MulticomponentMessagePassing(blocks, int(mp_cfg["n_components"]),
                                          bool(mp_cfg.get("shared", False)))
    else:
        mp = block(mp_cfg, layers)
    agg_cfg, agg = cfg["agg"], None
    if agg_cfg is not None:
        size = agg_cfg.get("output_size")
        if params is not None and "agg" in params:  # the attentive readout's W: a block's width
            size = np.shape(params["agg"]["W"]["kernel"])[0]
        agg = AGGREGATIONS[agg_cfg["cls"]](**({"output_size": int(size)} if size is not None
                                              else {}))
        if "norm" in agg_cfg:
            agg.norm = float(agg_cfg["norm"])
    X_d_transform = _decode_transform(cfg.get("X_d_transform"))
    if mab:
        return MolAtomBondMPNN(
            mp, agg, **{k: _head_from_config(cfg.get(k), None) for k in MAB_HEADS},
            **{k: _constrainer_from_config(cfg.get(k)) for k in MAB_CONSTRAINERS},
            batch_norm=bool(cfg.get("batch_norm", False)), X_d_transform=X_d_transform)
    return (MulticomponentMPNN if multi else MPNN)(
        mp, agg, _head_from_config(cfg["predictor"], mp.output_dim),
        batch_norm=bool(cfg.get("batch_norm", False)), X_d_transform=X_d_transform)


def _head_from_config(pred_cfg: Mapping | None, input_dim: int | None):
    if pred_cfg is None:
        return None
    hidden = pred_cfg.get("hidden_dim", 300)
    extra = {k: pred_cfg[k] for k in ("n_classes", "spectral_activation") if k in pred_cfg}
    predictor = HEADS[pred_cfg["cls"]](
        n_tasks=int(pred_cfg.get("n_tasks", 1)),
        input_dim=int(pred_cfg.get("input_dim", input_dim)),
        hidden_dim=list(hidden) if isinstance(hidden, (list, tuple)) else int(hidden),
        n_layers=int(pred_cfg.get("n_layers", 1)), output_transform=False,
        criterion=_decode_metric(pred_cfg.get("criterion")),
        dropout=float(pred_cfg.get("dropout", 0.0)),
        activation=pred_cfg.get("activation", "relu"),
        task_weights=pred_cfg.get("task_weights"), threshold=pred_cfg.get("threshold"),
        **extra,
    )
    predictor.output_transform = _decode_transform(pred_cfg.get("output_transform"))
    return predictor


def _constrainer_from_config(c_cfg: Mapping | None) -> ConstrainerFFN | None:
    if c_cfg is None:
        return None
    hidden = c_cfg.get("hidden_dim", 300)
    return ConstrainerFFN(
        n_constraints=int(c_cfg.get("n_constraints", 1)), fp_dim=int(c_cfg.get("fp_dim", 300)),
        hidden_dim=list(hidden) if isinstance(hidden, (list, tuple)) else int(hidden),
        n_layers=int(c_cfg.get("n_layers", 1)), dropout=float(c_cfg.get("dropout", 0.0)),
        activation=c_cfg.get("activation", "relu"))


# ----------------------------------------------------------------- variables
def _sorted(tree):
    return {k: _sorted(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


def to_jax_params(named: Mapping[str, torch.Tensor],
                  collections=("params", "batch_stats")) -> dict:
    """The inverse of ``from_jax_params``: the port's named parameters and
    batch-norm statistics (a state dict) as the JAX package's variable tree
    ``{"params": ..., "batch_stats": ...}`` of float32 numpy arrays, kernels
    transposed (no ``batch_stats`` entries without batch norm). ``named``
    may also hold Adam's moments under the parameters' names, with
    ``collections=("params",)``. Buffers that are configuration in JAX (the
    transforms) are left out."""
    tree: dict = {c: {} for c in collections}
    for name, value in named.items():
        where = jax_path(name)
        if where is None or where[0] not in tree:
            continue
        collection, path = where
        x = value.detach().float().cpu()
        if path[-1] == "kernel":
            x = x.t()
        node = tree[collection]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x.contiguous().numpy()
    return _sorted(tree)


def jax_leaf(tree: Mapping, name: str):
    """The leaf of the port's parameter ``name`` in a JAX variable tree (or an
    optax moment tree, which mirrors ``params``) as the port's layout, or None
    where the tree holds none (a frozen parameter's moments)."""
    where = jax_path(name)
    node = tree
    for key in where[1] if where else ():
        if not isinstance(node, Mapping) or key not in node:
            return None
        node = node[key]
    if where is None or not hasattr(node, "shape"):
        return None
    x = torch.from_numpy(np.array(node, dtype=np.float32))
    return x.t().contiguous() if where[1][-1] == "kernel" else x


# --------------------------------------------------------------------- files
def is_cptpu(path: str | Path) -> bool:
    with open(path, "rb") as f:
        return f.read(len(MAGIC)) == MAGIC


def save_checkpoint(path: str | Path, model: MPNN, variables: dict, extra: dict | None = None):
    """Write ``variables`` (a JAX variable tree) with ``model``'s manifest."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    manifest = json.dumps({"model": model_config(model), "extra": extra or {}}).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(manifest).to_bytes(8, "little"))
        f.write(manifest)
        f.write(msgpack_codec.packb(variables))


def read_checkpoint(path: str | Path) -> tuple[dict, dict]:
    """``(manifest, variables)`` of a ``CPTPU001`` file, nothing built."""
    path = Path(path)
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path} is not a chemprop_tpu checkpoint")
        n = int.from_bytes(f.read(8), "little")
        manifest = json.loads(f.read(n).decode())
        blob = f.read()
    return manifest, msgpack_codec.unpackb(blob)


def load_checkpoint(
    path: str | Path, compute_dtype: torch.dtype | None = None,
    kernel_options: KernelOptions | None = None,
) -> tuple[MPNN, dict, dict]:
    """``(model, variables, extra)``: the port's model on the CPU with the
    file's parameters and batch-norm statistics loaded, the file's whole
    variable tree, and the manifest's ``extra``."""
    manifest, variables = read_checkpoint(path)
    model = model_from_config(manifest["model"], variables["params"], compute_dtype,
                              kernel_options)
    load_variables(model, variables)
    return model, variables, manifest.get("extra", {})


def load_variables(model: MPNN, variables: Mapping) -> None:
    """Load a JAX variable tree's parameters and batch-norm statistics into
    ``model`` (the transforms' buffers are the manifest's); raise unless it
    holds every one of the model's and nothing else."""
    sd = from_jax_params(variables["params"], variables.get("batch_stats"))
    missing, unexpected = model.load_state_dict(sd, strict=False)
    weights = [k for k in missing if jax_path(k) is not None]
    if weights or unexpected:
        raise ValueError(f"parameters missing {weights}, unexpected {unexpected}")


def save_model(path: str | Path, model: MPNN, output_columns: list[str] | None = None) -> None:
    """The model's parameters and batch-norm statistics, for prediction."""
    variables = to_jax_params({**dict(model.named_parameters()), **dict(model.named_buffers())})
    save_checkpoint(path, model, variables, {"output_columns": output_columns})


def load_model(
    path: str | Path, device: str | torch.device | None = None,
    compute_dtype: torch.dtype | None = None, kernel_options: KernelOptions | None = None,
) -> tuple[MPNN, list[str] | None]:
    """``(model in eval mode on device, output columns or None)``, as
    ``models.load_model`` gives for a reference checkpoint."""
    device = resolve_device(device)
    model, _, extra = load_checkpoint(path, compute_dtype, kernel_options)
    if model.message_passing.compute_dtype == torch.float32:
        use_full_float32()
    return model.to(device).eval(), extra.get("output_columns")


def _adam_state(tree: Any) -> Mapping | None:
    """The optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside a
    serialised ``opt_state``, whichever chain holds it."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        for v in tree.values():
            found = _adam_state(v)
            if found is not None:
                return found
    return None


def jax_opt_state(
    names: list[str], mu: list[torch.Tensor], nu: list[torch.Tensor], step: int,
    frozen: set[str], grad_clip: bool,
) -> dict:
    """The serialised optax state the JAX trainer keeps for the same options:
    ``adam`` (``scale_by_adam``, then the schedule's count), after
    ``clip_by_global_norm`` with ``grad_clip``, inside ``multi_transform``'s
    "train" branch with frozen parameters, whose moments are masked out
    (empty maps)."""
    count = np.array(step, dtype=np.int32)

    def moments(values):
        tree = to_jax_params(dict(zip(names, values)), ("params",))["params"]
        for name in frozen:  # masked leaves are written as empty maps
            node, path = tree, jax_path(name)[1]
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = {}
        return tree

    state: dict = {"0": {"count": count, "mu": moments(mu), "nu": moments(nu)},
                   "1": {"count": count}}
    if grad_clip:
        state = {"0": {}, "1": state}
    if frozen:
        state = {"inner_states": {"freeze": {"inner_state": {}},
                                  "train": {"inner_state": state}}}
    return state


def adam_moments(opt_state: Mapping, names: list[str]) -> tuple[list, list]:
    """Adam's moments of the parameters ``names`` in a serialised ``opt_state``
    (None where it holds none: frozen parameters)."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("opt_state holds no Adam state")
    return ([jax_leaf(adam["mu"], n) for n in names], [jax_leaf(adam["nu"], n) for n in names])
