"""Model loading (cf. ``chemprop_tpu/models/torch_convert.py``).

:func:`load_model` reads the JAX package's ``CPTPU001`` checkpoints
(:mod:`chemprop_tpu_torch.models.serialize`), told apart by their magic bytes,
and reference chemprop v2 ``.pt``/``.ckpt`` files: it reads the latter
(``{hyper_parameters, state_dict, ...}``) without the chemprop or Lightning
packages: classes the pickle names but this environment lacks become
dict-backed stubs that remember their qualified name, which is all the
hyper-parameters need. The port's modules carry the reference's parameter
names and layouts, so the state dict loads as it is.

:func:`from_jax_params` maps a ``chemprop_tpu`` flax parameter tree (dense
kernels in (in, out) layout) onto the port's state dict, so that both
packages can compute with the same weights; :func:`jax_path` names the place
of each of the port's parameters in such a tree."""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from chemprop_tpu_torch.models.model import MPNN
from chemprop_tpu_torch.nn.agg import AGGREGATIONS
from chemprop_tpu_torch.nn.message_passing import BondMessagePassing
from chemprop_tpu_torch.nn.predictors import RegressionFFN
from chemprop_tpu_torch.nn.transforms import GraphTransform, ScaleTransform
from chemprop_tpu_torch.ops.options import KernelOptions
from chemprop_tpu_torch.utils.device import resolve_device, use_full_float32


class _Stub(dict):
    """Dict-backed stand-in for any class the pickle names but this
    environment cannot import (item and attribute access, __setstate__)."""

    _qualname = "?"

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None

    def __setattr__(self, k, v):
        self[k] = v

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.update(state)
        elif isinstance(state, tuple):
            for part in state:
                if isinstance(part, dict):
                    self.update(part)

    def __reduce__(self):
        return (dict, (dict(self),))


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError, ModuleNotFoundError):
            return type(name, (_Stub,), {"_qualname": f"{module}.{name}"})


class _StubPickleModule:
    Unpickler = _StubUnpickler

    @staticmethod
    def load(f, **kwargs):
        return _StubUnpickler(f).load()


def load_checkpoint(path: str | Path) -> dict:
    return torch.load(path, map_location="cpu", pickle_module=_StubPickleModule, weights_only=False)


def _cls_name(obj: Any) -> str:
    if isinstance(obj, type):
        return getattr(obj, "_qualname", obj.__module__ + "." + obj.__name__).rsplit(".", 1)[-1]
    return type(obj).__name__


def _activation(v) -> str:
    return v.lower() if isinstance(v, str) else _cls_name(v).lower()


def build_model(
    hp: Mapping, sd: Mapping, compute_dtype: torch.dtype = torch.float32,
    kernel_options: KernelOptions | None = None,
) -> MPNN:
    """The port's MPNN for a reference single-molecule regression D-MPNN,
    with its ``bias``, ``dropout``, ``undirected`` and both ``activation``
    hyperparameters (message passing's and the head's), atom descriptors
    (``d_vd``), and the scaling transforms its state dict holds.
    Anything the port does not run raises instead of loading wrongly."""
    mp_hp, agg_hp, p_hp = hp["message_passing"], hp["agg"], hp["predictor"]
    agg_name = _cls_name(agg_hp["cls"])
    unsupported = []
    if _cls_name(mp_hp["cls"]) != "BondMessagePassing":
        unsupported.append(f"message passing {_cls_name(mp_hp['cls'])}")
    if _cls_name(p_hp["cls"]) != "RegressionFFN":
        unsupported.append(f"predictor {_cls_name(p_hp['cls'])}")
    if agg_name not in AGGREGATIONS:
        unsupported.append(f"aggregation {agg_name}")
    if unsupported:
        raise ValueError(f"checkpoint needs what the port does not run yet: {unsupported}")

    def transform(prefix: str) -> ScaleTransform | None:
        key = f"{prefix}.mean"
        return ScaleTransform.identity(sd[key].shape[-1]) if key in sd else None

    graph = [transform(f"message_passing.graph_transform.{k}_transform") for k in "VE"]
    W_i = sd["message_passing.W_i.weight"]
    d_h = int(mp_hp.get("d_h", W_i.shape[0]))
    d_v = int(mp_hp.get("d_v", sd["message_passing.W_o.weight"].shape[1] - d_h))
    mp = BondMessagePassing(
        d_v=d_v,
        d_e=W_i.shape[1] - d_v,
        d_h=d_h,
        bias=bool(mp_hp.get("bias", False)),
        depth=int(mp_hp.get("depth", 3)),
        activation=_activation(mp_hp.get("activation", "relu")),
        compute_dtype=compute_dtype,
        dropout=float(mp_hp.get("dropout", 0.0)),
        undirected=bool(mp_hp.get("undirected", False)),
        kernel_options=kernel_options,
        d_vd=int(mp_hp.get("d_vd") or 0) or None,
        V_d_transform=transform("message_passing.V_d_transform"),
        graph_transform=GraphTransform(*graph) if any(graph) else None,
    )
    agg = AGGREGATIONS[agg_name]()
    if agg_name == "NormAggregation":
        agg.norm = float(agg_hp.get("norm", 100.0))
    hidden = p_hp.get("hidden_dim", 300)
    predictor = RegressionFFN(
        n_tasks=int(p_hp.get("n_tasks", 1)),
        input_dim=int(p_hp.get("input_dim", d_h)),
        hidden_dim=list(hidden) if isinstance(hidden, (list, tuple)) else int(hidden),
        n_layers=int(p_hp.get("n_layers", 1)),
        output_transform="predictor.output_transform.mean" in sd,
        dropout=float(p_hp.get("dropout", 0.0)),
        activation=_activation(p_hp.get("activation", "relu")),
    )
    return MPNN(mp, agg, predictor, batch_norm="bn.running_mean" in sd,
                X_d_transform=transform("X_d_transform"))


def load_model(
    path: str | Path,
    device: str | torch.device | None = None,
    compute_dtype: torch.dtype | None = None,
    kernel_options: KernelOptions | None = None,
) -> tuple[MPNN, list[str] | None]:
    """Checkpoint -> (port model in eval mode on ``device``, output column
    names or None). A ``CPTPU001`` file of the JAX package (or of the port's
    ``Trainer``) is told apart by its magic bytes; its compute dtype is the
    manifest's unless ``compute_dtype`` is given. Any other file is read as a
    reference checkpoint, in float32 unless ``compute_dtype`` is given."""
    from chemprop_tpu_torch.models import serialize

    if serialize.is_cptpu(path):
        return serialize.load_model(path, device, compute_dtype, kernel_options)
    device = resolve_device(device)
    compute_dtype = compute_dtype or torch.float32
    if compute_dtype == torch.float32:
        use_full_float32()
    d = load_checkpoint(path)
    skip = ("num_batches_tracked", "criterion", "metrics")  # training state, not weights
    sd = {
        k: v.float()
        for k, v in d["state_dict"].items()
        if not any(part in skip for part in k.split("."))
    }
    model = build_model(d["hyper_parameters"], sd, compute_dtype, kernel_options)
    model.load_state_dict(sd)
    return model.to(device).eval(), d.get("output_columns")


def from_jax_params(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """A ``chemprop_tpu`` flax tree (``variables["params"]`` and, with batch
    norm, ``variables["batch_stats"]``) -> the port's state dict. Output
    unscaling and the activations are module configuration in JAX, not
    parameters, so they are not part of the result: the port's modules are
    built with the JAX modules' activations (``RegressionFFN(activation=...)``
    for the head), and the weights carry across unchanged."""

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd: dict[str, torch.Tensor] = {}
    for name, layer in params["message_passing"].items():
        sd[f"message_passing.{name}.weight"] = t(layer["kernel"]).T.contiguous()
        if "bias" in layer:
            sd[f"message_passing.{name}.bias"] = t(layer["bias"])
    if "bn" in params:
        sd["bn.weight"] = t(params["bn"]["scale"])
        sd["bn.bias"] = t(params["bn"]["bias"])
        sd["bn.running_mean"] = t(batch_stats["bn"]["mean"])
        sd["bn.running_var"] = t(batch_stats["bn"]["var"])
    for name, layer in params["predictor"]["ffn"].items():
        i = int(name.removeprefix("block"))
        pre = f"predictor.ffn.{i}.{0 if i == 0 else 2}"
        sd[f"{pre}.weight"] = t(layer["kernel"]).T.contiguous()
        sd[f"{pre}.bias"] = t(layer["bias"])
    return sd


_LINEAR = {"weight": "kernel", "bias": "bias"}
_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
       "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def jax_path(name: str) -> tuple[str, tuple[str, ...]] | None:
    """The collection and the path in a ``chemprop_tpu`` variable tree of the
    port's parameter or batch-norm statistic ``name`` (the inverse of
    :func:`from_jax_params`; a weight is the transpose of its kernel there),
    or None for a buffer that is configuration in JAX (the transforms)."""
    parts = name.split(".")
    if parts[0] == "message_passing" and len(parts) == 3 and parts[2] in _LINEAR:
        return "params", ("message_passing", parts[1], _LINEAR[parts[2]])
    if parts[0] == "bn" and len(parts) == 2 and parts[1] in _BN:
        collection, leaf = _BN[parts[1]]
        return collection, ("bn", leaf)
    if parts[:2] == ["predictor", "ffn"] and len(parts) == 5 and parts[4] in _LINEAR:
        return "params", ("predictor", "ffn", f"block{parts[2]}", _LINEAR[parts[4]])
    return None
