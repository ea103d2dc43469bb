"""Model loading (cf. ``chemprop_tpu/models/torch_convert.py``).

:func:`load_model` reads a reference chemprop v2 ``.pt``/``.ckpt``
(``{hyper_parameters, state_dict, ...}``) without the chemprop or Lightning
packages: classes the pickle names but this environment lacks become
dict-backed stubs that remember their qualified name, which is all the
hyper-parameters need. The port's modules carry the reference's parameter
names and layouts, so the state dict loads as it is.

:func:`from_jax_params` maps a ``chemprop_tpu`` flax parameter tree (dense
kernels in (in, out) layout) onto the port's state dict, so that both
packages can compute with the same weights."""

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


def build_model(hp: Mapping, sd: Mapping, compute_dtype: torch.dtype = torch.float32) -> MPNN:
    """The port's MPNN for a reference single-molecule regression D-MPNN.
    Anything this slice does not run raises instead of loading wrongly."""
    mp_hp, agg_hp, p_hp = hp["message_passing"], hp["agg"], hp["predictor"]
    agg_name = _cls_name(agg_hp["cls"])
    unsupported = []
    if _cls_name(mp_hp["cls"]) != "BondMessagePassing":
        unsupported.append(f"message passing {_cls_name(mp_hp['cls'])}")
    if mp_hp.get("undirected") or mp_hp.get("d_vd"):
        unsupported.append("undirected messages or atom descriptors")
    if _cls_name(p_hp["cls"]) != "RegressionFFN":
        unsupported.append(f"predictor {_cls_name(p_hp['cls'])}")
    if hp.get("X_d_transform") is not None:
        unsupported.append("molecule descriptors")
    if agg_name not in AGGREGATIONS:
        unsupported.append(f"aggregation {agg_name}")
    if unsupported:
        raise ValueError(f"checkpoint needs what the port does not run yet: {unsupported}")
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
    )
    return MPNN(mp, agg, predictor, batch_norm="bn.running_mean" in sd)


def load_model(
    path: str | Path,
    device: str | torch.device | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[MPNN, list[str] | None]:
    """Reference checkpoint -> (port model in eval mode on ``device``,
    output column names or None)."""
    device = resolve_device(device)
    if compute_dtype == torch.float32:
        use_full_float32()
    d = load_checkpoint(path)
    skip = ("num_batches_tracked", "criterion", "metrics")  # training state, not weights
    sd = {
        k: v.float()
        for k, v in d["state_dict"].items()
        if not any(part in skip for part in k.split("."))
    }
    model = build_model(d["hyper_parameters"], sd, compute_dtype)
    model.load_state_dict(sd)
    return model.to(device).eval(), d.get("output_columns")


def from_jax_params(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """A ``chemprop_tpu`` flax tree (``variables["params"]`` and, with batch
    norm, ``variables["batch_stats"]``) -> the port's state dict. Output
    unscaling is module configuration in JAX, not a parameter, so it is not
    part of the result."""

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
