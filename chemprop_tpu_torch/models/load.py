"""Model loading (cf. ``chemprop_tpu/models/torch_convert.py``).

:func:`load_model` reads the JAX package's ``CPTPU001`` checkpoints
(:mod:`chemprop_tpu_torch.models.serialize`), told apart by their magic bytes,
reference chemprop v2 ``.pt``/``.ckpt`` files and chemprop v1 ``.pt`` files.
It reads the latter two (``{hyper_parameters, state_dict, ...}`` and
``{args, state_dict, data_scaler, ...}``) without the chemprop or Lightning
packages: classes the pickle names but this environment lacks become
dict-backed stubs that remember their qualified name, which is all the
hyper-parameters need. The port's modules carry the v2 reference's parameter
names and layouts, so a v2 state dict loads as it is; :func:`build_v1_model`
renames a v1 one (cf. ``convert_v1_model`` in
``chemprop_tpu/models/torch_convert.py``).

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
from chemprop_tpu_torch.models.mol_atom_bond import MolAtomBondMPNN
from chemprop_tpu_torch.models.multi import MulticomponentMPNN
from chemprop_tpu_torch.nn.agg import AGGREGATIONS
from chemprop_tpu_torch.nn.ffn import ConstrainerFFN
from chemprop_tpu_torch.nn.message_passing import (
    AtomMessagePassing, BondMessagePassing, MABAtomMessagePassing, MABBondMessagePassing,
    MulticomponentMessagePassing,
)
from chemprop_tpu_torch.nn.predictors import MulticlassClassificationFFN, PredictorRegistry
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


REFUSED_MAB_BATCH_NORM = ("a mol-atom-bond model with batch norm is refused, as the JAX "
                          "package's converter refuses it: no reference file has one")

# every head of the JAX package, by class name
HEADS = {cls.__name__: cls for cls in PredictorRegistry.values()}
# the single-molecule message passings, by class name
MESSAGE_PASSINGS = {cls.__name__: cls for cls in (BondMessagePassing, AtomMessagePassing)}
# the mol-atom-bond message passings, by class name
MAB_MESSAGE_PASSINGS = {cls.__name__: cls for cls in (MABBondMessagePassing,
                                                       MABAtomMessagePassing)}
MAB_HEADS = ("mol_predictor", "atom_predictor", "bond_predictor")
MAB_CONSTRAINERS = ("atom_constrainer", "bond_constrainer")


def feature_widths(mp_cls: type, d_h: int, W_i_in: int, W_h_in: int, W_o_in: int
                   ) -> tuple[int, int]:
    """``(d_v, d_e)`` from the input widths of ``W_i``, ``W_h`` and ``W_o``:
    ``W_o`` takes ``[V ; M_v]``; bond message passing's ``W_i`` takes
    ``[V[src] ; E]``, atom message passing's ``W_h`` takes ``[H ; E]``."""
    d_v = W_o_in - d_h
    return d_v, (W_h_in - d_h if issubclass(mp_cls, AtomMessagePassing) else W_i_in - d_v)


def mab_feature_widths(mp_cls: type, d_h: int, W_i_in: int, W_h_in: int, W_vo_in: int | None,
                       W_eo_in: int | None) -> tuple[int, int]:
    """``feature_widths`` of a MAB message passing, whose ``W_vo`` is ``W_o``;
    without node embeddings (no ``W_vo``), ``W_eo`` takes ``[E ; H]``."""
    if W_vo_in is not None:
        return feature_widths(mp_cls, d_h, W_i_in, W_h_in, W_vo_in)
    d_e = W_eo_in - d_h
    return (W_i_in if issubclass(mp_cls, AtomMessagePassing) else W_i_in - d_e), d_e


def build_model(
    hp: Mapping, sd: Mapping, compute_dtype: torch.dtype = torch.float32,
    kernel_options: KernelOptions | None = None,
) -> MPNN:
    """The port's MPNN for a reference single-molecule message passing (bond
    or atom), a sum, mean, norm or attentive readout and any of the JAX
    package's heads (``n_classes`` for a multiclass one), with its
    ``bias``, ``dropout``, ``undirected`` and both ``activation``
    hyperparameters (message passing's and the head's), atom descriptors
    (``d_vd``), and the scaling transforms its state dict holds. A
    ``MulticomponentMessagePassing`` (its blocks under
    ``message_passing.blocks.<i>``, or one ``shared`` block) gives a
    ``MulticomponentMPNN``, as the JAX package's converter routes it. As in
    that converter, the head's criterion is its default one. Anything the
    port does not run raises instead of loading wrongly."""
    if any(k in hp for k in MAB_HEADS):
        return build_mab_model(hp, sd, compute_dtype, kernel_options)
    mp_hp, agg_hp, p_hp = hp["message_passing"], hp["agg"], hp["predictor"]
    agg_name = _cls_name(agg_hp["cls"])
    multi = _cls_name(mp_hp["cls"]) == "MulticomponentMessagePassing"
    blocks = ([(b, f"message_passing.blocks.{i}") for i, b in enumerate(mp_hp["blocks"])]
              if multi else [(mp_hp, "message_passing")])
    unsupported = [f"message passing {_cls_name(b['cls'])}" for b, _ in blocks
                   if _cls_name(b["cls"]) not in MESSAGE_PASSINGS]
    head = HEADS.get(_cls_name(p_hp["cls"]))
    if head is None:
        unsupported.append(f"predictor {_cls_name(p_hp['cls'])}")
    if agg_name not in AGGREGATIONS:
        unsupported.append(f"aggregation {agg_name}")
    if unsupported:
        raise ValueError(f"checkpoint needs what the port does not run yet: {unsupported}")

    def block(b_hp: Mapping, pre: str):
        mp_cls = MESSAGE_PASSINGS[_cls_name(b_hp["cls"])]
        graph = [_transform(sd, f"{pre}.graph_transform.{k}_transform") for k in "VE"]
        W_i = sd[f"{pre}.W_i.weight"]
        d_h = int(b_hp.get("d_h", W_i.shape[0]))
        d_v, d_e = feature_widths(mp_cls, d_h, W_i.shape[1], sd[f"{pre}.W_h.weight"].shape[1],
                                  sd[f"{pre}.W_o.weight"].shape[1])
        return mp_cls(
            d_v=int(b_hp.get("d_v", d_v)),
            d_e=int(b_hp.get("d_e", d_e)),
            d_h=d_h,
            bias=bool(b_hp.get("bias", False)),
            depth=int(b_hp.get("depth", 3)),
            activation=_activation(b_hp.get("activation", "relu")),
            compute_dtype=compute_dtype,
            dropout=float(b_hp.get("dropout", 0.0)),
            undirected=bool(b_hp.get("undirected", False)),
            kernel_options=kernel_options,
            d_vd=int(b_hp.get("d_vd") or 0) or None,
            V_d_transform=_transform(sd, f"{pre}.V_d_transform"),
            graph_transform=GraphTransform(*graph) if any(graph) else None,
        )

    mp = [block(b, pre) for b, pre in blocks]
    if multi:
        mp = MulticomponentMessagePassing(mp, int(mp_hp.get("n_components", len(mp))),
                                          bool(mp_hp.get("shared", False)))
    else:
        mp = mp[0]
    if agg_name == "AttentiveAggregation":
        agg = AGGREGATIONS[agg_name](sd["agg.W.weight"].shape[1])
    else:
        agg = AGGREGATIONS[agg_name]()
    if agg_name == "NormAggregation":
        agg.norm = float(agg_hp.get("norm", 100.0))
    predictor = _head(head, p_hp, sd, "predictor", mp.output_dim)
    return (MulticomponentMPNN if multi else MPNN)(
        mp, agg, predictor, batch_norm="bn.running_mean" in sd,
        X_d_transform=_transform(sd, "X_d_transform"))


def _transform(sd: Mapping, prefix: str) -> ScaleTransform | None:
    """An identity ``ScaleTransform`` of the width of ``prefix``'s buffers in
    ``sd`` (which then load into it), or None."""
    key = f"{prefix}.mean"
    return ScaleTransform.identity(sd[key].shape[-1]) if key in sd else None


def _hidden(v):
    return list(v) if isinstance(v, (list, tuple)) else int(v)


def _head(head: type, p_hp: Mapping, sd: Mapping, prefix: str, input_dim: int):
    """A reference head from its hyperparameters, with an output unscaling
    where ``sd`` holds one; its criterion is its default, as in the JAX
    package's converter."""
    multiclass = issubclass(head, MulticlassClassificationFFN)
    extra = {"n_classes": int(p_hp.get("n_classes", 3))} if multiclass else {}
    return head(
        n_tasks=int(p_hp.get("n_tasks", 1)),
        input_dim=int(p_hp.get("input_dim", input_dim)),
        hidden_dim=_hidden(p_hp.get("hidden_dim", 300)),
        n_layers=int(p_hp.get("n_layers", 1)),
        output_transform=f"{prefix}.output_transform.mean" in sd,
        dropout=float(p_hp.get("dropout", 0.0)),
        activation=_activation(p_hp.get("activation", "relu")),
        **extra,
    )


def build_mab_model(
    hp: Mapping, sd: Mapping, compute_dtype: torch.dtype = torch.float32,
    kernel_options: KernelOptions | None = None,
) -> MolAtomBondMPNN:
    """The port's ``MolAtomBondMPNN`` for a reference mol-atom-bond
    checkpoint (cf. ``_convert_mab_model`` of
    ``chemprop_tpu/models/torch_convert.py``): its MAB message passing with
    the atom and bond descriptors' widths and transforms, up to three heads,
    the readout where there is a molecule head, and the constrainers. Batch
    norm is refused, as the JAX converter refuses it."""
    mp_hp = hp["message_passing"]
    name = _cls_name(mp_hp["cls"])
    unsupported = [] if name in MAB_MESSAGE_PASSINGS else [f"message passing {name}"]
    heads = {k: None if hp.get(k) is None else HEADS.get(_cls_name(hp[k]["cls"]))
             for k in MAB_HEADS}
    unsupported += [f"{k} {_cls_name(hp[k]['cls'])}" for k, h in heads.items()
                    if h is None and hp.get(k) is not None]
    agg_name = None if hp.get("agg") is None else _cls_name(hp["agg"]["cls"])
    if heads["mol_predictor"] is not None and agg_name not in AGGREGATIONS:
        unsupported.append(f"aggregation {agg_name}")
    if unsupported:
        raise ValueError(f"checkpoint needs what the port does not run yet: {unsupported}")
    if bool(hp.get("batch_norm")) or any(k.startswith(("bns.", "bn_")) for k in sd):
        raise ValueError(REFUSED_MAB_BATCH_NORM)
    mp_cls = MAB_MESSAGE_PASSINGS[name]
    pre = "message_passing"
    d_h = int(mp_hp.get("d_h", sd[f"{pre}.W_i.weight"].shape[0]))
    vertex = bool(mp_hp.get("return_vertex_embeddings", True))
    edge = bool(mp_hp.get("return_edge_embeddings", True))
    d_v, d_e = mab_feature_widths(mp_cls, d_h, *(
        sd[f"{pre}.{w}.weight"].shape[1] if f"{pre}.{w}.weight" in sd else None
        for w in ("W_i", "W_h", "W_vo", "W_eo")))
    graph = [_transform(sd, f"{pre}.graph_transform.{k}_transform") for k in "VE"]
    mp = mp_cls(
        d_v=int(mp_hp.get("d_v", d_v)), d_e=int(mp_hp.get("d_e", d_e)), d_h=d_h,
        bias=bool(mp_hp.get("bias", False)), depth=int(mp_hp.get("depth", 3)),
        activation=_activation(mp_hp.get("activation", "relu")), compute_dtype=compute_dtype,
        dropout=float(mp_hp.get("dropout", 0.0)), undirected=bool(mp_hp.get("undirected", False)),
        kernel_options=kernel_options, d_vd=int(mp_hp.get("d_vd") or 0) or None,
        d_ed=int(mp_hp.get("d_ed") or 0) or None, return_vertex_embeddings=vertex,
        return_edge_embeddings=edge, V_d_transform=_transform(sd, f"{pre}.V_d_transform"),
        E_d_transform=_transform(sd, f"{pre}.E_d_transform"),
        graph_transform=GraphTransform(*graph) if any(graph) else None,
    )
    d_vout, d_eout = mp.output_dims
    agg = None
    if heads["mol_predictor"] is not None:
        agg = (AGGREGATIONS[agg_name](sd["agg.W.weight"].shape[1])
               if agg_name == "AttentiveAggregation" else AGGREGATIONS[agg_name]())
        if agg_name == "NormAggregation":
            agg.norm = float(hp["agg"].get("norm", 100.0))
    widths = {"mol_predictor": d_vout, "atom_predictor": d_vout,
              "bond_predictor": None if d_eout is None else 2 * d_eout}
    built = {k: None if h is None else _head(h, hp[k], sd, k, widths[k])
             for k, h in heads.items()}

    def constrainer(k):
        c_hp = hp.get(k)
        if c_hp is None:
            return None
        return ConstrainerFFN(
            n_constraints=int(c_hp.get("n_constraints", 1)), fp_dim=int(c_hp.get("fp_dim", 300)),
            hidden_dim=_hidden(c_hp.get("hidden_dim", 300)), n_layers=int(c_hp.get("n_layers", 1)),
            dropout=float(c_hp.get("dropout", 0.0)),
            activation=_activation(c_hp.get("activation", "relu")))

    return MolAtomBondMPNN(mp, agg, **built, **{k: constrainer(k) for k in MAB_CONSTRAINERS},
                           X_d_transform=_transform(sd, "X_d_transform"))


# v1 files the port does not serve: atom descriptors and molecule features,
# which the JAX package's converter loads as a model that ignores them, so
# that it serves them wrongly (ROADMAP.md section 3, divergences by design)
V1_REFUSED = (
    (lambda a, sd: getattr(a, "atom_descriptors", None) is not None
     or any("atom_descriptors_layer" in k for k in sd),
     "a v1 model with atom descriptors is refused: the JAX package's converter would "
     "mis-serve it, as a model that ignores them (ROADMAP.md section 3, v1 atom "
     "descriptors)"),
    (lambda a, sd: bool(getattr(a, "use_input_features", False)
                        or getattr(a, "features_generator", None)
                        or getattr(a, "features_path", None)),
     "a v1 model with molecule features is refused: the JAX package's converter would "
     "mis-serve it, as a model that ignores them (ROADMAP.md section 3, v1 molecule "
     "features)"),
)
V1_HEADS = {"regression": "RegressionFFN", "classification": "BinaryClassificationFFN",
            "multiclass": "MulticlassClassificationFFN"}
V1_W = ("W_i", "W_h", "W_o")


def is_v1(d: Mapping) -> bool:
    """Whether a loaded ``.pt`` is a chemprop v1 file."""
    return "hyper_parameters" not in d and "args" in d


def v1_encoders(raw: Mapping[str, torch.Tensor], n_components: int, shared: bool
                ) -> list[int]:
    """The indices of the distinct ``encoder.encoder.<i>`` of a v1 state
    dict, one per block. v1 builds a shared encoder as one module repeated
    in a ``ModuleList``, whose state dict repeats its tensors at every index:
    with ``mpn_shared`` such repeats are one block (the JAX package's
    converter counts them as several and raises; ROADMAP.md section 3, v1
    shared encoders). Several blocks where the file's ``number_of_molecules``
    does not take them raise, as that converter raises."""
    found = sorted({int(k.split(".")[2]) for k in raw if k.startswith("encoder.encoder.")})
    if shared and len(found) > 1:
        first = {k.split(".", 3)[3]: v for k, v in raw.items()
                 if k.startswith("encoder.encoder.0.")}
        for i in found[1:]:
            pre = f"encoder.encoder.{i}."
            mine = {k[len(pre):]: v for k, v in raw.items() if k.startswith(pre)}
            if mine.keys() != first.keys() or not all(torch.equal(mine[k], first[k])
                                                      for k in first):
                raise ValueError(f"a v1 model with mpn_shared holds encoder {i} apart from "
                                 "encoder 0: a shared encoder repeats one module's tensors")
        return found[:1]
    if not shared and n_components > 1 and len(found) != n_components:
        raise ValueError(f"a v1 model of {n_components} molecules without mpn_shared needs "
                         f"one encoder per molecule; the file holds {len(found)}")
    if n_components == 1 and len(found) > 1:
        raise ValueError(f"a v1 model of one molecule holds {len(found)} encoders")
    return found


def build_v1_model(
    d: Mapping, compute_dtype: torch.dtype = torch.float32,
    kernel_options: KernelOptions | None = None,
) -> tuple[MPNN, dict[str, torch.Tensor], list[str] | None]:
    """A loaded chemprop v1 file -> (the port's MPNN, its state dict in the
    port's names, the task names or None), as ``convert_v1_model`` of the
    JAX package builds it. v1's bond message passing is the port's
    ``BondMessagePassing`` (``AtomMessagePassing`` with ``atom_messages``:
    ``W_i`` takes the atom features, ``W_h`` the hidden width and the 14
    bond features); ``encoder.encoder.<i>.W_{i,h,o}`` become
    ``message_passing.W_{i,h,o}`` for one molecule (W_i takes the 133-wide
    v1 atom features and the 14 bond features, W_o the atom features and
    the hidden width). A file of ``number_of_molecules`` > 1 gives a
    ``MulticomponentMPNN``: each distinct encoder is one block
    (``message_passing.blocks.<i>``) with its own feature widths, or one
    ``shared`` block with ``mpn_shared`` (:func:`v1_encoders`), and the FFN
    takes the blocks' concatenated fingerprints. The sorted Linear indices
    of the ``readout`` Sequential become the FFN's blocks; ``data_scaler``'s
    means and stds the output unscaling. There is no batch norm, and
    ``cached_zero_vector`` is dropped. An FFN wider than the fingerprints
    (v1 molecule features), atom descriptors, and encoders that the file's
    molecule count does not take raise."""
    args, raw = d["args"], d["state_dict"]

    def arg(name, default=None):
        v = getattr(args, name, default)
        return default if v is None else v

    for asks, message in V1_REFUSED:
        if asks(args, raw):
            raise ValueError(message)
    n_components = int(arg("number_of_molecules", 1))
    shared = bool(arg("mpn_shared", False))
    encoders = v1_encoders(raw, n_components, shared)
    multi = n_components > 1 or len(encoders) > 1
    d_h = int(arg("hidden_size", 300))
    mp_cls = AtomMessagePassing if bool(arg("atom_messages", False)) else BondMessagePassing
    activation = _activation(arg("activation", "ReLU"))
    dropout = float(arg("dropout", 0.0))
    sd: dict[str, torch.Tensor] = {}
    blocks = []
    for b, i in enumerate(encoders):
        enc, pre = f"encoder.encoder.{i}.", (f"message_passing.blocks.{b}" if multi
                                             else "message_passing")
        sd.update({f"{pre}.{k[len(enc):]}": v.float() for k, v in raw.items()
                   if k.startswith(enc) and k.split(".")[3] in V1_W})
        d_v, d_e = feature_widths(mp_cls, d_h, *(sd[f"{pre}.{w}.weight"].shape[1] for w in V1_W))
        blocks.append(mp_cls(
            d_v=d_v, d_e=d_e, d_h=d_h, bias=bool(arg("bias", False)),
            depth=int(arg("depth", 3)), activation=activation, compute_dtype=compute_dtype,
            dropout=dropout, undirected=bool(arg("undirected", False)),
            kernel_options=kernel_options,
        ))
    mp = (MulticomponentMessagePassing(blocks, n_components, shared) if multi else blocks[0])
    linears = sorted({int(k.split(".")[1]) for k in raw
                      if k.startswith("readout.") and k.endswith(".weight")})
    for b, j in enumerate(linears):
        for leaf in ("weight", "bias"):
            sd[f"predictor.ffn.{b}.{0 if b == 0 else 2}.{leaf}"] = raw[f"readout.{j}.{leaf}"].float()
    if raw[f"readout.{linears[0]}.weight"].shape[1] != mp.output_dim:
        raise ValueError("a v1 model whose FFN takes more than the fingerprint is refused: the "
                         "JAX package's converter would mis-serve it, as a model that ignores "
                         "its molecule features (ROADMAP.md section 3, v1 molecule features)")
    task_names = list(arg("task_names", None) or [])
    n_tasks = int(arg("num_tasks", 0) or len(task_names) or 1)
    dataset_type = str(arg("dataset_type", "regression"))
    head = HEADS[V1_HEADS.get(dataset_type, "RegressionFFN")]
    extra = ({"n_classes": int(arg("multiclass_num_classes", 3))}
             if issubclass(head, MulticlassClassificationFFN) else {})
    scaler = d.get("data_scaler")
    unscale = scaler is not None and scaler.get("means") is not None
    predictor = head(n_tasks=n_tasks, input_dim=mp.output_dim,
                     hidden_dim=int(arg("ffn_hidden_size", 300)), n_layers=len(linears) - 1,
                     output_transform=unscale, dropout=dropout, activation=activation, **extra)
    if unscale:
        for key, name in (("mean", "means"), ("scale", "stds")):
            sd[f"predictor.output_transform.{key}"] = torch.from_numpy(
                np.asarray(scaler[name], dtype=np.float32).reshape(1, -1))
    agg = AGGREGATIONS[{"mean": "MeanAggregation", "sum": "SumAggregation",
                        "norm": "NormAggregation"}[str(arg("aggregation", "mean")).lower()]]()
    if hasattr(agg, "norm"):
        agg.norm = float(arg("aggregation_norm", 100))
    return (MulticomponentMPNN if multi else MPNN)(mp, agg, predictor), sd, task_names or None


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
    reference checkpoint (v2, or v1 by its ``args``), in float32 unless
    ``compute_dtype`` is given."""
    from chemprop_tpu_torch.models import serialize

    if serialize.is_cptpu(path):
        return serialize.load_model(path, device, compute_dtype, kernel_options)
    device = resolve_device(device)
    compute_dtype = compute_dtype or torch.float32
    if compute_dtype == torch.float32:
        use_full_float32()
    d = load_checkpoint(path)
    if is_v1(d):
        model, sd, output_columns = build_v1_model(d, compute_dtype, kernel_options)
        model.load_state_dict(sd)
        return model.to(device).eval(), output_columns
    skip = ("num_batches_tracked", "criterion", "metrics", "metricss")  # not weights
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
    built with the JAX modules' activations (``activation=...`` of the head),
    and the weights carry across unchanged. Every head keeps its MLP under
    ``predictor/ffn`` (a mol-atom-bond model's three heads and two
    constrainers under their own names, each ``ffn``), so one mapping serves
    them all.""" 

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd: dict[str, torch.Tensor] = {}

    def layers(tree, prefix):
        for name, layer in tree.items():
            if name.startswith("blocks_"):  # a multicomponent block
                layers(layer, f"{prefix}.blocks.{name.removeprefix('blocks_')}")
                continue
            sd[f"{prefix}.{name}.weight"] = t(layer["kernel"]).T.contiguous()
            if "bias" in layer:
                sd[f"{prefix}.{name}.bias"] = t(layer["bias"])

    layers(params.get("message_passing", {}), "message_passing")
    if "agg" in params:  # the attentive readout's W
        sd["agg.W.weight"] = t(params["agg"]["W"]["kernel"]).T.contiguous()
        sd["agg.W.bias"] = t(params["agg"]["W"]["bias"])
    for bn in BATCH_NORMS:
        if bn in params:
            sd[f"{bn}.weight"] = t(params[bn]["scale"])
            sd[f"{bn}.bias"] = t(params[bn]["bias"])
            sd[f"{bn}.running_mean"] = t(batch_stats[bn]["mean"])
            sd[f"{bn}.running_var"] = t(batch_stats[bn]["var"])
    for head in FFN_OWNERS:
        for name, layer in params.get(head, {}).get("ffn", {}).items():
            i = int(name.removeprefix("block"))
            pre = f"{head}.ffn.{i}.{0 if i == 0 else 2}"
            sd[f"{pre}.weight"] = t(layer["kernel"]).T.contiguous()
            sd[f"{pre}.bias"] = t(layer["bias"])
    return sd


# the modules that own an MLP under ``ffn``, and the batch norms, in either
# model's tree
FFN_OWNERS = ("predictor", *MAB_HEADS, *MAB_CONSTRAINERS)
BATCH_NORMS = ("bn", "bn_mol", "bn_atom", "bn_bond")


_LINEAR = {"weight": "kernel", "bias": "bias"}
_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
       "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def jax_path(name: str) -> tuple[str, tuple[str, ...]] | None:
    """The collection and the path in a ``chemprop_tpu`` variable tree of the
    port's parameter or batch-norm statistic ``name`` (the inverse of
    :func:`from_jax_params`; a weight is the transpose of its kernel there),
    or None for a buffer that is configuration in JAX (the transforms)."""
    parts = name.split(".")
    if parts[:2] == ["message_passing", "blocks"] and len(parts) == 5 and parts[4] in _LINEAR:
        return "params", (parts[0], f"blocks_{parts[2]}", parts[3], _LINEAR[parts[4]])
    if parts[0] in ("message_passing", "agg") and len(parts) == 3 and parts[2] in _LINEAR:
        return "params", (parts[0], parts[1], _LINEAR[parts[2]])
    if parts[0] in BATCH_NORMS and len(parts) == 2 and parts[1] in _BN:
        collection, leaf = _BN[parts[1]]
        return collection, (parts[0], leaf)
    if parts[0] in FFN_OWNERS and parts[1] == "ffn" and len(parts) == 5 and parts[4] in _LINEAR:
        return "params", (parts[0], "ffn", f"block{parts[2]}", _LINEAR[parts[4]])
    return None
