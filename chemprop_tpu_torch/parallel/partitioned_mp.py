"""Edge-partitioned training and inference: one giant molecule cut across
shards (cf. ``chemprop_tpu/parallel/partitioned_mp.py``).

The whole-graph data-parallel path (``parallel/shard_train.py``) never cuts
a molecule; one too large for a device's batch slice would inflate every
shard's padding. Here the molecule's dst-sorted edge table is cut into
contiguous per-shard slices (``ops/edge_partition.py``), and the whole
D-MPNN forward (W_i, the depth loop with W_h, the ``M_v`` readout, W_o, the
graph readout and the head) runs on the shards, with the halo exchange
between them; backprop flows through the exchange, whose transpose is the
reverse shift. The sums and gathers of every shard are kernels C and I.

The parameters are the standard ``MPNN``'s: a model trained here saves
through the normal checkpoint path and predicts on the single-device path,
and the reverse. The tables are float32, the parameters' dtype, as in the
JAX package, whatever the model's compute dtype.

Scope (:func:`check_partitionable`): bond or atom message passing (directed
or ``undirected``), mean/sum/norm aggregation, no batch norm, one
component; extra atom descriptors (``V_d`` through ``W_d``) and molecule
descriptors (``X_d`` after the embedding). Dropout in the train step
(masks per shard; the head's, drawn once, are the same on every rank).

``mesh`` is where the shards live: an int ``S`` (S shards stacked in this
process, ``ops.edge_partition.LocalExchange``), a ``parallel.sharding.Mesh``
(one shard per rank of its process group), or an ``Exchange``."""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from chemprop_tpu_torch.ops.edge_partition import (
    Exchange,
    GroupExchange,
    HaloTables,
    LocalExchange,
    edge_halo,
    gather_rev_ext,
    gather_src_ext,
    halo_message,
    halo_node_accumulators,
    masked,
    partition_edges,
    with_sacrificial_row,
)
from chemprop_tpu_torch.ops.gather import row_gather


class PartitionedGraph(NamedTuple):
    """One molecule cut into per-shard slices (leading axis: shard), on the
    host."""

    V_ext: Any  # [S, N + 2HN + 1, d_v] node features: [halo | owned | halo | sacrificial]
    E: Any  # [S, P, d_e] edge features (dst-sorted slice)
    src_ext: Any  # [S, P] into the extended node layout
    dst_ext: Any
    rev_ext: Any  # [S, P] into [HE | P | HE]
    edge_mask: Any  # [S, P]
    n_owned: Any  # [S]
    n_edges: Any  # [S]
    V_d_own: Any = None  # [S, N, d_vd] extra atom descriptors (owned rows)


class PartitionDims(NamedTuple):
    n_shards: int
    P: int
    N: int
    HN: int
    HE: int
    # every shard owns >= 2 HN nodes: the halo exchange may run as one phase
    single_phase: bool = False


class DeviceGraph(NamedTuple):
    """The held shards of a :class:`PartitionedGraph` on a device."""

    V_ext: torch.Tensor  # [S_held, R, d_v]
    E: torch.Tensor  # [S_held, P, d_e]
    tables: HaloTables
    V_d_own: torch.Tensor | None


def exchange_for(mesh) -> Exchange:
    """The exchange of ``mesh`` (an int, a ``Mesh`` or an ``Exchange``)."""
    if isinstance(mesh, Exchange):
        return mesh
    if isinstance(mesh, int):
        return LocalExchange(mesh)
    return GroupExchange(mesh.group)


def check_partitionable(model) -> None:
    """Raise with the reason where the model is outside this mode's scope."""
    from chemprop_tpu_torch.models.model import MPNN
    from chemprop_tpu_torch.nn.agg import MeanAggregation, NormAggregation, SumAggregation
    from chemprop_tpu_torch.nn.message_passing import AtomMessagePassing, BondMessagePassing

    mp = getattr(model, "message_passing", None)
    if not isinstance(model, MPNN) or not isinstance(mp, (BondMessagePassing,
                                                          AtomMessagePassing)):
        raise ValueError("--edge-partition requires bond or atom message passing")
    if model.bn is not None:
        raise ValueError("--edge-partition does not support --batch-norm")
    if not isinstance(model.agg, (MeanAggregation, SumAggregation, NormAggregation)):
        raise ValueError("--edge-partition supports mean/sum/norm aggregation")


def _sorted_tables(mg):
    """``src, dst, rev`` of a MolGraph stable-sorted by dst, and the order."""
    dst = np.asarray(mg.edge_index[1], np.int64)
    order = np.argsort(dst, kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    src = np.asarray(mg.edge_index[0], np.int64)[order]
    rev = inv[np.asarray(mg.rev_edge_index, np.int64)[order]]
    return src, dst[order], rev, order


def _single_phase(own: np.ndarray, HN: int, S: int) -> bool:
    return bool(int(own.min()) >= 2 * HN) if S > 1 else True


def build_partitioned_graph(
    mg, n_shards: int, min_halo_nodes: int = 8, min_halo_edges: int = 8,
    min_owned_nodes: int = 1, min_shard_edges: int = 1, V_d=None,
) -> tuple[PartitionedGraph, PartitionDims]:
    """Dst-sort a featurised MolGraph and cut it into shard slices with halo
    node-feature rows, on the host. The ``min_*`` floors force common padded
    dims across a dataset; ``V_d`` (``[n_nodes, d_vd]``) is sliced to each
    shard's owned nodes."""
    src, dst, rev, order = _sorted_tables(mg)
    E_feats = np.asarray(mg.E, np.float32)[order]
    V = np.asarray(mg.V, np.float32)
    n_nodes = V.shape[0]
    plan = partition_edges(src, dst, rev, n_nodes, n_shards, min_halo_nodes=min_halo_nodes,
                           min_halo_edges=min_halo_edges, min_owned_nodes=min_owned_nodes,
                           min_shard_edges=min_shard_edges)
    S, Pp, N, HN, HE = plan.n_shards, plan.P, plan.N, plan.HN, plan.HE
    cuts = np.concatenate([[0], np.cumsum(plan.n_edges)]).astype(int)
    lo, own = plan.node_lo, plan.n_owned
    V_ext = np.zeros((S, N + 2 * HN + 1, V.shape[1]), np.float32)
    E_p = np.zeros((S, Pp, E_feats.shape[1]), np.float32)
    for s in range(S):
        hi = int(lo[s]) + int(own[s])
        # the right halo sits after the padded owned block, as loc_node has it
        for row0, g0, count in ((0, int(lo[s]) - HN, HN), (HN, int(lo[s]), int(own[s])),
                                (HN + N, hi, HN)):
            idx = np.arange(count) + g0
            ok = (idx >= 0) & (idx < n_nodes)
            V_ext[s, row0 : row0 + count][ok] = V[idx[ok]]
        E_p[s, : cuts[s + 1] - cuts[s]] = E_feats[cuts[s] : cuts[s + 1]]
    V_d_own = None
    if V_d is not None:
        V_d = np.asarray(V_d, np.float32)
        V_d_own = np.zeros((S, N, V_d.shape[1]), np.float32)
        for s in range(S):
            V_d_own[s, : int(own[s])] = V_d[int(lo[s]) : int(lo[s]) + int(own[s])]
    g = PartitionedGraph(V_ext, E_p, plan.src_ext, plan.dst_ext, plan.rev_ext, plan.edge_mask,
                         plan.n_owned, plan.n_edges, V_d_own)
    return g, PartitionDims(S, Pp, N, HN, HE, _single_phase(own, HN, S))


def natural_dims(mg, n_shards: int) -> PartitionDims:
    """The molecule's dims before any cross-dataset floors (the plan alone,
    no feature slices)."""
    src, dst, rev, _ = _sorted_tables(mg)
    plan = partition_edges(src, dst, rev, np.asarray(mg.V).shape[0], n_shards)
    return PartitionDims(plan.n_shards, plan.P, plan.N, plan.HN, plan.HE,
                         _single_phase(plan.n_owned, plan.HN, plan.n_shards))


def place(g: PartitionedGraph, dims: PartitionDims, exchange: Exchange,
          device: str | torch.device) -> DeviceGraph:
    """The shards ``exchange`` holds of ``g``, on ``device``."""
    held = list(exchange.held)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a)[held])).to(device)
    tables = HaloTables(*(np.asarray(a)[held] for a in (
        g.src_ext, g.dst_ext, g.rev_ext, g.edge_mask, g.n_owned, g.n_edges)),
        dims.N, dims.HN, dims.HE, device)
    return DeviceGraph(t(g.V_ext), t(g.E), tables, None if g.V_d_own is None else t(g.V_d_own))


def _kernel(layer, rows: int, cols: int, row_blocks=None):
    """``layer``'s (in, out) kernel zero-padded to ``rows x cols`` in f32 (or
    its row blocks ``(start, stop, padded rows)`` padded one by one), and its
    bias padded to ``cols``."""
    K = layer.weight.t().float()
    if row_blocks is None:
        K = F.pad(K, (0, cols - K.shape[1], 0, rows - K.shape[0]))
    else:
        K = torch.cat([F.pad(K[a:b], (0, cols - K.shape[1], 0, n - (b - a)))
                       for a, b, n in row_blocks])
    b = None if layer.bias is None else F.pad(layer.bias.float(), (0, cols - layer.out_features))
    return K, b


def _affine(x, K, b):
    y = x @ K
    return y if b is None else y + b


def _gather_rows(V: torch.Tensor, tables: HaloTables) -> torch.Tensor:
    """``V[src_ext]`` per shard for a table without gradient, by kernel I
    (its rows zero-padded to whole 16-byte chunks, then cut back)."""
    S, R, d = V.shape
    d_row = -(-d // 4) * 4
    flat = F.pad(V.reshape(S * R, d), (0, d_row - d)).contiguous()
    return row_gather(flat, tables.src)[:, :d].reshape(S, tables.P, d)


def _mp_local(model, g: DeviceGraph, dims: PartitionDims, exchange: Exchange,
              generator: torch.Generator | None = None, is_training: bool = True):
    """The held shards' D-MPNN forward: ``(H_v [S, N, d_pad], node_mask [S,
    N])`` for the owned nodes. ``generator`` (train step only) draws the
    dropout masks: after each iteration, after W_o and after W_d."""
    from chemprop_tpu_torch.nn.message_passing import AtomMessagePassing

    mp = model.message_passing
    tau, dp, dh = mp.tau, mp.d_pad, mp.d_h
    tb, HN, N = g.tables, dims.HN, dims.N
    is_atom = isinstance(mp, AtomMessagePassing)
    drop_on = generator is not None and mp.dropout > 0
    V_ext, E = g.V_ext.float(), g.E.float()
    if not is_training and mp.graph_transform is not None:
        # evaluation-only scaling of the extra features; the padding and
        # sacrificial rows it moves are masked downstream
        gt = mp.graph_transform
        if gt.V_transform is not None:
            V_ext = gt.V_transform(V_ext, False)
        if gt.E_transform is not None:
            E = gt.E_transform(E, False)

    if is_atom:
        W_i, b_i = _kernel(mp.W_i, mp.d_v, dp)
        H0 = gather_src_ext(_affine(V_ext, W_i, b_i), tb)
        W_h, b_h = _kernel(mp.W_h, mp.d_message, dp,
                           [(0, dh, dp), (dh, dh + mp.d_e, mp.d_message - dp)])
        E_msg = F.pad(E, (0, mp.d_message - dp - E.shape[-1]))
    else:
        W_i, b_i = _kernel(mp.W_i, mp.d_v + mp.d_e, dp)
        H0 = _affine(torch.cat([_gather_rows(V_ext, tb), E], dim=-1), W_i, b_i)
        W_h, b_h = _kernel(mp.W_h, dp, dp)

    H = tau(H0)
    for _ in range(1, mp.depth):
        if mp.undirected:
            # (H + H[rev]) / 2; cross-cut reverses through the sideways halo
            H = (H + gather_rev_ext(edge_halo(masked(H, tb), tb, exchange), tb)) / 2
        if is_atom:
            acc = halo_node_accumulators(torch.cat([H, E_msg], dim=-1), tb, exchange,
                                         with_halo=True, single_phase=dims.single_phase)
            M = masked(gather_src_ext(with_sacrificial_row(acc), tb), tb)
        elif mp.undirected:
            # the averaged H is rev-symmetric: the reverse subtraction is local
            Hm = masked(H, tb)
            acc = halo_node_accumulators(Hm, tb, exchange, with_halo=True,
                                         single_phase=dims.single_phase)
            M = masked(gather_src_ext(with_sacrificial_row(acc), tb) - Hm, tb)
        else:
            M = halo_message(H, tb, exchange, single_phase=dims.single_phase)
        H = mp.drop(tau(H0 + _affine(M, W_h, b_h)), drop_on, generator)
    M_v = halo_node_accumulators(masked(H, tb), tb, exchange, with_halo=False)
    # M_v's padding columns sit at the end of [V ; M_v]: zero rows there
    W_o, b_o = _kernel(mp.W_o, mp.d_v + dp, dp)
    V_own = V_ext[:, HN : HN + N]
    H_v = mp.drop(tau(_affine(torch.cat([V_own, M_v], dim=-1), W_o, b_o)), drop_on, generator)
    if mp.d_vd:
        if g.V_d_own is None:
            raise ValueError("model expects extra atom descriptors (d_vd > 0) but the "
                             "partitioned graph carries none — pass V_d to "
                             "build_partitioned_graph")
        V_d = g.V_d_own.float()
        if mp.V_d_transform is not None and not is_training:
            V_d = mp.V_d_transform(V_d, False)
        out = -(-mp.W_d.out_features // 128) * 128
        W_d, b_d = _kernel(mp.W_d, dp + mp.d_vd, out, [(0, dh, dp), (dh, dh + mp.d_vd, mp.d_vd)])
        H_v = mp.drop(_affine(torch.cat([H_v, V_d], dim=-1), W_d, b_d), drop_on, generator)
    counts = torch.tensor(tb.n_owned, device=H_v.device)
    node_mask = torch.arange(N, device=H_v.device)[None, :] < counts[:, None]
    return H_v, node_mask


def _local_readout(H_v, node_mask):
    """Each held shard's sum of its owned rows, and their count."""
    ls = torch.where(node_mask[..., None], H_v, torch.zeros((), device=H_v.device)).sum(1)
    return ls, node_mask.sum(1).float()


def _graph_embedding(model, s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``[1, output_dim]`` from the graph's summed rows ``s`` and count ``c``."""
    from chemprop_tpu_torch.nn.agg import MeanAggregation, NormAggregation

    if isinstance(model.agg, MeanAggregation):
        s = s / c.clamp_min(1.0)
    elif isinstance(model.agg, NormAggregation):
        s = s / model.agg.norm
    return s[None, : model.message_passing.output_dim]


def _head_input(model, Z, x_d, is_training: bool):
    if x_d is None:
        return Z
    x_d = x_d.float().reshape(1, -1)
    if model.X_d_transform is not None and not is_training:
        x_d = model.X_d_transform(x_d, False)
    return torch.cat([Z, x_d], dim=1)


def make_partitioned_apply(
    model, mesh, dims: PartitionDims, train_space: bool = False,
    encode_index: int | None = None,
) -> Callable:
    """Inference on one partitioned molecule with the model's parameters:
    ``fn(g, x_d=None) -> [1, ...]``, ``g`` a :class:`DeviceGraph` (inference
    activations and output unscaling unless ``train_space``; with
    ``encode_index`` the predictor's FFN blocks ``[:i]`` on the embedding)."""
    check_partitionable(model)
    exchange = exchange_for(mesh)

    @torch.inference_mode()
    def fn(g: DeviceGraph, x_d=None):
        H_v, node_mask = _mp_local(model, g, dims, exchange, is_training=False)
        ls, lc = _local_readout(H_v, node_mask)
        Z = _head_input(model, _graph_embedding(model, exchange.sum(ls), exchange.sum(lc)),
                        x_d, False)
        if encode_index is not None:
            return model.predictor.encode(Z, encode_index, False)
        if train_space:
            return model.predictor.train_step(Z, False)
        return model.predictor(Z, False)

    return fn


def make_partitioned_train_step(
    model, mesh, dims: PartitionDims, lr: Callable[[int], float] | float = 1e-3,
) -> Callable:
    """One Adam step on one partitioned molecule: ``step(state, g, y, w,
    x_d=None) -> loss``, ``state`` a ``train.TrainState`` of the model's
    parameters (updated in place), ``y`` ``[1, t]``, ``w`` ``[1]``.

    As in the JAX package, the message passing's forward is differentiated
    locally, the readout, head and criterion run replicated on the summed
    embedding, and the chained message-passing gradients are summed over the
    shards (over the process group for a ``Mesh``); the parameters outside
    message passing and the predictor get zero gradients. ``state.rng``
    draws the head's dropout masks (the same on every rank) and
    ``state.shard_rng`` the message passing's (one per rank)."""
    import torch.distributed as dist

    from chemprop_tpu_torch.train.trainer import adam_update

    check_partitionable(model)
    exchange = exchange_for(mesh)
    mp, predictor, criterion = model.message_passing, model.predictor, model.criterion
    rate = lr if callable(lr) else (lambda _step: lr)

    def step(state, g: DeviceGraph, y, w, x_d=None):
        names = list(state.params)
        mp_names = [n for n in names if n.startswith("message_passing.")]
        pred_names = [n for n in names if n.startswith("predictor.")]
        mp_params = [state.params[n] for n in mp_names]
        pred_params = [state.params[n] for n in pred_names]
        mp_gen = getattr(state, "shard_rng", None) if mp.dropout > 0 else None
        with torch.enable_grad():
            H_v, node_mask = _mp_local(model, g, dims, exchange, mp_gen, is_training=True)
            ls, lc = _local_readout(H_v, node_mask)
            gs = exchange.sum(ls.detach()).requires_grad_()
            gc = exchange.sum(lc.detach())
            Z = _head_input(model, _graph_embedding(model, gs, gc), x_d, True)
            head_drop = getattr(predictor, "dropout", 0.0) > 0
            preds = predictor.train_step(Z, head_drop, state.rng if head_drop else None)
            mask = torch.isfinite(y)
            no = torch.zeros_like(mask)
            loss = criterion.compute(criterion.update_state(
                criterion.init_state(), preds, torch.nan_to_num(y), mask, w.reshape(-1), no, no))
            *g_pred, d_gs = torch.autograd.grad(loss, pred_params + [gs], allow_unused=True)
            g_mp = torch.autograd.grad(ls, mp_params, grad_outputs=d_gs.expand_as(ls),
                                       allow_unused=True)
        g_mp = [torch.zeros_like(p) if gr is None else gr for p, gr in zip(mp_params, g_mp)]
        if isinstance(exchange, GroupExchange):
            for gr in g_mp:
                dist.all_reduce(gr, group=exchange.group)
        grads = dict(zip(mp_names, g_mp))
        grads.update((n, torch.zeros_like(p) if gr is None else gr)
                     for n, p, gr in zip(pred_names, pred_params, g_pred))
        adam_update(list(state.params.values()),
                    [grads.get(n, torch.zeros_like(p)) for n, p in state.params.items()],
                    state.mu, state.nu, state.step, rate(state.step))
        state.step += 1
        return loss.detach()

    return step


def bucket_edge_pad(P_pad: int) -> int:
    """Power-of-two edge-pad bucket (floor 128): one set of padded dims per
    bucket across a dataset of differently-sized molecules."""
    import math

    return 128 * (1 << max(0, math.ceil(math.log2(max(1, P_pad // 128)))))


def plan_buckets(data, n_shards: int):
    """Bucket routing of a list of ``Datum``: ``(keys, graphs,
    bucket_dims)``; ``keys[i]`` is molecule ``i``'s bucket (None: not
    partitionable over ``n_shards``, routed dense), ``graphs[i]`` its
    :class:`PartitionedGraph` (or None), ``bucket_dims[k]`` bucket ``k``'s
    common padded dims."""

    def try_nat(d):
        try:
            return natural_dims(d.mg, n_shards)
        except ValueError:
            return None

    nat = [try_nat(d) for d in data]
    keys = [None if x is None else bucket_edge_pad(x.P) for x in nat]
    buckets: dict[int, dict] = {}
    for k, x in zip(keys, nat):
        if k is None:
            continue
        b = buckets.setdefault(k, {"P": 0, "N": 0, "HN": 0, "HE": 0})
        for f in b:
            b[f] = max(b[f], getattr(x, f))
    built = []
    for i, (d, k) in enumerate(zip(data, keys)):
        if k is None:
            built.append(None)
            continue
        try:
            built.append(build_partitioned_graph(
                d.mg, n_shards, min_halo_nodes=buckets[k]["HN"], min_halo_edges=buckets[k]["HE"],
                min_owned_nodes=buckets[k]["N"], min_shard_edges=k, V_d=d.V_d))
        except ValueError:
            # the bucket's shared halo floors can exceed this molecule's
            # shards: route it dense rather than abort the run
            keys[i] = None
            built.append(None)
    bucket_dims = {}
    for k in set(buckets) & {kk for kk in keys if kk is not None}:
        members = [b[1] for b, kk in zip(built, keys) if kk == k]
        bucket_dims[k] = members[0]._replace(single_phase=all(m.single_phase for m in members))
    return keys, [None if b is None else b[0] for b in built], bucket_dims


def shard_layout(n_shards: int | None, mesh=None):
    """``(S, where)`` for ``--edge-partition N``: under a process group of
    world size W > 1 (``mesh``, or the default group), S = W shards, one per
    rank, where N is 0, None or at least W (the JAX package clamps N to its
    devices); otherwise S = N local shards in this process (1 where N is 0
    or None), on every rank alike. ``where`` is the ``Mesh`` or the int S
    (an int ``mesh`` is such a layout already)."""
    from chemprop_tpu_torch.parallel.sharding import current_mesh

    if isinstance(mesh, int):  # already a layout of local shards
        return mesh, mesh
    mesh = mesh if mesh is not None else current_mesh()
    world = 1 if mesh is None else mesh.size
    if world > 1 and (not n_shards or n_shards >= world):
        return world, mesh
    S = n_shards or 1
    return S, S


class PartitionedInference:
    """Mixed partitioned and dense inference over a list of ``Datum``: the
    bucket plan, the placed graphs and the dense batches are built once;
    :meth:`run` evaluates any model of the same configuration against them
    (an ensemble shares one plan). Dense-routed molecules go through the
    model's own forward in batches of up to ``dense_batch_size``; the rows
    come back in input order. ``plan`` takes a routing already computed
    (``(keys, graphs, bucket_dims)``), ``mesh`` the shards' place (default:
    :func:`shard_layout`'s)."""

    def __init__(self, model, data, n_shards: int | None = None,
                 encode_index: int | None = None, plan=None, mesh=None,
                 dense_batch_size: int = 64, train_space: bool = False,
                 device: str | torch.device | None = None):
        from chemprop_tpu_torch.data.collate import PadSpec, collate_batch
        from chemprop_tpu_torch.utils.device import resolve_device

        check_partitionable(model)
        self.device = resolve_device(device)  # raises where there is no GPU
        S, mesh = shard_layout(n_shards, mesh)
        self.mesh, self.encode_index, self.train_space = mesh, encode_index, train_space
        self.exchange = exchange_for(mesh)
        self.data = data
        self.keys, graphs, self.bucket_dims = plan if plan is not None else plan_buckets(data, S)
        self.graphs = [None if g is None else place(g, self.bucket_dims[k], self.exchange,
                                                    self.device)
                       for g, k in zip(graphs, self.keys)]
        self.x_ds = [None if d.x_d is None else
                     torch.as_tensor(np.asarray(d.x_d, np.float32).reshape(1, -1),
                                     device=self.device) for d in data]
        dense_idx = [i for i, k in enumerate(self.keys) if k is None]
        self.dense_batches = []
        if dense_idx:
            bs = max(1, min(dense_batch_size, len(dense_idx)))
            pad = PadSpec.for_graphs([data[i].mg for i in dense_idx], n_graphs=bs)
            for j in range(0, len(dense_idx), bs):
                chunk = dense_idx[j : j + bs]
                self.dense_batches.append((chunk, collate_batch([data[i] for i in chunk], pad)))

    def run(self, model=None) -> np.ndarray:
        """``[n, ...]`` outputs of ``model`` (a model of the session's
        configuration; its parameters are moved to the session's device)."""
        model = model.to(self.device).eval()
        apply_fns = {k: make_partitioned_apply(model, self.exchange, dims,
                                               train_space=self.train_space,
                                               encode_index=self.encode_index)
                     for k, dims in self.bucket_dims.items()}
        rows: list = [None] * len(self.data)
        for i, (k, g) in enumerate(zip(self.keys, self.graphs)):
            if k is not None:
                rows[i] = apply_fns[k](g, self.x_ds[i]).float().cpu().numpy()
        with torch.inference_mode():
            for chunk, tb in self.dense_batches:
                b = tb.to(self.device)
                if self.encode_index is not None:
                    out = model.encoding(b.bmg, b.V_d, b.X_d, i=self.encode_index)
                elif self.train_space:
                    out = model.train_step_preds(b.bmg, b.V_d, b.X_d, is_training=False)
                else:
                    out = model(b.bmg, b.V_d, b.X_d)
                out = out.float().cpu().numpy()
                for t, i in enumerate(chunk):
                    rows[i] = out[t : t + 1]
        return np.concatenate(rows, axis=0)


def predict_partitioned(model, data, n_shards: int | None = None,
                        encode_index: int | None = None,
                        device: str | torch.device | None = None) -> np.ndarray:
    """Inference over a list of ``Datum`` with each partitionable molecule
    cut across shards and a dense fallback for the rest, in input order
    (inference semantics; with ``encode_index`` learned fingerprints)."""
    return PartitionedInference(model, data, n_shards=n_shards, encode_index=encode_index,
                                device=device).run(model)
