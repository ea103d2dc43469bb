"""Edge partitioning: D-MPNN message passing for one graph cut across shards
(cf. ``chemprop_tpu/ops/edge_partition.py``).

A graph too large for one device's batch slice (a giant polymer) has its
dst-sorted edge table cut into contiguous slices, one per shard. Shard ``s``
owns edges ``[cut_s, cut_{s+1})`` and nodes ``[lo_s, lo_{s+1})``, and keeps
its node accumulators in the extended layout ``[left halo (HN) | owned (N) |
right halo (HN)]``. Each message op:

1. sums ``H`` locally over the extended layout: contributions to nodes a
   neighbour owns land in the halo rows;
2. sends the halo rows to the neighbour that owns them, which adds them in:
   every owned accumulator is now exact;
3. sends the finalised boundary rows back, so each shard holds its halos
   for the ``src`` gather;
4. sends the first and last ``HE`` rows of ``H`` sideways, so that reverse
   edges across a cut resolve locally.

The per-shard work goes through the port's kernels. Within a shard
``dst_ext`` ascends (``loc_node`` is monotone and padding edges point at the
sacrificial row ``N + 2 HN``, the last), so each accumulator is kernel C,
the sorted segment sum, over a CSR pointer built on the host; the ``src``
and ``rev`` gathers are kernel I, the row gather. Their backwards are the
same two kernels: the sum's is the gather by ``dst``; the ``src`` gather's
is C over the edges sorted by ``src`` (a permutation built on the host, the
cotangent gathered into that order by I); the ``rev`` gather's is I by the
inverse of ``rev`` (injective on real edges). The JAX package runs these
steps through ``jax.ops.segment_sum`` and plain indexing; the function is
the same. The tables are float32: the partitioned path computes in the
parameters' dtype, as the JAX one does.

The exchange (``ppermute`` in the JAX package) is :func:`shift`, a
``torch.autograd.Function`` whose backward is the reverse shift, with zeros
at the graph's ends. It has two implementations behind :class:`Exchange`:

* :class:`LocalExchange`: S shards stacked on a leading axis in one process,
  the shift a slice along that axis (the counterpart of a one-process JAX
  mesh, and the one way to run S > 1 on a machine with one card);
* :class:`GroupExchange`: one shard per rank of a ``torch.distributed``
  process group, the shift ``batch_isend_irecv`` with the neighbour ranks.

Every table here carries a leading axis of the shards the process holds:
all S for the local exchange, the rank's one for the group's.
Divergence from the JAX signatures: :func:`halo_node_accumulators` and
:func:`halo_message` take a :class:`HaloTables` (the plan's index arrays on
the device, with the host ints of the boundary positions, so no ``.item()``)
and an :class:`Exchange` in place of the per-shard arrays, ``axis_name`` and
``n_shards``."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from chemprop_tpu_torch.ops.gather import row_gather
from chemprop_tpu_torch.ops.segment import sorted_segment_sum


class EdgePartitionPlan(NamedTuple):
    """Host-built partition of ONE dst-sorted edge table (numpy arrays).

    The index arrays are stacked ``[n_shards, P]`` and localised into the
    extended layouts above; padding edges carry ``edge_mask=False`` and
    point at a sacrificial row. ``n_owned``/``n_edges`` are the per-shard
    real counts, the boundary slices' positions."""

    n_shards: int
    P: int  # padded edges per shard
    N: int  # padded owned nodes per shard
    HN: int  # node halo rows
    HE: int  # edge halo rows
    src_ext: np.ndarray  # [S, P] int32, into [HN | N | HN] (+1 sacrificial)
    dst_ext: np.ndarray  # [S, P] int32, same layout
    rev_ext: np.ndarray  # [S, P] int32, into [HE | P | HE] (+1 sacrificial)
    edge_mask: np.ndarray  # [S, P] bool
    node_lo: np.ndarray  # [S] global id of the first owned node
    n_owned: np.ndarray  # [S] int32 real owned node count
    n_edges: np.ndarray  # [S] int32 real edge count


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def partition_edges(
    src: np.ndarray,
    dst: np.ndarray,
    rev: np.ndarray,
    n_nodes: int,
    n_shards: int,
    min_halo_nodes: int = 8,
    min_halo_edges: int = 8,
    min_owned_nodes: int = 1,
    min_shard_edges: int = 1,
) -> EdgePartitionPlan:
    """Cut a dst-sorted edge table into ``n_shards`` contiguous slices.

    Node ownership follows the dst at each cut (the straddled node belongs
    to the right shard; its left-shard contributions travel through the
    halo). Halo widths come from the graph's actual src/rev spans, rounded
    up to multiples of 8; a graph whose bandwidth exceeds its neighbours'
    boundary ranges raises ``ValueError``. The ``min_*`` floors force common
    padded dims across a dataset."""
    E = len(dst)
    if E == 0 or n_shards < 1:
        raise ValueError("partition_edges needs a non-empty edge table")
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    rev = np.asarray(rev, np.int64)
    if not (np.diff(dst) >= 0).all():
        raise ValueError("edge table must be dst-sorted")

    cuts = [round(s * E / n_shards) for s in range(n_shards + 1)]
    node_lo = np.array([dst[c] if c < E else n_nodes for c in cuts], np.int64)
    owned = node_lo[1:] - node_lo[:-1]
    n_edges = np.diff(cuts)
    N = _round_up(max(min_owned_nodes, int(owned.max())), 8)
    P = _round_up(max(min_shard_edges, int(n_edges.max())), 128)

    need_hn = 1  # dst spills at most onto the straddled boundary node
    need_he = 1
    for s in range(n_shards):
        a, b = cuts[s], cuts[s + 1]
        if a == b:
            continue
        lo, hi = node_lo[s], node_lo[s + 1]
        need_hn = max(
            need_hn,
            int(np.maximum(lo - src[a:b], 0).max(initial=0)),
            int(np.maximum(src[a:b] - (hi - 1), 0).max(initial=0)),
            int(np.maximum(dst[a:b] - (hi - 1), 0).max(initial=0)),
        )
        need_he = max(
            need_he,
            int(np.maximum(a - rev[a:b], 0).max(initial=0)),
            int(np.maximum(rev[a:b] - (b - 1), 0).max(initial=0)),
        )
    HN = _round_up(max(need_hn, min_halo_nodes), 8)
    HE = _round_up(max(need_he, min_halo_edges), 8)
    # a shard's halo is served by its neighbour's real rows
    if n_shards > 1 and HN > int(owned.min()):
        raise ValueError(
            f"node halo {HN} exceeds a shard's owned range ({int(owned.min())}): "
            "graph bandwidth too large for this shard count — use fewer shards"
        )
    if n_shards > 1 and HE > int(n_edges.min()):
        raise ValueError(
            f"edge halo {HE} exceeds a shard's edge count ({int(n_edges.min())}): "
            "reverse-edge span too large for this shard count — use fewer shards"
        )

    S = n_shards
    sac_n = N + 2 * HN
    sac_e = P + 2 * HE
    src_ext = np.full((S, P), sac_n, np.int32)
    dst_ext = np.full((S, P), sac_n, np.int32)
    rev_ext = np.full((S, P), sac_e, np.int32)
    mask = np.zeros((S, P), bool)

    def loc_node(nodes: np.ndarray, s: int) -> np.ndarray:
        lo, hi = node_lo[s], node_lo[s + 1]
        out = np.where(
            nodes < lo,
            HN - (lo - nodes),
            np.where(nodes < hi, HN + (nodes - lo), HN + N + (nodes - hi)),
        )
        return out.astype(np.int32)

    for s in range(S):
        a, b = cuts[s], cuts[s + 1]
        k = b - a
        if k == 0:
            continue
        src_ext[s, :k] = loc_node(src[a:b], s)
        dst_ext[s, :k] = loc_node(dst[a:b], s)
        rev_ext[s, :k] = np.where(
            rev[a:b] < a,
            HE - (a - rev[a:b]),
            np.where(rev[a:b] < b, HE + (rev[a:b] - a), HE + P + (rev[a:b] - b)),
        ).astype(np.int32)
        mask[s, :k] = True
    return EdgePartitionPlan(
        n_shards=S, P=P, N=N, HN=HN, HE=HE, src_ext=src_ext, dst_ext=dst_ext, rev_ext=rev_ext,
        edge_mask=mask, node_lo=node_lo[:-1].astype(np.int32),
        n_owned=owned.astype(np.int32), n_edges=n_edges.astype(np.int32),
    )


def shard_args(plan: EdgePartitionPlan):
    """The per-shard arrays of the plan, in the JAX package's order."""
    return (plan.src_ext, plan.dst_ext, plan.rev_ext, plan.edge_mask, plan.n_owned,
            plan.n_edges)


# ------------------------------------------------------------------ exchange
class Exchange:
    """Moves ``[S_held, h, d]`` boundary tables one shard up or down the
    chain of ``n_shards`` shards. ``held`` lists the shards this process
    holds, in the order of the leading axis."""

    n_shards: int
    held: Sequence[int]

    def move(self, x: torch.Tensor, direction: int) -> torch.Tensor:
        """``out[s] = x[s - direction]`` for every held shard ``s``; zeros
        where that shard does not exist (the graph's ends)."""
        raise NotImplementedError

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over every shard of the graph of a per-shard ``[S_held,
        ...]`` table, the same on every holder: ``[...]``."""
        raise NotImplementedError


class LocalExchange(Exchange):
    """All ``n_shards`` shards stacked in this process."""

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError("n_shards must be at least 1")
        self.n_shards = n_shards
        self.held = range(n_shards)

    def move(self, x: torch.Tensor, direction: int) -> torch.Tensor:
        zero = torch.zeros_like(x[:1])
        if self.n_shards == 1:
            return torch.zeros_like(x)
        if direction > 0:
            return torch.cat([zero, x[:-1]])
        return torch.cat([x[1:], zero])

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(0)


class GroupExchange(Exchange):
    """One shard per rank of a ``torch.distributed`` process group (all of
    its ranks, shard ``k`` on the group's rank ``k``)."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        self.rank = dist.get_rank(group)
        self.n_shards = dist.get_world_size(group)
        self.held = (self.rank,)

    def _global(self, rank: int) -> int:
        import torch.distributed as dist

        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def move(self, x: torch.Tensor, direction: int) -> torch.Tensor:
        import torch.distributed as dist

        out = torch.zeros_like(x)
        ops = []
        to, frm = self.rank + direction, self.rank - direction
        send = x[0].contiguous()
        if 0 <= to < self.n_shards:
            ops.append(dist.P2POp(dist.isend, send, self._global(to), self.group))
        recv = out[0]
        if 0 <= frm < self.n_shards:
            ops.append(dist.P2POp(dist.irecv, recv, self._global(frm), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        total = x.sum(0).contiguous()
        dist.all_reduce(total, group=self.group)
        return total


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, exchange, direction):
        ctx.exchange, ctx.direction = exchange, direction
        return exchange.move(x, direction)

    @staticmethod
    def backward(ctx, g):
        return ctx.exchange.move(g.contiguous(), -ctx.direction), None, None


def shift(x: torch.Tensor, direction: int, exchange: Exchange) -> torch.Tensor:
    """The ``ppermute`` by one shard (+1: toward higher shard ids), with zeros
    where no shard sends; differentiable (its transpose is the reverse
    shift)."""
    return _Shift.apply(x, exchange, direction)


# -------------------------------------------------------------------- tables
def _csr(ids: np.ndarray, n_seg: int) -> np.ndarray:
    return np.searchsorted(ids, np.arange(n_seg + 1)).astype(np.int32)


class HaloTables:
    """The index tables of the held shards of one plan, on ``device``: the
    per-shard index arrays flattened over the held shards (each shard's ids
    offset by its position), the CSR pointers of the sums, the permutation
    of the ``src`` gather's backward and the inverse of ``rev``; the
    boundary positions (``n_owned``, ``n_edges``) stay host ints."""

    def __init__(self, src_ext, dst_ext, rev_ext, edge_mask, n_owned, n_edges,
                 N: int, HN: int, HE: int, device: str | torch.device = "cpu"):
        src_ext, dst_ext, rev_ext = (np.asarray(a, np.int64) for a in (src_ext, dst_ext, rev_ext))
        S, P = src_ext.shape
        self.S, self.P, self.N, self.HN, self.HE = S, P, N, HN, HE
        self.n_owned = [int(x) for x in np.asarray(n_owned).reshape(-1)]
        self.n_edges = [int(x) for x in np.asarray(n_edges).reshape(-1)]
        R = N + 2 * HN + 1  # rows of an accumulator table, the sacrificial one last
        RE = P + 2 * HE + 1  # rows of the sideways edge table
        self.R, self.RE = R, RE
        node_off = (np.arange(S) * R)[:, None]
        dst = (dst_ext + node_off).reshape(-1)
        src = (src_ext + node_off).reshape(-1)
        rev = (rev_ext + (np.arange(S) * RE)[:, None]).reshape(-1)
        if not (np.diff(dst) >= 0).all():
            raise ValueError("dst_ext must ascend within every shard")
        order = np.argsort(src, kind="stable")
        # the rev gather is injective on real edges: its backward gathers the
        # cotangent by the inverse, and S * P (an appended zero row) elsewhere
        inv_rev = np.full(S * RE, S * P, np.int64)
        real = np.asarray(edge_mask, bool).reshape(-1)
        inv_rev[rev[real]] = np.nonzero(real)[0]
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
        self.edge_mask = torch.from_numpy(np.asarray(edge_mask, bool)).to(device)
        self.dst, self.dst_ptr = t(dst), t(_csr(dst, S * R))
        self.src = t(src)
        self.src_order, self.src_sorted = t(order), t(src[order])
        self.src_ptr = t(_csr(src[order], S * R))
        self.rev, self.rev_inv = t(rev), t(inv_rev)
        # [S, h] rows of the boundary tails: [count - h, count), clamped into
        # the table as the JAX package's dynamic slice clamps
        self.own_tail = self._tails(self.n_owned, HN, N, device)
        self.edge_tail = self._tails(self.n_edges, HE, P, device)

    @staticmethod
    def _tails(counts: list[int], h: int, length: int, device) -> torch.Tensor:
        rows = []
        for s, c in enumerate(counts):
            start = min(max(c - h, 0), max(length - h, 0))
            rows.append(s * length + start + np.arange(h))
        return torch.from_numpy(np.stack(rows).astype(np.int64)).to(device)

    @classmethod
    def from_plan(cls, plan: EdgePartitionPlan, held: Sequence[int] | None = None,
                  device: str | torch.device = "cpu") -> "HaloTables":
        """The tables of the shards ``held`` (all by default) of ``plan``."""
        sel = list(range(plan.n_shards)) if held is None else list(held)
        return cls(plan.src_ext[sel], plan.dst_ext[sel], plan.rev_ext[sel], plan.edge_mask[sel],
                   plan.n_owned[sel], plan.n_edges[sel], plan.N, plan.HN, plan.HE, device)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def _with_zero_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


class _HaloSum(torch.autograd.Function):
    """``[S, P, d]`` edge rows -> ``[S, R, d]`` sums by ``dst_ext`` (kernel
    C); backward: the gather by ``dst_ext`` (kernel I)."""

    @staticmethod
    def forward(ctx, H, tables):
        ctx.tables = tables
        out = sorted_segment_sum(_flat(H), tables.dst, tables.dst_ptr)
        return out.reshape(tables.S, tables.R, -1)

    @staticmethod
    def backward(ctx, g):
        tb = ctx.tables
        # the last row of the flattened table is the last shard's sacrificial
        # one, which no output reads: the row gather's zero rule is exact
        return row_gather(_flat(g), tb.dst).reshape(tb.S, tb.P, -1), None


class _SrcGather(torch.autograd.Function):
    """``[S, R, d]`` accumulators -> ``[S, P, d]`` rows at ``src_ext``
    (kernel I); backward: C over the edges sorted by ``src``."""

    @staticmethod
    def forward(ctx, acc, tables):
        ctx.tables = tables
        return row_gather(_flat(acc), tables.src).reshape(tables.S, tables.P, -1)

    @staticmethod
    def backward(ctx, g):
        tb = ctx.tables
        g_sorted = row_gather(_with_zero_row(_flat(g)), tb.src_order)
        return sorted_segment_sum(g_sorted, tb.src_sorted, tb.src_ptr).reshape(tb.S, tb.R, -1), None


class _RevGather(torch.autograd.Function):
    """``[S, RE, d]`` extended edge rows -> ``[S, P, d]`` rows at ``rev_ext``
    (kernel I); backward: I by the inverse of ``rev_ext``."""

    @staticmethod
    def forward(ctx, Hh, tables):
        ctx.tables = tables
        return row_gather(_flat(Hh), tables.rev).reshape(tables.S, tables.P, -1)

    @staticmethod
    def backward(ctx, g):
        tb = ctx.tables
        return row_gather(_with_zero_row(_flat(g)), tb.rev_inv).reshape(tb.S, tb.RE, -1), None


def halo_sum(H: torch.Tensor, tables: HaloTables) -> torch.Tensor:
    """Local sums of ``[S, P, d]`` edge rows over the extended node layout,
    the sacrificial row last: ``[S, N + 2 HN + 1, d]``."""
    return _HaloSum.apply(H, tables)


def gather_src_ext(acc: torch.Tensor, tables: HaloTables) -> torch.Tensor:
    """``acc[src_ext]`` per shard, ``acc`` ``[S, N + 2 HN + 1, d]`` with a zero
    sacrificial row."""
    return _SrcGather.apply(acc, tables)


def gather_rev_ext(Hh: torch.Tensor, tables: HaloTables) -> torch.Tensor:
    """``Hh[rev_ext]`` per shard, ``Hh`` ``[S, P + 2 HE + 1, d]`` with a zero
    sacrificial row."""
    return _RevGather.apply(Hh, tables)


def tail(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Rows ``rows`` (``[S, h]`` flat row ids, :attr:`HaloTables.own_tail` or
    ``edge_tail``) of the ``[S, L, d]`` table ``x``: ``[S, h, d]``."""
    S, h = rows.shape
    return x.reshape(-1, x.shape[-1])[rows.reshape(-1)].reshape(S, h, -1)


def _add_rows(x: torch.Tensor, rows: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x`` with ``y`` added at ``rows`` (out of place)."""
    flat = x.reshape(-1, x.shape[-1]).index_add(0, rows.reshape(-1), _flat(y))
    return flat.reshape(x.shape)


def masked(H: torch.Tensor, tables: HaloTables) -> torch.Tensor:
    return torch.where(tables.edge_mask[..., None], H, torch.zeros((), dtype=H.dtype,
                                                                   device=H.device))


def halo_node_accumulators(
    H: torch.Tensor, tables: HaloTables, exchange: Exchange, with_halo: bool,
    single_phase: bool = False,
) -> torch.Tensor:
    """Exact per-node sums ``sum_{e: dst_e = v} H_e`` for the owned range
    (steps 1-2 of the module doc): ``[S, N, d]``; with ``with_halo`` the
    finalised boundary rows of the neighbours too (step 3): ``[S, N + 2 HN,
    d]``.

    ``single_phase`` folds steps 2 and 3 into one exchange: every shard sends
    its halo partials and its boundary partials together, and each receiver
    finalises its halo copies itself. Exact only where every shard owns at
    least ``2 HN`` nodes (``PartitionDims.single_phase``)."""
    HN, N = tables.HN, tables.N
    Hm = masked(H, tables)
    ext = halo_sum(Hm, tables)[:, :-1]  # drop the sacrificial row
    own = ext[:, HN : HN + N]
    if with_halo and single_phase:
        from_left = shift(ext[:, HN + N :], +1, exchange)
        from_right = shift(ext[:, :HN], -1, exchange)
        tail_partial = shift(tail(own, tables.own_tail), +1, exchange)
        head_partial = shift(own[:, :HN], -1, exchange)
        own = torch.cat([own[:, :HN] + from_left, own[:, HN:]], dim=1)
        own = _add_rows(own, tables.own_tail, from_right)
        left_halo = tail_partial + ext[:, :HN]
        right_halo = head_partial + ext[:, HN + N :]
        return torch.cat([left_halo, own, right_halo], dim=1)
    from_left = shift(ext[:, HN + N :], +1, exchange)  # my head rows
    from_right = shift(ext[:, :HN], -1, exchange)  # my tail rows
    own = torch.cat([own[:, :HN] + from_left, own[:, HN:]], dim=1)
    own = _add_rows(own, tables.own_tail, from_right)
    if not with_halo:
        return own
    left_halo = shift(tail(own, tables.own_tail), +1, exchange)
    right_halo = shift(own[:, :HN], -1, exchange)
    return torch.cat([left_halo, own, right_halo], dim=1)


def with_sacrificial_row(acc: torch.Tensor) -> torch.Tensor:
    """``[S, L, d]`` -> ``[S, L + 1, d]`` with a zero last row."""
    return torch.cat([acc, acc.new_zeros((acc.shape[0], 1, acc.shape[2]))], dim=1)


def edge_halo(Hm: torch.Tensor, tables: HaloTables, exchange: Exchange) -> torch.Tensor:
    """The extended edge table ``[left HE | Hm | right HE | 0]`` of masked
    rows ``Hm`` (step 4), for the ``rev`` gather."""
    left_H = shift(tail(Hm, tables.edge_tail), +1, exchange)
    right_H = shift(Hm[:, : tables.HE], -1, exchange)
    return with_sacrificial_row(torch.cat([left_H, Hm, right_H], dim=1))


def halo_message(
    H: torch.Tensor, tables: HaloTables, exchange: Exchange, single_phase: bool = False,
) -> torch.Tensor:
    """The D-MPNN message ``M[e] = sum_{k: dst_k = src_e} H_k - H_rev(e)`` of
    the held shards' edge slices ``H`` (``[S, P, d]``), with the boundary
    exchange (steps 1-4); padding rows are zero. The sideways exchange is
    issued first, as in the JAX package."""
    Hm = masked(H, tables)
    Hh = edge_halo(Hm, tables, exchange)
    Mn = halo_node_accumulators(Hm, tables, exchange, with_halo=True,
                                single_phase=single_phase)
    M = gather_src_ext(with_sacrificial_row(Mn), tables) - gather_rev_ext(Hh, tables)
    return masked(M, tables).to(H.dtype)
