"""The port's edge partition (``chemprop_tpu_torch/ops/edge_partition.py``)
against the JAX package's (``chemprop_tpu/ops/edge_partition.py``): the plan
bit for bit with the same errors, and the halo ops of the local exchange
(S shards stacked in one process, through kernels C and I, whose plain
versions run here) within 1e-5 of JAX's under ``shard_map`` on the test
session's host devices, at S = 1, 2 and 4, in both phases, forward and
backward. A 1200-node chain with short cross-links, as the JAX package's
own tests use."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from chemprop_tpu.ops import edge_partition as jep
from chemprop_tpu.parallel.shard_train import _shard_map
from chemprop_tpu_torch.ops import edge_partition as tep

D = 16
TOL = 1e-5  # f32 on both sides; only summation orders differ


def chain_graph(n_nodes: int, seed: int = 0):
    """A chain with random short-range extra bonds, dst-sorted: ``src, dst,
    rev``."""
    rng = np.random.default_rng(seed)
    bonds = [(i, i + 1) for i in range(n_nodes - 1)]
    for _ in range(n_nodes // 10):
        i = int(rng.integers(0, n_nodes - 4))
        bonds.append((i, i + int(rng.integers(2, 4))))
    pairs = [p for u, v in bonds for p in ((u, v), (v, u))]
    src = np.array([p[0] for p in pairs])
    dst = np.array([p[1] for p in pairs])
    rev = np.arange(len(pairs)).reshape(-1, 2)[:, ::-1].reshape(-1)
    order = np.argsort(dst, kind="stable")
    inv = np.argsort(order)
    return src[order], dst[order], inv[rev[order]]


@pytest.fixture(scope="module")
def graph():
    n = 1200
    return (n, *chain_graph(n))


def _stacked(plan, x: np.ndarray) -> np.ndarray:
    """The rows of a dst-sorted edge table in the plan's per-shard slices."""
    S = plan.n_shards
    cuts = np.concatenate([[0], np.cumsum(plan.n_edges)])
    out = np.zeros((S, plan.P, x.shape[1]), np.float32)
    for s in range(S):
        out[s, : cuts[s + 1] - cuts[s]] = x[cuts[s] : cuts[s + 1]]
    return out


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_partition_edges_bit_equal(graph, n_shards):
    n, src, dst, rev = graph
    want = jep.partition_edges(src, dst, rev, n, n_shards)
    got = tep.partition_edges(src, dst, rev, n, n_shards)
    for name in jep.EdgePartitionPlan._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, int):
            assert a == b, name
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
            assert np.asarray(a).dtype == np.asarray(b).dtype, name


@pytest.mark.parametrize("case", ["unsorted", "empty", "halo", "edge_halo", "floors"])
def test_partition_edges_errors_equal(graph, case):
    n, src, dst, rev = graph
    args = {
        "unsorted": ((src, dst[::-1], rev, n, 2), {}),
        "empty": ((src[:0], dst[:0], rev[:0], n, 2), {}),
        # more shards than the graph's bandwidth allows
        "halo": ((src[:40], dst[:40], rev[:40] % 40, 21, 16), {}),
        "edge_halo": ((src, dst, rev, n, 2), {"min_halo_edges": 5000}),
        "floors": ((src, dst, rev, n, 2), {"min_halo_nodes": 4000}),
    }[case]
    with pytest.raises(ValueError) as want:
        jep.partition_edges(*args[0], **args[1])
    with pytest.raises(ValueError) as got:
        tep.partition_edges(*args[0], **args[1])
    assert str(got.value) == str(want.value)


def _jax_halo(plan, fn, H: np.ndarray):
    """``fn(H_local, *shard args)`` under shard_map over ``plan.n_shards``
    host devices, and its VJP with a seeded cotangent."""
    S = plan.n_shards
    mesh = JaxMesh(np.array(jax.devices()[:S]), ("shards",))
    args = [jnp.asarray(a) for a in jep.shard_args(plan)]

    def body(H_loc, *shard):
        return fn(H_loc[0], *(a[0] for a in shard))[None]

    sm = _shard_map(body, mesh, (P("shards"),) * 7, P("shards"))
    out = jax.jit(lambda h: sm(h, *args))(jnp.asarray(H))
    g = np.random.default_rng(7).standard_normal(out.shape).astype(np.float32)
    dH = jax.jit(lambda h, c: jax.vjp(lambda x: sm(x, *args), h)[1](c)[0])(jnp.asarray(H),
                                                                          jnp.asarray(g))
    return np.asarray(out), np.asarray(dH), g


def _port_halo(plan, fn, H: np.ndarray, g: np.ndarray):
    tables = tep.HaloTables.from_plan(plan)
    Ht = torch.from_numpy(H).requires_grad_()
    out = fn(Ht, tables, tep.LocalExchange(plan.n_shards))
    (dH,) = torch.autograd.grad(out, Ht, torch.from_numpy(g))
    return out.detach().numpy(), dH.numpy()


def _plan_and_H(graph, n_shards, single_phase):
    n, src, dst, rev = graph
    plan = tep.partition_edges(src, dst, rev, n, n_shards)
    if single_phase and n_shards > 1:
        assert int(plan.n_owned.min()) >= 2 * plan.HN  # the one-phase exchange is exact here
    H = np.random.default_rng(1).standard_normal((len(dst), D)).astype(np.float32)
    return plan, _stacked(plan, H), H


@pytest.mark.parametrize("single_phase", [False, True], ids=["two_phase", "one_phase"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_halo_message_matches_jax(graph, n_shards, single_phase):
    plan, Hs, H = _plan_and_H(graph, n_shards, single_phase)
    N, HN, HE = plan.N, plan.HN, plan.HE

    def jfn(H_loc, src_e, dst_e, rev_e, mask, n_own, n_edg):
        return jep.halo_message(H_loc, src_e, dst_e, rev_e, mask, n_own, n_edg, N, HN, HE,
                                "shards", n_shards, single_phase=single_phase)

    want, want_dH, g = _jax_halo(plan, jfn, Hs)
    got, got_dH = _port_halo(
        plan, lambda h, t, x: tep.halo_message(h, t, x, single_phase=single_phase), Hs, g)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_dH, want_dH, rtol=TOL, atol=TOL)
    # and both are the single-device message on the real rows
    n, src, dst, rev = graph
    acc = np.zeros((n, D), np.float32)
    np.add.at(acc, dst, H)
    np.testing.assert_allclose(np.concatenate([got[s, : plan.n_edges[s]] for s in range(n_shards)]),
                               acc[src] - H[rev], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("with_halo", [False, True], ids=["owned", "with_halo"])
@pytest.mark.parametrize("single_phase", [False, True], ids=["two_phase", "one_phase"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_halo_node_accumulators_match_jax(graph, n_shards, single_phase, with_halo):
    plan, Hs, _ = _plan_and_H(graph, n_shards, single_phase)
    N, HN = plan.N, plan.HN

    def jfn(H_loc, src_e, dst_e, rev_e, mask, n_own, n_edg):
        return jep.halo_node_accumulators(H_loc, dst_e, mask, n_own, N, HN, "shards", n_shards,
                                          with_halo=with_halo, single_phase=single_phase)

    want, want_dH, g = _jax_halo(plan, jfn, Hs)
    got, got_dH = _port_halo(plan, lambda h, t, x: tep.halo_node_accumulators(
        h, t, x, with_halo=with_halo, single_phase=single_phase), Hs, g)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_dH, want_dH, rtol=TOL, atol=TOL)


def test_local_shift_and_its_transpose():
    """The local exchange moves each shard's table one shard along, zeros at
    the ends, and its backward is the reverse move."""
    x = torch.arange(4 * 2 * 3, dtype=torch.float32).reshape(4, 2, 3).requires_grad_()
    ex = tep.LocalExchange(4)
    up = tep.shift(x, +1, ex)
    assert torch.equal(up[0], torch.zeros(2, 3)) and torch.equal(up[1:], x[:-1].detach())
    (dx,) = torch.autograd.grad(up, x, torch.ones_like(up))
    assert torch.equal(dx[:-1], torch.ones(3, 2, 3)) and torch.equal(dx[-1], torch.zeros(2, 3))
    down = tep.shift(x, -1, ex)
    assert torch.equal(down[-1], torch.zeros(2, 3)) and torch.equal(down[:-1], x[1:].detach())
    assert torch.equal(tep.shift(x[:1], +1, tep.LocalExchange(1)), torch.zeros(1, 2, 3))


def test_halo_ops_launch_only_c_and_i(graph):
    """Every sum and gather of a halo message, forward and backward, is one
    of the two kernels' wrappers (their plain versions on the CPU)."""
    import chemprop_tpu_torch.ops.edge_partition as mod

    plan, Hs, _ = _plan_and_H(graph, 4, False)
    calls = []
    seg, gat = mod.sorted_segment_sum, mod.row_gather
    mod.sorted_segment_sum = lambda *a, **k: calls.append("C") or seg(*a, **k)
    mod.row_gather = lambda *a, **k: calls.append("I") or gat(*a, **k)
    try:
        tables = tep.HaloTables.from_plan(plan)
        H = torch.from_numpy(Hs).requires_grad_()
        out = tep.halo_message(H, tables, tep.LocalExchange(4))
        assert calls == ["C", "I", "I"]  # the sum, the src and the rev gathers
        out.sum().backward()
        # backward: the rev gather's (I), the src gather's (I then C), the sum's (I)
        assert sorted(calls[3:]) == ["C", "I", "I", "I"]
    finally:
        mod.sorted_segment_sum, mod.row_gather = seg, gat
