"""Kernel E (``iter_bwd``, the whole backward of one bfloat16 iteration) over
the molecule tiles, on the CPU.

On a CUDA tensor with the batch's tile table the wrapper launches
``csrc/iter_bwd.cu``: one launch over the tiles, a cluster of ``d / 64``
blocks per tile, ``G`` formed in shared memory and never written. Here, on
the CPU, the wrapper takes its plain version; these tests hold
``message_iter`` with the batch's tile table handed in against the JAX
package's ``fused_message_iter`` with ``CHEMPROP_TPU_FUSED_BWD=1`` (its Pallas
kernels in interpret mode) on the layouts that stress a tile design (salts,
whose counter-ion owns no rows, zero-edge molecules, and a run of 200 "C"
between two molecules of one tile). They check the byte count of the
kernel's bound, the wrapper's refusals, that a batch holding a molecule
larger than a tile takes the form without a table and counts it in
``UNSERVED``, and that ``BondMessagePassing`` with dropout hands the table
down. test_torch_cuda.py runs the kernel itself on the card."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chemprop_tpu.data import MoleculeDatapoint
from chemprop_tpu.data.collate import PadSpec as JaxPadSpec
from chemprop_tpu.data.collate import batch_mol_graphs as jax_batch
from chemprop_tpu.featurizers.molgraph.molecule import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu.ops import fused_message as fm
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.nn import BondMessagePassing
from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED, KernelOptions, iter_bwd, message_iter
from chemprop_tpu_torch.ops.message import ITER2_TILE_ROWS, ITER_BWD_TILE_WIDTHS

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import iter_bwd_bytes  # noqa: E402

message_ops = sys.modules["chemprop_tpu_torch.ops.message"]  # the module, not ops.message()

LAYOUTS = {
    "salts": ["CCO", "CC(=O)[O-].[Na+]", "[Na+].CC(=O)[O-]", "C", "c1ccccc1"],
    "run_of_200_C": ["CCO", "CC(=O)[O-].[Na+]", "[Na+].CC(=O)[O-]"] + ["C"] * 200
    + ["c1ccccc1"],
}
D = 128
BF16_ULP = 2.0**-7


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def batches(request):
    """The layout batched by both packages to the same padded shapes."""
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(MoleculeDatapoint.from_smi(s).mol) for s in LAYOUTS[request.param]]
    pad = PadSpec.for_graphs(mgs)
    # the JAX kernels read a window of two 128-node chunks
    pad = pad._replace(n_nodes=max(pad.n_nodes, 256))
    jb = jax_batch(mgs, JaxPadSpec(*pad), sort_edges=True)
    assert jb.fused_ok
    tb = batch_mol_graphs(mgs, pad)
    assert tb.tile_ptr is not None
    return request.param, jb, tb


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("CHEMPROP_TPU_INTERPRET", "1")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The models here are small, and the test workers share the machine's
    cores: more than one intra-op thread only makes them wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(tb):
    return tb.src, tb.dst, tb.rev, tb.edge_ptr


def _rand(shape, seed, scale=1.0):
    """bf16-representable values from a numpy seed, as float32."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _iter_inputs(tb, seed=30):
    n = tb.E.shape[0]
    real = tb.edge_mask.numpy()
    H = np.maximum(_rand((n, D), seed), 0)
    H0 = _rand((n, D), seed + 1)
    H[~real] = 0
    H0[~real] = 0
    W = _rand((D, D), seed + 2, scale=D**-0.5)
    c = _rand((n, D), seed + 3)
    return H, H0, W, c


def _close_to_scale(got, want, max_share=0.05, mean_share=2e-3):
    """bfloat16 gradients: a saved y one ulp apart flips a ReLU mask where y
    is near zero and moves every value downstream by a few ulps of the
    largest term, so errors are held against the table's scale (the limits
    of test_torch_iter_ops.py::test_message_iter_gradients_match_jax)."""
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= max_share * scale, (err.max(), scale)
    assert err.mean() <= mean_share * scale, (err.mean(), scale)


def test_message_iter_with_tiles_matches_jax(batches, interpret, monkeypatch):
    name, jb, tb = batches
    if name == "run_of_200_C":  # the first tile's node range holds the run
        first = tb.dst[: int(tb.tile_ptr[1])][tb.edge_mask[: int(tb.tile_ptr[1])]]
        assert int(first[-1]) - int(first[0]) > 200
    monkeypatch.setenv("CHEMPROP_TPU_FUSED_BWD", "1")
    H, H0, W, c = _iter_inputs(tb)
    n_nodes = jb.V.shape[0]

    def f(H, H0, W):
        y = fm.fused_message_iter(H, H0, W, None, jb.src, jb.dst, jb.rev, n_nodes, jb.fused_window)
        return (y.astype(jnp.float32) * c).sum()

    jargs = [jnp.asarray(x, jnp.bfloat16) for x in (H, H0, W)]
    want = jax.grad(f, argnums=(0, 1, 2))(*jargs)

    seen = []
    real_iter_bwd = message_ops.iter_bwd

    def spy(*args, **kwargs):
        seen.append(kwargs.get("tiles"))
        return real_iter_bwd(*args, **kwargs)

    monkeypatch.setattr(message_ops, "iter_bwd", spy)
    targs = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (H, H0, W)]
    UNSERVED.clear()
    LAUNCHES.clear()
    y = message_iter(*targs, None, *_graph(tb), KernelOptions(fused_bwd=True), tb.tile_ptr)
    got = torch.autograd.grad(y, targs, torch.from_numpy(c).to(torch.bfloat16))
    assert len(seen) == 1 and seen[0] is tb.tile_ptr and UNSERVED["iter_bwd"] == 0
    assert sum(LAUNCHES.values()) == 0  # the plain versions: no kernel on the CPU
    real = tb.edge_mask.numpy()
    for label, a, w in zip(("dH", "dH0", "dW"), got, want):
        a, w = a.float().numpy(), np.asarray(w, np.float32)
        if a.shape[0] == tb.E.shape[0]:
            a, w = a[real], w[real]
        _close_to_scale(a, w)
    assert not got[0][~tb.edge_mask].any() and not got[1][~tb.edge_mask].any()


def test_iter_bwd_does_not_depend_on_the_table(batches):
    """On the CPU the wrapper is its plain version with or without a table:
    the same bits, and no launch."""
    _, _, tb = batches
    n = tb.E.shape[0]
    g, y, H = (torch.from_numpy(_rand((n, D), s)).to(torch.bfloat16) for s in (40, 41, 42))
    W = torch.from_numpy(_rand((D, D), 43, scale=D**-0.5)).to(torch.bfloat16)
    LAUNCHES.clear()
    with_table = iter_bwd(g, y.clamp_min(0), H, W, *_graph(tb), tiles=tb.tile_ptr)
    without = iter_bwd(g, y.clamp_min(0), H, W, *_graph(tb))
    assert all(torch.equal(a, b) for a, b in zip(with_table, without))
    assert sum(LAUNCHES.values()) == 0


@pytest.mark.parametrize("d", [128, 384])
def test_iter_bwd_bytes_counts_only_what_the_kernel_moves(batches, d):
    """The bound's byte count: g, y and H over the real rows only, dH and gz
    over every row, W and the float32 dW once, dst and rev of the real rows,
    the tile table and one entry of ptr."""
    _, _, tb = batches
    n_e, n_real = tb.E.shape[0], int(tb.edge_mask.sum())
    assert n_real < n_e
    want = ((3 * n_real + 2 * n_e) * d * 2 + d * d * 6 + 8 * n_real + 4 * tb.tile_ptr.numel()
            + 4)
    assert iter_bwd_bytes(tb, d) == want


def _malformed(tiles: torch.Tensor, n: int) -> dict[str, torch.Tensor]:
    t = tiles.tolist()
    return {
        "past_the_end": torch.tensor(t[:-1] + [n + 1], dtype=torch.int32),
        "short_of_the_end": torch.tensor(t[:-1] + [n - 1], dtype=torch.int32),
        "not_from_zero": torch.tensor([1] + t[1:], dtype=torch.int32),
        "tile_too_large": torch.tensor([0, ITER2_TILE_ROWS + 1]
                                       + list(range(2 * ITER2_TILE_ROWS, n, ITER2_TILE_ROWS))
                                       + [n], dtype=torch.int32),
        "descending": torch.tensor([0, 100, 50] + t[2:], dtype=torch.int32),
        "int64": tiles.long(),
        "two_dimensional": tiles[None],
        "one_offset": tiles[:1],
    }


@pytest.fixture(scope="module")
def salts():
    feat = SimpleMoleculeMolGraphFeaturizer()
    return batch_mol_graphs([feat(MoleculeDatapoint.from_smi(s).mol)
                             for s in LAYOUTS["salts"]])


def _zeros(b, d):
    z = torch.zeros((b.E.shape[0], d), dtype=torch.bfloat16)
    return z, z.clone(), z.clone(), torch.zeros((d, d), dtype=torch.bfloat16)


@pytest.mark.parametrize("case", ["past_the_end", "short_of_the_end", "not_from_zero",
                                  "tile_too_large", "descending", "int64", "two_dimensional",
                                  "one_offset"])
def test_refuses_a_malformed_table(salts, case):
    n = salts.E.shape[0]
    with pytest.raises(ValueError):
        iter_bwd(*_zeros(salts, D), *_graph(salts), tiles=_malformed(salts.tile_ptr, n)[case])


@pytest.mark.parametrize("d", [512, 640])
def test_refuses_a_width_the_tiled_kernel_does_not_take(salts, d):
    assert d not in ITER_BWD_TILE_WIDTHS
    with pytest.raises(ValueError):
        iter_bwd(*_zeros(salts, d), *_graph(salts), tiles=salts.tile_ptr)
    iter_bwd(*_zeros(salts, d), *_graph(salts))  # the form without a table takes it


def test_refuses_float32(salts):
    g, y, H, W = _zeros(salts, D)
    with pytest.raises(TypeError):
        iter_bwd(g.float(), y.float(), H.float(), W.float(), *_graph(salts),
                 tiles=salts.tile_ptr)


def _leaves(b, d, seed=9):
    gen = torch.Generator().manual_seed(seed)
    mask = ~b.edge_mask[:, None]
    H = torch.randn((b.E.shape[0], d), generator=gen).clamp_min(0).to(torch.bfloat16)
    H0 = torch.randn((b.E.shape[0], d), generator=gen).to(torch.bfloat16)
    W = (torch.randn((d, d), generator=gen) * d**-0.5).to(torch.bfloat16)
    return [H.masked_fill(mask, 0).requires_grad_(), H0.masked_fill(mask, 0).requires_grad_(),
            W.requires_grad_()]


def _grads(b, leaves, tiles):
    y = message_iter(*leaves, None, *_graph(b), KernelOptions(fused_bwd=True), tiles)
    return torch.autograd.grad(y.float().sum(), leaves)


def test_a_molecule_larger_than_a_tile_takes_the_form_without_a_table():
    feat = SimpleMoleculeMolGraphFeaturizer()
    b = batch_mol_graphs([feat(MoleculeDatapoint.from_smi(s).mol)
                          for s in ["CCO", "C", "[Na+].CC(=O)[O-]", "C" * 70]])
    assert b.tile_ptr is None  # a molecule of more rows than a tile
    leaves = _leaves(b, D)
    UNSERVED.clear()
    got = _grads(b, leaves, b.tile_ptr)
    assert UNSERVED["iter_bwd"] == 1  # one backward without a table
    want = _grads(b, leaves, None)
    assert UNSERVED["iter_bwd"] == 2
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("d", [128, 512])
def test_message_iter_counts_a_width_without_a_tiled_form(salts, d):
    """A table with a width the tiled kernel takes is served; another width
    takes the form without a table, counted in ``UNSERVED``."""
    UNSERVED.clear()
    _grads(salts, _leaves(salts, d), salts.tile_ptr)
    assert UNSERVED["iter_bwd"] == (0 if d in ITER_BWD_TILE_WIDTHS else 1)


def test_float32_and_the_unfused_backward_count_nothing(salts):
    UNSERVED.clear()
    leaves = _leaves(salts, D)
    f32 = [t.detach().float().requires_grad_() for t in leaves]
    y = message_iter(*f32, None, *_graph(salts), KernelOptions(fused_bwd=True), salts.tile_ptr)
    torch.autograd.grad(y.sum(), f32)
    y = message_iter(*leaves, None, *_graph(salts), KernelOptions(), salts.tile_ptr)
    torch.autograd.grad(y.float().sum(), leaves)
    assert UNSERVED["iter_bwd"] == 0


@pytest.mark.parametrize("depth", [3, 4])
def test_bond_message_passing_with_dropout_hands_the_table_down(salts, monkeypatch, depth):
    seen = []
    real_iter_bwd = message_ops.iter_bwd

    def spy(*args, **kwargs):
        seen.append(kwargs.get("tiles"))
        return real_iter_bwd(*args, **kwargs)

    monkeypatch.setattr(message_ops, "iter_bwd", spy)
    torch.manual_seed(0)
    mp = BondMessagePassing(depth=depth, compute_dtype=torch.bfloat16, dropout=0.1,
                            kernel_options=KernelOptions(fused_bwd=True))
    UNSERVED.clear()
    out = mp(salts, is_training=True, generator=torch.Generator().manual_seed(1))
    torch.autograd.grad(out.float().sum(), [p for p in mp.parameters() if p.requires_grad])
    # every iteration after the first runs message_iter
    assert len(seen) == depth - 2 and all(t is salts.tile_ptr for t in seen)
    assert UNSERVED["iter_bwd"] == 0
