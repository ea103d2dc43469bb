"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor the JAX package, so that it runs where they are not
installed; there, skip the repository's conftest (which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from chemprop_tpu_torch.chem import make_mol
from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer
from chemprop_tpu_torch.models import load_model
from chemprop_tpu_torch.ops import (
    LAUNCHES,
    UNSERVED,
    KernelOptions,
    bwd_message,
    bwd_message_nodes,
    bwd_message_premul,
    first_iter,
    fused_iter,
    fused_iter2,
    grad_weight,
    iter_bwd,
    loop_readout,
    message,
    message_iter,
    row_gather,
    sorted_segment_sum,
    sorted_segment_sum_counts,
)
from chemprop_tpu_torch.ops.gather import row_gather_plain
from chemprop_tpu_torch.ops.grad_weight import grad_weight_plain, matmul
from chemprop_tpu_torch.ops.message import (
    ITER2_TILE_ROWS,
    bwd_message_nodes_info,
    bwd_message_nodes_plain,
    bwd_message_plain,
    bwd_message_premul_plain,
    fused_iter2_info,
    fused_iter2_plain,
    fused_iter_plain,
    iter_bwd_info,
    iter_bwd_plain,
    message_plain,
)
from chemprop_tpu_torch.ops.segment import KERNEL_DTYPES, sorted_segment_sum_plain

pytestmark = pytest.mark.cuda

DATA = Path(__file__).resolve().parent / "data"
SMIS = [
    "CCO",
    "c1ccccc1",
    "CC(=O)Nc1ccc(O)cc1",
    "CNC(C)Cc1ccccc1",
    "CC(C)CC1=CC=C(C=C1)C(C)C(=O)O",
    "c1ccc2ccccc2c1",
    "CC(=O)OC1=CC=CC=C1C(=O)O",
    "C1CCNCC1",
    "C",  # zero-edge molecule: an empty segment
    "O=[N+]([O-])c1ccc(Cl)cc1",
]
BF16_ULP = 2.0**-7  # relative spacing of bfloat16 (8 significant bits)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bmg(cuda):
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(make_mol(s)) for s in SMIS]
    return batch_mol_graphs(mgs, PadSpec(256, 768, len(SMIS))).to(cuda)


def _graph(b):
    return b.src, b.dst, b.rev, b.edge_ptr


def _randn(shape, seed, device, dtype=torch.float32, scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device) * scale).to(dtype)


@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_message_matches_plain(bmg, cuda, d, dtype):
    H = _randn((bmg.E.shape[0], d), 0, cuda, dtype)
    before = LAUNCHES["message"]
    got = message(H, *_graph(bmg))
    assert LAUNCHES["message"] == before + 1 and got.dtype == dtype
    want = message_plain(H, *_graph(bmg))
    # float32: only the summation order differs; bfloat16: f32 sums rounded
    # once, a sum in another order may round to the neighbouring value
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (BF16_ULP, 1e-6)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    assert not got[_pad_rows(bmg)].any()  # exact zeros


def _synthetic_graph(kind: str, device):
    """``(src, dst, rev, ptr)`` of a directed-edge graph sorted by dst, with
    padding edges (src = dst = the last node, rev the identity) at the end:

    * ``ragged``: chains of 5-40 atoms, 1989 edge rows (not a multiple of 64);
    * ``one_tile``: one chain, 40 rows, less than one 64-row tile;
    * ``empty``: no edge at all;
    * ``padding_run``: 500 real rows, then 700 padding rows (ten tiles of
      padding alone);
    * ``hub``: a star of 300 leaves, so its centre has in-degree 300;
    * ``many_tiles``: chains again, 12,881 rows: 202 tiles, not a multiple of
      the grid's tile lanes."""
    rng = np.random.default_rng({"ragged": 1, "one_tile": 2, "empty": 3, "padding_run": 4,
                                 "hub": 5, "many_tiles": 6}[kind])
    bonds, n_atoms = [], 0

    def chains(n_rows):
        nonlocal n_atoms
        while 2 * len(bonds) < n_rows:
            k = int(rng.integers(5, 41))
            bonds.extend((n_atoms + i, n_atoms + i + 1) for i in range(k - 1))
            n_atoms += k

    n_pad = 0
    if kind == "ragged":
        chains(1900)
        n_pad = 1989 - 2 * len(bonds)
    elif kind == "one_tile":
        bonds, n_atoms = [(i, i + 1) for i in range(20)], 21
    elif kind == "padding_run":
        chains(500)
        n_pad = 700
    elif kind == "hub":
        bonds, n_atoms, n_pad = [(0, i) for i in range(1, 301)], 301, 7
    elif kind == "many_tiles":
        chains(12800)
        n_pad = 12881 - 2 * len(bonds)
    assert n_pad >= 0
    src = [a for a, b in bonds] + [b for a, b in bonds]
    dst = [b for a, b in bonds] + [a for a, b in bonds]
    nb = len(bonds)
    rev = list(range(nb, 2 * nb)) + list(range(nb))
    order = np.argsort(np.asarray(dst, dtype=np.int64), kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    src, dst = np.asarray(src, np.int64)[order], np.asarray(dst, np.int64)[order]
    rev = inv[np.asarray(rev, np.int64)[order]] if nb else np.zeros(0, np.int64)
    pad_node = n_atoms  # the last node
    e_real = 2 * nb
    src = np.concatenate([src, np.full(n_pad, pad_node)])
    dst = np.concatenate([dst, np.full(n_pad, pad_node)])
    rev = np.concatenate([rev, np.arange(e_real, e_real + n_pad)])
    ptr = np.searchsorted(dst, np.arange(pad_node + 2), side="left")
    return tuple(torch.from_numpy(np.asarray(x, np.int32)).to(device)
                 for x in (src, dst, rev, ptr))


@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("relu_stream", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize(
    "graph", ["molecules", "ragged", "one_tile", "empty", "padding_run", "hub", "many_tiles"])
def test_fused_iter_matches_plain(bmg, cuda, relu_stream, bias, d, graph):
    g = _graph(bmg) if graph == "molecules" else _synthetic_graph(graph, cuda)
    n = g[0].shape[0]
    H = _randn((n, d), 1, cuda, torch.bfloat16)
    H0 = _randn((n, d), 2, cuda, torch.bfloat16)
    W = _randn((d, d), 3, cuda, torch.bfloat16, scale=d**-0.5)
    b = _randn((d,), 4, cuda, torch.bfloat16) if bias else None
    before = LAUNCHES["fused_iter"]
    y = fused_iter(H, H0, W, b, *g, relu_stream=relu_stream)
    assert LAUNCHES["fused_iter"] == before + (n > 0) and y.shape == (n, d)
    want = fused_iter_plain(H, H0, W, b, *g, relu_stream=relu_stream).float()
    # the bf16 message may round one ulp apart, which W carries into y; y's
    # own rounding adds one ulp
    torch.testing.assert_close(y.float(), want, rtol=2 * BF16_ULP, atol=0.02)
    # padding edges have a zero message: relu(H0 [+ b]) exactly
    pad = g[0] == g[3].numel() - 2
    want_pad = torch.relu(H0.float() + (b.float() if bias else 0)).to(torch.bfloat16)
    assert torch.equal(y[pad], want_pad[pad])
    # one block writes each row, in one order: two calls give the same bits
    assert torch.equal(y, fused_iter(H, H0, W, b, *g, relu_stream=relu_stream))


# segment lengths of the synthetic layouts (the kernel's ranges are 8 to 64
# rows, 32 at bf16 d = 384, 16 at f32 d = 384):
# * long: empty, short and long segments, long ones next to each other;
# * boundary: segments that cross multiples of 8 to 64 by one row, and
#   segments of one more or one less than a range;
# * span: segments of thousands of rows, each over many ranges;
# * empty_ends: empty segments first, in runs and last (ptr[s] == n);
# * no_rows: no row at all (n == 0);
# * one_segment: every row in the one segment.
SEGMENT_LAYOUTS = {
    "long": [0, 1, 2, 3, 40, 1, 100, 1000, 0, 33, 31, 32, 64, 5, 997, 2],
    "boundary": [31, 2, 29, 3, 1, 32, 33, 1, 63, 2, 65, 64, 2, 15, 17, 16, 0, 7, 2, 9, 127, 129,
                 1, 31, 33, 62, 3],
    "span": [5, 3000, 7, 4100, 2],
    "empty_ends": [0, 0, 3, 0, 0, 0, 5, 40, 0, 2, 0, 0],
    "no_rows": [0, 0, 0],
    "one_segment": [5000],
}


def _segment_layout(case, device):
    """Sorted ids and their CSR pointers for a layout of SEGMENT_LAYOUTS."""
    lengths = np.array(SEGMENT_LAYOUTS[case])
    ids = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
    ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return torch.from_numpy(ids).to(device), torch.from_numpy(ptr).to(device)


@pytest.fixture(scope="module")
def bench_bmg(cuda):
    """The benchmark batch: the 100 molecules of mol.csv tiled to 2048."""
    feat = SimpleMoleculeMolGraphFeaturizer()
    with open(DATA / "regression" / "mol" / "mol.csv") as f:
        smis = [line.split(",")[0] for line in f.read().splitlines()[1:]]
    mgs = [feat(make_mol(s)) for s in smis]
    return batch_mol_graphs((mgs * 21)[:2048]).to(cuda)


def _check_segment_sum(x, ids, ptr, out_dtype, with_counts):
    if with_counts:
        got, counts = sorted_segment_sum_counts(x, ids, ptr, out_dtype)
    else:
        got, counts = sorted_segment_sum(x, ids, ptr, out_dtype), None
    want, want_counts = sorted_segment_sum_plain(x, ids, ptr, out_dtype, with_counts)
    assert got.dtype == out_dtype and got.shape == want.shape
    rtol = BF16_ULP if out_dtype == torch.bfloat16 else 1e-5
    # the limit scales with |want|; for segments of more than 1000 rows with
    # their sum of |x|, as in chip_smoke.py: f32 sums of thousands of terms in
    # another order (index_add_'s own varies) differ by a few eps of that
    scale = want.float().abs()
    longer = (ptr[1:] - ptr[:-1]) > 1000
    scale[longer] = sorted_segment_sum_plain(x.abs(), ids, ptr, torch.float32)[0][longer]
    err = (got.float() - want.float()).abs()
    assert (err <= 1e-4 + rtol * scale).all(), float(err.max())
    if with_counts:
        torch.testing.assert_close(counts, want_counts)
    empty = ptr[1:] == ptr[:-1]
    assert not got[empty].any()  # exact zeros


@pytest.mark.parametrize("data_dtype,out_dtype", sorted(KERNEL_DTYPES, key=str))
@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("case", ["edges", "graphs", *SEGMENT_LAYOUTS])
def test_segment_sum_matches_plain(bmg, cuda, data_dtype, out_dtype, with_counts, case):
    if case == "edges":
        ids, ptr = bmg.dst, bmg.edge_ptr
    elif case == "graphs":
        ids, ptr = bmg.batch, bmg.node_ptr
    else:
        ids, ptr = _segment_layout(case, cuda)
    x = _randn((ids.shape[0], 384), 5, cuda, data_dtype)
    before = LAUNCHES["sorted_segment_sum"]
    _check_segment_sum(x, ids, ptr, out_dtype, with_counts)
    assert LAUNCHES["sorted_segment_sum"] == before + 1


@pytest.mark.parametrize("data_dtype,out_dtype", sorted(KERNEL_DTYPES, key=str))
@pytest.mark.parametrize("d", [4, 128, 300, 384, 1024])
@pytest.mark.parametrize("case", ["boundary", "span"])
def test_segment_sum_widths(cuda, data_dtype, out_dtype, d, case):
    ids, ptr = _segment_layout(case, cuda)
    x = _randn((ids.shape[0], d), 7, cuda, data_dtype)
    _check_segment_sum(x, ids, ptr, out_dtype, True)


@pytest.mark.parametrize("case", ["long", "span", "edges", "graphs"])
def test_segment_sum_is_deterministic(cuda, bench_bmg, case):
    """No atomics on the data and a fixed order: the same bits in every call,
    at both of the main path's shapes (the benchmark batch's M_v readout in
    bf16 and its mean readout, bf16 in, f32 out)."""
    out_dtype = None
    if case == "edges":
        ids, ptr, dtype = bench_bmg.dst, bench_bmg.edge_ptr, torch.bfloat16
    elif case == "graphs":
        ids, ptr, dtype, out_dtype = bench_bmg.batch, bench_bmg.node_ptr, torch.bfloat16, torch.float32
    else:
        (ids, ptr), dtype = _segment_layout(case, cuda), torch.float32
    x = _randn((ids.shape[0], 384), 6, cuda, dtype)
    a = sorted_segment_sum(x, ids, ptr, out_dtype)
    assert all(torch.equal(a, sorted_segment_sum(x, ids, ptr, out_dtype)) for _ in range(4))


def test_cuda_wrappers_raise_instead_of_falling_back(bmg, cuda):
    H = torch.zeros((bmg.E.shape[0], 128), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        fused_iter(H, H, torch.zeros((128, 128), device=cuda), None, *_graph(bmg))
    with pytest.raises(ValueError):
        message(H[:, :6], *_graph(bmg))  # not contiguous
    with pytest.raises(TypeError):  # float32 and bfloat16 only
        message(H.to(torch.float16), *_graph(bmg))
    with pytest.raises(TypeError):  # no readout sums float32 into bfloat16
        sorted_segment_sum(H, bmg.dst, bmg.edge_ptr, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_model_on_card_matches_cpu(cuda, dtype):
    feat = SimpleMoleculeMolGraphFeaturizer()
    b = batch_mol_graphs([feat(make_mol(s)) for s in SMIS])
    path = DATA / "example_model_v2_regression_mol.pt"
    want = load_model(path, "cpu", dtype)[0](b)
    LAUNCHES.clear()
    got = load_model(path, cuda, dtype)[0](b.to(cuda)).cpu()
    kernel = "fused_iter" if dtype == torch.bfloat16 else "message"
    assert LAUNCHES[kernel] == 2 and LAUNCHES["sorted_segment_sum"] == 2
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        torch.testing.assert_close(got, want, rtol=0.05, atol=0.1)


def _odd_bmg(device):
    """An odd size: edge and node counts that are no multiple of a tile, a
    single padding node row, and few padding edge rows."""
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(make_mol(s)) for s in SMIS[:7]]
    n_nodes = sum(mg.V.shape[0] for mg in mgs) + 1
    n_edges = sum(mg.E.shape[0] for mg in mgs) + 3
    return batch_mol_graphs(mgs, PadSpec(n_nodes, n_edges, len(mgs))).to(device)


@pytest.fixture(scope="module", params=["small", "odd"])
def any_bmg(request, bmg, cuda):
    return bmg if request.param == "small" else _odd_bmg(cuda)


def _pad_rows(b):
    return b.dst == b.V.shape[0] - 1


@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_message_matches_plain(any_bmg, cuda, dtype, with_acc, d):
    b = any_bmg
    n = b.E.shape[0]
    g = _randn((n, d), 10, cuda, dtype)
    y = _randn((n, d), 11, cuda, dtype).clamp_min(0)
    acc = _randn((n, d), 12, cuda, dtype) if with_acc else None
    before = LAUNCHES["bwd_message"]
    G, gz = bwd_message(g, y, *_graph(b), gz_acc=acc)
    assert LAUNCHES["bwd_message"] == before + 1
    want_G, want_gz = bwd_message_plain(g, y, *_graph(b), gz_acc=acc)
    # f32: only the summation order differs; bf16: f32 sums rounded once, a
    # sum in another order may round to the neighbouring value
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (BF16_ULP, 1e-6)
    torch.testing.assert_close(G.float(), want_G.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(gz.float(), want_gz.float(), rtol=rtol, atol=atol)
    pad = _pad_rows(b)
    assert not G[pad].any() and not gz[pad].any()  # exact zeros


@pytest.mark.parametrize("d", [128, 384, 512])
@pytest.mark.parametrize("tiled", [False, True])
def test_bwd_message_nodes_matches_plain(any_bmg, cuda, d, tiled):
    b = any_bmg
    g_nodes = _randn((b.V.shape[0], d), 13, cuda, torch.bfloat16)
    y = _randn((b.E.shape[0], d), 14, cuda, torch.bfloat16).clamp_min(0)
    if tiled:
        assert b.tile_ptr is not None
        _check_nodes(g_nodes, y, _graph(b), b.tile_ptr)
        return
    before = LAUNCHES["bwd_message_nodes"]
    G, gz = bwd_message_nodes(g_nodes, y, *_graph(b))
    assert LAUNCHES["bwd_message_nodes"] == before + 1
    want_G, want_gz = bwd_message_nodes_plain(g_nodes, y, *_graph(b))
    torch.testing.assert_close(G.float(), want_G.float(), rtol=BF16_ULP, atol=1e-6)
    assert torch.equal(gz, want_gz)  # a masked copy
    pad = _pad_rows(b)
    assert not G[pad].any() and not gz[pad].any()


def _premul_inputs(n, d, device, seed=15):
    G_in = _randn((n, d), seed, device, torch.bfloat16)
    y = _randn((n, d), seed + 1, device, torch.bfloat16).clamp_min(0)
    H0 = _randn((n, d), seed + 2, device, torch.bfloat16)
    W = _randn((d, d), seed + 3, device, torch.bfloat16, scale=d**-0.5)
    return G_in, y, H0, W


def _check_premul(G_in, y, H0, W, graph, fold_h0, tiles):
    """H with the tile table against the plain version, against its form
    without a table (bit for bit, every row) and against a second call;
    padding rows exact zeros."""
    before = LAUNCHES["bwd_message_premul"]
    G, z = bwd_message_premul(G_in, y, H0, W, *graph, fold_h0=fold_h0, tiles=tiles)
    assert LAUNCHES["bwd_message_premul"] == before + 1
    want_G, want_z = bwd_message_premul_plain(G_in, y, H0, W, *graph, fold_h0=fold_h0)
    # dh sums d products in f32 in another order, so gz and z may round to the
    # neighbouring bf16 value; G sums a few such values (each up to one ulp of
    # a value of size ~2 apart) and rounds once more
    torch.testing.assert_close(z.float(), want_z.float(), rtol=2 * BF16_ULP, atol=1e-5)
    torch.testing.assert_close(G.float(), want_G.float(), rtol=2 * BF16_ULP, atol=0.1)
    pad = graph[1] == graph[3].numel() - 2
    assert not G[pad].any() and not z[pad].any()
    # the two forms share the product and sum in one order: the same bits
    G2, z2 = bwd_message_premul(G_in, y, H0, W, *graph, fold_h0=fold_h0)
    assert torch.equal(G, G2) and torch.equal(z, z2)
    G3, z3 = bwd_message_premul(G_in, y, H0, W, *graph, fold_h0=fold_h0, tiles=tiles)
    assert torch.equal(G, G3) and torch.equal(z, z3)


@pytest.mark.parametrize("d", [128, 256, 384])
@pytest.mark.parametrize("fold_h0", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_bwd_message_premul_matches_plain(any_bmg, cuda, fold_h0, d, tiled):
    b = any_bmg
    G_in, y, H0, W = _premul_inputs(b.E.shape[0], d, cuda)
    if tiled:
        assert b.tile_ptr is not None
        _check_premul(G_in, y, H0, W, _graph(b), fold_h0, b.tile_ptr)
        return
    before = LAUNCHES["bwd_message_premul"]
    G, z = bwd_message_premul(G_in, y, H0, W, *_graph(b), fold_h0=fold_h0)
    assert LAUNCHES["bwd_message_premul"] == before + 1
    want_G, want_z = bwd_message_premul_plain(G_in, y, H0, W, *_graph(b), fold_h0=fold_h0)
    torch.testing.assert_close(z.float(), want_z.float(), rtol=2 * BF16_ULP, atol=1e-5)
    torch.testing.assert_close(G.float(), want_G.float(), rtol=2 * BF16_ULP, atol=0.1)
    pad = _pad_rows(b)
    assert not G[pad].any() and not z[pad].any()


def _tiled_graph(device):
    """``(src, dst, rev, ptr)`` and a tile table of whole molecules sorted by
    dst: a 32-bond chain (a tile of 64 rows), a 64-bond chain (128 rows), a
    star of 64 leaves (128 rows; the hub's 64 in-edges fill a whole 64-row
    half), a 32-bond chain with the first padding row (a tile of 65 rows),
    then padding tiles of 1, 100 and 28 rows."""
    mols = [[(i, i + 1) for i in range(32)], [(i, i + 1) for i in range(64)],
            [(0, i) for i in range(1, 65)], [(i, i + 1) for i in range(32)]]
    src, dst, rev, n_atoms, n_rows = [], [], [], 0, 0
    for bonds in mols:
        nb = len(bonds)
        s = [a for a, _ in bonds] + [b for _, b in bonds]
        t = [b for _, b in bonds] + [a for a, _ in bonds]
        order = np.argsort(np.asarray(t), kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(2 * nb)
        r = np.concatenate([np.arange(nb, 2 * nb), np.arange(nb)])
        src += list(np.asarray(s)[order] + n_atoms)
        dst += list(np.asarray(t)[order] + n_atoms)
        rev += list(inv[r[order]] + n_rows)
        n_atoms += max(max(a, b) for a, b in bonds) + 1
        n_rows += 2 * nb
    n_pad = 130
    pad_node = n_atoms
    src += [pad_node] * n_pad
    dst += [pad_node] * n_pad
    rev += list(range(n_rows, n_rows + n_pad))
    ptr = np.searchsorted(np.asarray(dst), np.arange(pad_node + 2), side="left")
    tiles = [0, 64, 192, 320, 385, 386, 486, n_rows + n_pad]
    return tuple(torch.from_numpy(np.asarray(x, np.int32)).to(device)
                 for x in (src, dst, rev, ptr, tiles))


@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("fold_h0", [False, True])
def test_bwd_message_premul_tiles_of_every_size(cuda, fold_h0, d):
    *graph, tiles = _tiled_graph(cuda)
    assert (tiles[1:] - tiles[:-1]).tolist() == [64, 128, 128, 65, 1, 100, 28]
    G_in, y, H0, W = _premul_inputs(graph[0].shape[0], d, cuda, seed=50)
    _check_premul(G_in, y, H0, W, tuple(graph), fold_h0, tiles)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 384), (torch.bfloat16, 8),
                                     (torch.float32, 300)])
def test_row_gather_matches_plain(any_bmg, cuda, dtype, d):
    b = any_bmg
    M = _randn((b.n_graphs + 1, d), 19, cuda, dtype)  # the last row is not zero
    before = LAUNCHES["row_gather"]
    got = row_gather(M, b.batch)
    assert LAUNCHES["row_gather"] == before + 1
    assert torch.equal(got, row_gather_plain(M, b.batch))
    assert not got[b.batch == b.n_graphs].any()


def test_backward_kernels_are_deterministic(bmg, cuda):
    n, d = bmg.E.shape[0], 384
    G_in = _randn((n, d), 20, cuda, torch.bfloat16)
    y = _randn((n, d), 21, cuda, torch.bfloat16).clamp_min(0)
    W = _randn((d, d), 22, cuda, torch.bfloat16, scale=d**-0.5)
    a = bwd_message_premul(G_in, y, G_in, W, *_graph(bmg), fold_h0=True)
    for tiles in (None, bmg.tile_ptr, None, bmg.tile_ptr):
        b = bwd_message_premul(G_in, y, G_in, W, *_graph(bmg), fold_h0=True, tiles=tiles)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_backward_wrappers_raise_instead_of_falling_back(bmg, cuda):
    n = bmg.E.shape[0]
    z = torch.zeros((n, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):  # the node form is bfloat16 only
        bwd_message_nodes(z.float()[: bmg.V.shape[0]], z.float(), *_graph(bmg))
    with pytest.raises(ValueError):  # width not a multiple of 128
        bwd_message_premul(z[:, :64].contiguous(), z[:, :64].contiguous(), None,
                           z[:64, :64].contiguous(), *_graph(bmg))
    with pytest.raises(ValueError):  # rows of 6 bytes
        row_gather(z[: bmg.n_graphs + 1, :3].contiguous(), bmg.batch)
    with pytest.raises(ValueError):  # graph tables on another device
        bwd_message(z, z, bmg.src.cpu(), bmg.dst, bmg.rev, bmg.edge_ptr)
    W = torch.zeros((128, 128), dtype=torch.bfloat16, device=cuda)
    short = bmg.tile_ptr.clone()
    short[-1] -= 1  # a table that ends short of the rows, read back from the card
    with pytest.raises(ValueError):
        bwd_message_premul(z, z, z, W, *_graph(bmg), fold_h0=True, tiles=short)
    wide = torch.tensor([0, ITER2_TILE_ROWS + 1, n], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # a tile of more rows than the kernel holds
        bwd_message_premul(z, z, z, W, *_graph(bmg), fold_h0=True, tiles=wide)
    with pytest.raises(ValueError):  # the table on another device
        bwd_message_premul(z, z, z, W, *_graph(bmg), fold_h0=True, tiles=bmg.tile_ptr.cpu())


@pytest.mark.parametrize("dtype,depth", [(torch.float32, 3), (torch.bfloat16, 3),
                                         (torch.bfloat16, 4), (torch.bfloat16, 2)])
def test_loop_readout_gradients_on_card_match_cpu(bmg, cuda, dtype, depth):
    """The hand-written backward through the kernels against the same op on
    the CPU's plain versions, and the launches each branch makes."""
    d = 128
    H0 = _randn((bmg.E.shape[0], d), 23, cuda, dtype)
    H0[_pad_rows(bmg)] = 0
    W = _randn((d, d), 24, cuda, dtype, scale=d**-0.5)
    c = _randn((bmg.V.shape[0], d), 25, cuda, dtype)
    c[-1] = 0
    cpu = bmg.to("cpu")

    def grads(H0, W, c, b):
        H0, W = H0.clone().requires_grad_(), W.clone().requires_grad_()
        return torch.autograd.grad(loop_readout(H0, W, None, *_graph(b), depth), [H0, W], c)

    LAUNCHES.clear()
    got = grads(H0, W, c, bmg)
    fast = dtype == torch.bfloat16 and depth >= 3
    if fast:
        assert LAUNCHES["bwd_message_nodes"] == 1 and LAUNCHES["bwd_message_premul"] == depth - 2
        assert LAUNCHES["bwd_message"] == 0
    else:
        assert LAUNCHES["bwd_message"] == depth - 1
        assert LAUNCHES["bwd_message_nodes"] == LAUNCHES["bwd_message_premul"] == 0
    want = grads(H0.cpu(), W.cpu(), c.cpu(), cpu)
    for g, w in zip(got, want):
        g, w = g.float().cpu(), w.float()
        scale = float(w.abs().max())
        if dtype == torch.float32:  # summation order only
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * scale)
        else:  # a bf16 ulp in a saved y may flip a ReLU mask downstream
            err = (g - w).abs()
            assert float(err.max()) <= 0.05 * scale and float(err.mean()) <= 2e-3 * scale


# ------------------------------------------- fused_iter2, iter_bwd, grad_weight
def _big_bmg(device):
    """A batch with one molecule of more edge rows than a tile holds."""
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(make_mol(s)) for s in SMIS[:3] + ["C" * 70] + SMIS[3:5]]
    assert max(mg.E.shape[0] for mg in mgs) > ITER2_TILE_ROWS
    return batch_mol_graphs(mgs).to(device)


@pytest.mark.parametrize("d", [128, 256, 384])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_iter2_equals_two_launches(any_bmg, cuda, bias, d):
    b = any_bmg
    n = b.E.shape[0]
    H0 = _randn((n, d), 30, cuda, torch.bfloat16)
    W = _randn((d, d), 31, cuda, torch.bfloat16, scale=d**-0.5)
    bb = _randn((d,), 32, cuda, torch.bfloat16) if bias else None
    assert b.tile_ptr is not None and int(b.tile_ptr[-1]) == n
    assert int((b.tile_ptr[1:] - b.tile_ptr[:-1]).max()) <= ITER2_TILE_ROWS
    before = LAUNCHES["fused_iter2"], LAUNCHES["fused_iter"]
    y1, y2 = fused_iter2(H0, W, bb, *_graph(b), b.tile_ptr)
    assert (LAUNCHES["fused_iter2"], LAUNCHES["fused_iter"]) == (before[0] + 1, before[1])
    w1 = fused_iter(H0, H0, W, bb, *_graph(b), relu_stream=True)
    w2 = fused_iter(w1, H0, W, bb, *_graph(b))
    assert torch.equal(y1, w1) and torch.equal(y2, w2)  # every row, bit for bit
    again = fused_iter2(H0, W, bb, *_graph(b), b.tile_ptr)
    assert torch.equal(again[0], y1) and torch.equal(again[1], y2)  # two calls
    p1, p2 = fused_iter2_plain(H0, W, bb, *_graph(b))
    torch.testing.assert_close(y1.float(), p1.float(), rtol=2 * BF16_ULP, atol=0.02)
    # y1's own ulp passes through the second message and W
    torch.testing.assert_close(y2.float(), p2.float(), rtol=2 * BF16_ULP, atol=0.1)


def test_fused_iter2_tiles_with_an_empty_tail_and_zero_padding(bmg, cuda):
    n, d = bmg.E.shape[0], 128
    H0 = _randn((n, d), 33, cuda, torch.bfloat16)
    H0[_pad_rows(bmg)] = 0  # as W_i leaves them without a bias
    W = _randn((d, d), 34, cuda, torch.bfloat16, scale=d**-0.5)
    tiles = torch.cat([bmg.tile_ptr, bmg.tile_ptr[-1:]])  # a last tile of no rows
    y1, y2 = fused_iter2(H0, W, None, *_graph(bmg), tiles)
    w1, w2 = fused_iter2(H0, W, None, *_graph(bmg), bmg.tile_ptr)
    assert torch.equal(y1, w1) and torch.equal(y2, w2)
    assert not y1[_pad_rows(bmg)].any() and not y2[_pad_rows(bmg)].any()


@pytest.mark.parametrize("d", [128, 256, 384, 512])
@pytest.mark.parametrize("table", ["tiles", "empty_tiles"])
def test_fused_iter2_tiles_of_every_size(cuda, d, table):
    """Tiles of 64, 128 (a 64-in-edge hub among them), 128, 65, 1, 100 and 28
    rows, the last three of padding rows only, and the same table with an
    empty tile after the first and two at the end: y1 and y2 equal two
    fused_iter launches bit for bit, and H0's zero padding rows give zero
    rows."""
    *graph, tiles = _tiled_graph(cuda)
    if table == "empty_tiles":
        tiles = torch.cat([tiles[:2], tiles[1:], tiles[-1:], tiles[-1:]])
    n = graph[0].shape[0]
    pad = graph[0] == graph[3].numel() - 2
    H0 = _randn((n, d), 60, cuda, torch.bfloat16)
    H0[pad] = 0
    W = _randn((d, d), 61, cuda, torch.bfloat16, scale=d**-0.5)
    y1, y2 = fused_iter2(H0, W, None, *graph, tiles)
    w1 = fused_iter(H0, H0, W, None, *graph, relu_stream=True)
    w2 = fused_iter(w1, H0, W, None, *graph)
    assert torch.equal(y1, w1) and torch.equal(y2, w2)
    assert not y1[pad].any() and not y2[pad].any()


@pytest.mark.parametrize("d", [128, 256, 384, 512])
def test_fused_iter2_launch_shape_by_width(cuda, d):
    """A cluster of d / 128 CTAs, each a 128-column slice of W, an even ring
    of stages and at most a block's shared memory."""
    info = fused_iter2_info(d, 1272)
    assert info["slice_width"] == 128 and info["cluster_ctas"] == d // 128
    assert info["stages"] >= 4 and info["stages"] % 2 == 0
    assert info["smem_bytes"] <= 232448
    assert 1 <= info["clusters"] == min(info["max_active_clusters"], 1272)


def test_fused_iter2_refuses_a_wider_width(bmg, cuda):
    """d = 640 is refused before any launch; loop_readout with iter2 takes
    two fused_iter launches there and counts the batch as unserved."""
    d = 640
    H0 = _randn((bmg.E.shape[0], d), 62, cuda, torch.bfloat16)
    H0[_pad_rows(bmg)] = 0
    W = _randn((d, d), 63, cuda, torch.bfloat16, scale=d**-0.5)
    with pytest.raises(ValueError, match="fused_iter2 takes d in"):
        fused_iter2(H0, W, None, *_graph(bmg), bmg.tile_ptr)
    LAUNCHES.clear()
    UNSERVED.clear()
    out = loop_readout(H0, W, None, *_graph(bmg), 3, KernelOptions(iter2=True), bmg.tile_ptr)
    assert LAUNCHES["fused_iter2"] == 0 and LAUNCHES["fused_iter"] == 2
    assert UNSERVED["fused_iter2"] == 1
    want = loop_readout(H0, W, None, *_graph(bmg), 3, KernelOptions(), bmg.tile_ptr)
    assert torch.equal(out, want)


def test_loop_readout_iter2_and_the_molecule_larger_than_a_tile(bmg, cuda):
    """Both tile kernels on a batch with a tile table, their other forms on a
    batch without one: the same forward and the same gradients bit for bit
    as the forms without a table, each unserved call counted."""
    d, depth = 128, 3
    on = KernelOptions(iter2=True)
    for b, served in ((bmg, True), (_big_bmg(cuda), False)):
        assert (b.tile_ptr is not None) == served
        H0 = _randn((b.E.shape[0], d), 35, cuda, torch.bfloat16)
        H0[_pad_rows(b)] = 0
        W = _randn((d, d), 36, cuda, torch.bfloat16, scale=d**-0.5)
        c = _randn((b.V.shape[0], d), 37, cuda, torch.bfloat16)
        c[-1] = 0

        def run(options, tiles):
            x, w = H0.clone().requires_grad_(), W.clone().requires_grad_()
            out = loop_readout(x, w, None, *_graph(b), depth, options, tiles)
            return (out, *torch.autograd.grad(out, [x, w], c))

        want = run(None, None)
        LAUNCHES.clear()
        UNSERVED.clear()
        got = run(on, b.tile_ptr)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert LAUNCHES["bwd_message_premul"] == 1
        if served:
            assert LAUNCHES["fused_iter2"] == 1 and LAUNCHES["fused_iter"] == 0
            assert UNSERVED["fused_iter2"] == 0 and UNSERVED["bwd_message_premul"] == 0
            assert UNSERVED["bwd_message_nodes"] == 0
        else:
            assert LAUNCHES["fused_iter2"] == 0 and LAUNCHES["fused_iter"] == 2
            assert UNSERVED["fused_iter2"] == 1 and UNSERVED["bwd_message_premul"] == 1
            assert UNSERVED["bwd_message_nodes"] == 1
        assert LAUNCHES["bwd_message_nodes"] == 1


@pytest.mark.parametrize("d", [128, 384])
def test_iter_bwd_matches_plain(any_bmg, cuda, d):
    b = any_bmg
    n = b.E.shape[0]
    g = _randn((n, d), 40, cuda, torch.bfloat16)
    y = _randn((n, d), 41, cuda, torch.bfloat16).clamp_min(0)
    H = _randn((n, d), 42, cuda, torch.bfloat16)  # padding rows not zero: they must not count
    W = _randn((d, d), 43, cuda, torch.bfloat16, scale=d**-0.5)
    before = LAUNCHES["iter_bwd"]
    dH, gz, dW = iter_bwd(g, y, H, W, *_graph(b))
    assert LAUNCHES["iter_bwd"] == before + 1 and dW.dtype == torch.float32
    want_dH, want_gz, want_dW = iter_bwd_plain(g, y, H, W, *_graph(b))
    assert torch.equal(gz, want_gz)  # a masked copy
    # G may round to the neighbouring bf16 value where the f32 sums differ in
    # their last bit; through W^T that moves dH by a fraction of an ulp of its
    # terms, and dH rounds once more
    torch.testing.assert_close(dH.float(), want_dH.float(), rtol=2 * BF16_ULP, atol=0.1)
    # dW sums n products in f32 in another order
    scale = float(want_dW.abs().max())
    torch.testing.assert_close(dW, want_dW, rtol=1e-3, atol=1e-3 * scale)
    # G itself equals bwd_message's, so dW equals the plain product of that G
    G, _ = bwd_message(g, y, *_graph(b))
    exact = H.float().masked_fill(_pad_rows(b)[:, None], 0).t() @ G.float()
    torch.testing.assert_close(dW, exact, rtol=1e-4, atol=1e-4 * scale)
    pad = _pad_rows(b)
    assert not dH[pad].any() and not gz[pad].any()
    for _ in range(2):  # fixed partition, ordered reduction: the same bits
        again = iter_bwd(g, y, H, W, *_graph(b))
        assert all(torch.equal(a, w) for a, w in zip(again, (dH, gz, dW)))


@pytest.mark.parametrize("n,dx,dg", [(768, 128, 128), (1000, 384, 384), (37, 128, 384),
                                     (5000, 384, 128), (0, 128, 128), (123392, 128, 384),
                                     (4133, 384, 384), (4133, 256, 256), (4133, 384, 256)])
def test_grad_weight_matches_plain(cuda, n, dx, dg):
    X = _randn((n, dx), 50, cuda, torch.bfloat16)
    G = _randn((n, dg), 51, cuda, torch.bfloat16)
    before = LAUNCHES["grad_weight"]
    got = grad_weight(X, G, use_kernel=True)
    assert LAUNCHES["grad_weight"] == before + 1
    assert got.shape == (dx, dg) and got.dtype == torch.float32
    want = grad_weight_plain(X, G)
    # exact bf16 products summed in f32 in another order
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * (1 + n**0.5))
    assert torch.equal(got, grad_weight(X, G, use_kernel=True))
    # without the kernel it is one library product and no launch
    lib = grad_weight(X, G)
    assert LAUNCHES["grad_weight"] == before + 2
    torch.testing.assert_close(lib, want, rtol=1e-4, atol=1e-4 * (1 + n**0.5))


def test_matmul_routes_its_kernel_gradient(cuda):
    x = _randn((512, 128), 52, cuda, torch.bfloat16).requires_grad_()
    k = _randn((128, 256), 53, cuda, torch.bfloat16, scale=0.1).requires_grad_()
    c = _randn((512, 256), 54, cuda, torch.bfloat16)
    before = LAUNCHES["grad_weight"]
    gx, gk = torch.autograd.grad(matmul(x, k, use_kernel=True), [x, k], c)
    assert LAUNCHES["grad_weight"] == before + 1
    wx, wk = torch.autograd.grad(x @ k, [x, k], c)
    torch.testing.assert_close(gx.float(), wx.float(), rtol=BF16_ULP, atol=1e-2)
    torch.testing.assert_close(gk.float(), wk.float(), rtol=2 * BF16_ULP, atol=0.05)


def test_grad_w_routes_w_i_through_the_kernel(bmg, cuda):
    """With grad_w in bfloat16 the module launches grad_weight for W_i (its
    input padded to 128 columns) and for W_h's two iterations, and W_i's
    gradient agrees with the CPU's plain version."""
    from chemprop_tpu_torch.nn import BondMessagePassing

    grads = []
    for b in (bmg, bmg.to("cpu")):
        mp = BondMessagePassing(d_h=64, compute_dtype=torch.bfloat16,
                                kernel_options=KernelOptions(grad_w=True))
        torch.manual_seed(0)
        for p in mp.parameters():
            torch.nn.init.normal_(p, std=0.1)
        mp.to(b.V.device)
        LAUNCHES.clear()
        out = mp(b, is_training=True)
        (g,) = torch.autograd.grad(out.float().square().sum(), [mp.W_i.weight])
        grads.append(g.cpu())
        assert LAUNCHES["grad_weight"] == (3 if b is bmg else 0)
    scale = float(grads[1].abs().max())
    torch.testing.assert_close(grads[0], grads[1], rtol=0.05, atol=0.02 * scale)


def test_new_wrappers_raise_instead_of_falling_back(bmg, cuda):
    n = bmg.E.shape[0]
    z = torch.zeros((n, 128), dtype=torch.bfloat16, device=cuda)
    W = torch.zeros((128, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):  # float32 tables
        grad_weight(z.float(), z.float(), use_kernel=True)
    with pytest.raises(ValueError):  # width not a multiple of 128
        grad_weight(z[:, :64].contiguous(), z, use_kernel=True)
    with pytest.raises(ValueError):  # not contiguous
        grad_weight(z.t()[:, :128], z[:128], use_kernel=True)
    with pytest.raises(TypeError):
        iter_bwd(z.float(), z.float(), z.float(), W.float(), *_graph(bmg))
    with pytest.raises(ValueError):  # rows 8 bytes off a 16-byte boundary
        off = torch.zeros(n * 128 + 4, dtype=torch.bfloat16, device=cuda)[4:].view(n, 128)
        iter_bwd(off, z, z, W, *_graph(bmg))
    with pytest.raises(ValueError):  # the tile table on another device
        fused_iter2(z, W, None, *_graph(bmg), bmg.tile_ptr.cpu())
    with pytest.raises(ValueError):  # int64 tiles
        fused_iter2(z, W, None, *_graph(bmg), bmg.tile_ptr.long())
    with pytest.raises(TypeError):
        fused_iter2(z.float(), W.float(), None, *_graph(bmg), bmg.tile_ptr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("opts", [KernelOptions(), KernelOptions(fused_bwd=True, grad_w=True)],
                         ids=["default", "fused_bwd+grad_w"])
def test_iteration_ops_gradients_on_card_match_cpu(bmg, cuda, dtype, bias, opts):
    """first_iter then message_iter through their hand-written backwards on
    the card against the same ops on the CPU's plain versions, and the
    launches each option makes."""
    d = 128
    n = bmg.E.shape[0]
    H0 = _randn((n, d), 60, cuda, dtype)
    H0[_pad_rows(bmg)] = 0
    W = _randn((d, d), 61, cuda, dtype, scale=d**-0.5)
    bb = _randn((d,), 62, cuda, dtype, scale=0.1) if bias else None
    c = _randn((n, d), 63, cuda, dtype)
    c[_pad_rows(bmg)] = 0
    cpu = bmg.to("cpu")

    def grads(H0, W, bb, c, b):
        leaves = [t.clone().requires_grad_() for t in (H0, W) + ((bb,) if bias else ())]
        bias_t = leaves[2] if bias else None
        y = first_iter(leaves[0], leaves[1], bias_t, *_graph(b), opts)
        y = message_iter(y, leaves[0], leaves[1], bias_t, *_graph(b), opts)
        return torch.autograd.grad(y, leaves, c)

    LAUNCHES.clear()
    got = grads(H0, W, bb, c, bmg)
    bf16 = dtype == torch.bfloat16
    assert LAUNCHES["fused_iter" if bf16 else "message"] == 2
    if bf16 and opts.fused_bwd:
        assert LAUNCHES["iter_bwd"] == 1 and LAUNCHES["bwd_message"] == 1
        assert LAUNCHES["grad_weight"] == 1  # iter_bwd forms its own dW
    else:
        assert LAUNCHES["iter_bwd"] == 0 and LAUNCHES["bwd_message"] == 2
        assert LAUNCHES["grad_weight"] == (2 if bf16 and opts.grad_w else 0)
    want = grads(H0.cpu(), W.cpu(), None if bb is None else bb.cpu(), c.cpu(), cpu)
    for g, w in zip(got, want):
        g, w = g.float().cpu(), w.float()
        scale = float(w.abs().max())
        if dtype == torch.float32:  # summation order only
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * scale)
        else:  # a bf16 ulp in a saved y may flip a ReLU mask downstream
            err = (g - w).abs()
            assert float(err.max()) <= 0.05 * scale and float(err.mean()) <= 2e-3 * scale


@pytest.mark.parametrize("kwargs", [dict(dropout=0.2), dict(undirected=True), dict(bias=True),
                                    dict(activation="tanh")], ids=lambda k: next(iter(k)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_message_passing_variants_on_card_match_cpu(bmg, cuda, dtype, kwargs):
    """The module's other code paths run on the card in both dtypes and agree
    with the CPU's plain versions; the dropout masks are made on the CPU from
    one seed and copied (the two devices' generators give other streams)."""
    from chemprop_tpu_torch.nn import BondMessagePassing
    from chemprop_tpu_torch.nn import utils as nn_utils

    mp = BondMessagePassing(d_h=64, compute_dtype=dtype, **kwargs)
    torch.manual_seed(0)
    for p in mp.parameters():
        torch.nn.init.normal_(p, std=0.1)
    draws = torch.Generator().manual_seed(5)
    masks = []
    real_mask = nn_utils.dropout_mask

    def record(shape, rate, generator, device):
        masks.append(real_mask(shape, rate, draws, torch.device("cpu")))
        return masks[-1]

    def replay(shape, rate, generator, device):
        return replayed.pop(0).to(device)

    nn_utils.dropout_mask = record
    try:
        want = mp(bmg.to("cpu"), is_training=True, generator=draws)
        replayed = list(masks)
        nn_utils.dropout_mask = replay
        got = mp.to(cuda)(bmg, is_training=True, generator=draws).cpu()
    finally:
        nn_utils.dropout_mask = real_mask
    real = bmg.node_mask.cpu()
    if dtype == torch.float32:
        torch.testing.assert_close(got[real], want[real], rtol=1e-4, atol=1e-5)
    else:
        torch.testing.assert_close(got[real].float(), want[real].float(), rtol=0.05, atol=0.05)


# ------------------------------------------- G (bwd_message_nodes) over tiles
NODE_LAYOUTS = {
    # zero-edge molecules and salts: nodes that own no rows inside a tile's
    # node range
    "salts": ["CCO", "CC(=O)[O-].[Na+]", "[Na+].CC(=O)[O-]", "C", "c1ccccc1"],
    # a run of 200 "C" between two molecules of one tile: its node range
    # spans more than 200 nodes
    "run_of_200_C": ["CCO", "CC(=O)[O-].[Na+]", "[Na+].CC(=O)[O-]"] + ["C"] * 200
    + ["c1ccccc1"],
}


def _node_layout_bmg(case, device):
    feat = SimpleMoleculeMolGraphFeaturizer()
    return batch_mol_graphs([feat(make_mol(s)) for s in NODE_LAYOUTS[case]]).to(device)


def _nodes_inputs(n_nodes, n, d, device, seed=70):
    g_nodes = _randn((n_nodes, d), seed, device, torch.bfloat16)
    y = _randn((n, d), seed + 1, device, torch.bfloat16).clamp_min(0)
    return g_nodes, y


def _check_nodes(g_nodes, y, graph, tiles):
    """G with the tile table against the plain version (G within one bf16
    ulp: f32 sums in one order, rounded once; gz exactly: a masked copy),
    against its form without a table and a second call bit for bit on every
    row; padding rows exact zeros."""
    before = LAUNCHES["bwd_message_nodes"]
    G, gz = bwd_message_nodes(g_nodes, y, *graph, tiles=tiles)
    assert LAUNCHES["bwd_message_nodes"] == before + 1
    want_G, want_gz = bwd_message_nodes_plain(g_nodes, y, *graph)
    torch.testing.assert_close(G.float(), want_G.float(), rtol=BF16_ULP, atol=1e-6)
    assert torch.equal(gz, want_gz)
    pad = graph[1] == graph[3].numel() - 2
    assert not G[pad].any() and not gz[pad].any()
    G2, gz2 = bwd_message_nodes(g_nodes, y, *graph)  # the node-warp form
    assert torch.equal(G, G2) and torch.equal(gz, gz2)
    G3, gz3 = bwd_message_nodes(g_nodes, y, *graph, tiles=tiles)
    assert torch.equal(G, G3) and torch.equal(gz, gz3)


@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("case", sorted(NODE_LAYOUTS))
def test_bwd_message_nodes_tiled_layouts(cuda, case, d):
    b = _node_layout_bmg(case, cuda)
    tiles, dst = b.tile_ptr.cpu(), b.dst.cpu()
    first = dst[int(tiles[0]): int(tiles[1])]
    if case == "run_of_200_C":  # the first tile's node range holds the run
        assert int(first[-1]) - int(first[0]) > 200
    g_nodes, y = _nodes_inputs(b.V.shape[0], b.E.shape[0], d, cuda, seed=72)
    _check_nodes(g_nodes, y, _graph(b), b.tile_ptr)


@pytest.mark.parametrize("d", [128, 384])
def test_bwd_message_nodes_tiles_of_every_size(cuda, d):
    """Tiles of 64 and 128 rows (a chain, and a star whose hub has 64
    in-edges), of 65 (with the first padding row), then padding tiles of 1,
    100 and 28 rows."""
    *graph, tiles = _tiled_graph(cuda)
    assert 128 in (tiles[1:] - tiles[:-1]).tolist()
    g_nodes, y = _nodes_inputs(graph[3].numel() - 1, graph[0].shape[0], d, cuda, seed=74)
    _check_nodes(g_nodes, y, tuple(graph), tiles)


def test_bwd_message_nodes_benchmark_batch(cuda, bench_bmg):
    """The main path's shape: the benchmark batch's table at d = 384, and the
    same bits in repeated calls."""
    b = bench_bmg
    g_nodes, y = _nodes_inputs(b.V.shape[0], b.E.shape[0], 384, cuda, seed=76)
    g_nodes[-1] = 0  # the sacrificial node's cotangent
    _check_nodes(g_nodes, y, _graph(b), b.tile_ptr)
    a = bwd_message_nodes(g_nodes, y, *_graph(b), tiles=b.tile_ptr)
    for _ in range(3):
        again = bwd_message_nodes(g_nodes, y, *_graph(b), tiles=b.tile_ptr)
        assert torch.equal(a[0], again[0]) and torch.equal(a[1], again[1])
    info = bwd_message_nodes_info(384, b.tile_ptr.numel() - 1)
    assert info["slices"] == 1 and info["stages"] >= 2 and info["blocks_per_sm"] >= 1


@pytest.mark.parametrize("d", [128, 512])
def test_tiled_bwd_message_nodes_flags_every_row_it_cannot_form(any_bmg, cuda, d):
    """A table that passes check_tiles but cuts molecules (a tile every 40
    rows): every row of a node with an in-edge, or the reverse of one,
    outside its tile is NaN in G, whole; every other row has the bits of the
    form without a table, and gz is whole everywhere."""
    b = any_bmg
    n = b.E.shape[0]
    tiles = torch.tensor(list(range(0, n, 40)) + [n], dtype=torch.int32)
    g_nodes = _randn((b.V.shape[0], d), 17, cuda, torch.bfloat16)
    y = _randn((n, d), 18, cuda, torch.bfloat16).clamp_min(0)
    G, gz = bwd_message_nodes(g_nodes, y, *_graph(b), tiles=tiles.to(cuda))
    want_G, want_gz = bwd_message_nodes(g_nodes, y, *_graph(b))
    assert torch.equal(gz, want_gz)
    # the rows of the nodes that cannot be formed inside one tile
    rev, ptr = b.rev.cpu().long(), b.edge_ptr.cpu().long()
    tile = torch.bucketize(torch.arange(n), tiles[1:].long(), right=True)
    first_pad = int(ptr[-2])
    want_bad = torch.zeros(n, dtype=torch.bool)
    for v in range(b.V.shape[0] - 1):
        ins = torch.arange(int(ptr[v]), int(ptr[v + 1]))
        if ins.numel():
            home = tile[ins[0]]
            want_bad[ins] = not ((tile[ins] == home).all() and (tile[rev[ins]] == home).all())
    assert want_bad.any() and not want_bad[:first_pad].all()
    nan = G.isnan().cpu()
    assert torch.equal(nan.any(1), want_bad) and torch.equal(nan.all(1), want_bad)
    assert torch.equal(G[~want_bad.to(cuda)], want_G[~want_bad.to(cuda)])


def test_tiled_bwd_message_nodes_raises_instead_of_falling_back(bmg, cuda):
    n, n_v = bmg.E.shape[0], bmg.V.shape[0]
    y = torch.zeros((n, 128), dtype=torch.bfloat16, device=cuda)
    g = torch.zeros((n_v, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):  # float32
        bwd_message_nodes(g.float(), y.float(), *_graph(bmg), tiles=bmg.tile_ptr)
    with pytest.raises(ValueError):  # a width the tiled kernel does not take
        bwd_message_nodes(g[:, :64].contiguous(), y[:, :64].contiguous(), *_graph(bmg),
                          tiles=bmg.tile_ptr)
    with pytest.raises(ValueError):  # the table on another device
        bwd_message_nodes(g, y, *_graph(bmg), tiles=bmg.tile_ptr.cpu())
    short = bmg.tile_ptr.clone()
    short[-1] -= 1  # a table that ends short of the rows, read back from the card
    with pytest.raises(ValueError):
        bwd_message_nodes(g, y, *_graph(bmg), tiles=short)
    wide = torch.tensor([0, ITER2_TILE_ROWS + 1, n], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # a tile of more rows than the kernel holds
        bwd_message_nodes(g, y, *_graph(bmg), tiles=wide)


# ------------------------------------------- iter_bwd over the molecule tiles
def _iter_bwd_inputs(n, d, device, seed=80):
    g = _randn((n, d), seed, device, torch.bfloat16)
    y = _randn((n, d), seed + 1, device, torch.bfloat16).clamp_min(0)
    H = _randn((n, d), seed + 2, device, torch.bfloat16).clamp_min(0)  # padding rows not zero
    W = _randn((d, d), seed + 3, device, torch.bfloat16, scale=d**-0.5)
    return g, y, H, W


def _check_tiled_iter_bwd(g, y, H, W, graph, tiles):
    """E with the tile table against the plain version under chip_smoke.py's
    limits (dH two bf16 ulps + 1e-4 of |G| |W|^T, dW rtol 1e-4 / atol 1e-3
    of |H|^T |G|), gz equal bit for bit to the plain version and to the form
    without a table, a second call equal bit for bit, padding rows zero."""
    before = LAUNCHES["iter_bwd"]
    dH, gz, dW = iter_bwd(g, y, H, W, *graph, tiles=tiles)
    assert LAUNCHES["iter_bwd"] == before + 1 and dW.dtype == torch.float32
    want_dH, want_gz, want_dW = iter_bwd_plain(g, y, H, W, *graph)
    pad = graph[1] == graph[3].numel() - 2
    G_abs = bwd_message_plain(g, y, *graph)[0].float().abs()
    assert torch.equal(gz, want_gz)
    limit = 1e-4 + 2 * BF16_ULP * (G_abs @ W.float().abs().t())
    assert bool(((dH.float() - want_dH.float()).abs() <= limit).all())
    limit = 1e-3 + 1e-4 * (H.float().masked_fill(pad[:, None], 0).t() @ G_abs)
    assert bool(((dW - want_dW).abs() <= limit).all())
    assert not dH[pad].any() and not gz[pad].any()
    other = iter_bwd(g, y, H, W, *graph)  # the three launches without a table
    assert torch.equal(gz, other[1])
    again = iter_bwd(g, y, H, W, *graph, tiles=tiles)
    assert all(torch.equal(a, w) for a, w in zip(again, (dH, gz, dW)))


@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("case", sorted(NODE_LAYOUTS))
def test_tiled_iter_bwd_layouts(cuda, case, d):
    b = _node_layout_bmg(case, cuda)
    g, y, H, W = _iter_bwd_inputs(b.E.shape[0], d, cuda)
    _check_tiled_iter_bwd(g, y, H, W, _graph(b), b.tile_ptr)


@pytest.mark.parametrize("d", [128, 256, 384])
def test_tiled_iter_bwd_tiles_of_every_size(cuda, d):
    """Tiles of 64 and 128 rows (a chain, and a star whose hub has 64
    in-edges), of 65 (with the first padding row), then padding tiles of 1,
    100 and 28 rows."""
    *graph, tiles = _tiled_graph(cuda)
    g, y, H, W = _iter_bwd_inputs(graph[0].shape[0], d, cuda, seed=84)
    _check_tiled_iter_bwd(g, y, H, W, tuple(graph), tiles)


@pytest.mark.parametrize("d", [128, 384])
def test_tiled_iter_bwd_benchmark_batch(cuda, bench_bmg, d):
    """The main path's shape: the benchmark batch's table, and the same bits
    in repeated calls."""
    b = bench_bmg
    g, y, H, W = _iter_bwd_inputs(b.E.shape[0], d, cuda, seed=88)
    _check_tiled_iter_bwd(g, y, H, W, _graph(b), b.tile_ptr)
    a = iter_bwd(g, y, H, W, *_graph(b), tiles=b.tile_ptr)
    for _ in range(3):
        again = iter_bwd(g, y, H, W, *_graph(b), tiles=b.tile_ptr)
        assert all(torch.equal(x, w) for x, w in zip(a, again))
    info = iter_bwd_info(d, b.tile_ptr.numel() - 1)
    assert info["cluster_blocks"] == d // 64 and 1 <= info["clusters"] <= info["max_active_clusters"]


@pytest.mark.parametrize("d", [128, 384])
def test_tiled_iter_bwd_flags_every_row_it_cannot_form(any_bmg, cuda, d):
    """A table that passes check_tiles but cuts molecules (a tile every 40
    rows): every row of a node with an in-edge, or the reverse of one,
    outside its tile is NaN in dH, whole; every other row is finite and
    within the limits of the form without a table, and gz is whole."""
    b = any_bmg
    n = b.E.shape[0]
    tiles = torch.tensor(list(range(0, n, 40)) + [n], dtype=torch.int32)
    g, y, H, W = _iter_bwd_inputs(n, d, cuda, seed=92)
    dH, gz, _ = iter_bwd(g, y, H, W, *_graph(b), tiles=tiles.to(cuda))
    want_dH, want_gz, _ = iter_bwd(g, y, H, W, *_graph(b))
    assert torch.equal(gz, want_gz)
    rev, ptr = b.rev.cpu().long(), b.edge_ptr.cpu().long()
    tile = torch.bucketize(torch.arange(n), tiles[1:].long(), right=True)
    want_bad = torch.zeros(n, dtype=torch.bool)
    for v in range(b.V.shape[0] - 1):
        ins = torch.arange(int(ptr[v]), int(ptr[v + 1]))
        if ins.numel():
            home = tile[ins[0]]
            want_bad[ins] = not ((tile[ins] == home).all() and (tile[rev[ins]] == home).all())
    assert want_bad.any() and not want_bad[: int(ptr[-2])].all()
    nan = dH.isnan().cpu()
    assert torch.equal(nan.any(1), want_bad) and torch.equal(nan.all(1), want_bad)
    good = ~want_bad.to(cuda)
    torch.testing.assert_close(dH[good].float(), want_dH[good].float(), rtol=2 * BF16_ULP,
                               atol=0.1)


def test_tiled_iter_bwd_raises_instead_of_falling_back(bmg, cuda):
    n = bmg.E.shape[0]
    z = torch.zeros((n, 128), dtype=torch.bfloat16, device=cuda)
    W = torch.zeros((128, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):  # float32
        iter_bwd(z.float(), z.float(), z.float(), W.float(), *_graph(bmg), tiles=bmg.tile_ptr)
    z5 = torch.zeros((n, 512), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # a width the tiled kernel does not take
        iter_bwd(z5, z5, z5, torch.zeros((512, 512), dtype=torch.bfloat16, device=cuda),
                 *_graph(bmg), tiles=bmg.tile_ptr)
    with pytest.raises(ValueError):  # the table on another device
        iter_bwd(z, z, z, W, *_graph(bmg), tiles=bmg.tile_ptr.cpu())
    short = bmg.tile_ptr.clone()
    short[-1] -= 1  # a table that ends short of the rows, read back from the card
    with pytest.raises(ValueError):
        iter_bwd(z, z, z, W, *_graph(bmg), tiles=short)


@pytest.mark.parametrize("d", [128, 384])
def test_message_iter_hands_the_table_to_the_tiled_kernel(bmg, cuda, d):
    """``message_iter`` with ``fused_bwd`` and the batch's table takes the
    tiled kernel (no batch left unserved) and gives the gradients of the form
    without a table, gz (dH0) bit for bit."""
    n = bmg.E.shape[0]
    mask = ~bmg.edge_mask[:, None]
    leaves = [_randn((n, d), 96, cuda, torch.bfloat16).clamp_min(0).masked_fill(mask, 0),
              _randn((n, d), 97, cuda, torch.bfloat16).masked_fill(mask, 0),
              _randn((d, d), 98, cuda, torch.bfloat16, scale=d**-0.5)]
    grads = {}
    for tiles in (bmg.tile_ptr, None):
        xs = [t.clone().requires_grad_() for t in leaves]
        UNSERVED.clear()
        y = message_iter(*xs, None, *_graph(bmg), KernelOptions(fused_bwd=True), tiles)
        grads[tiles is not None] = torch.autograd.grad(y.float().sum(), xs)
        assert UNSERVED["iter_bwd"] == (0 if tiles is not None else 1)
    assert torch.equal(grads[True][1], grads[False][1])
    torch.testing.assert_close(grads[True][0].float(), grads[False][0].float(),
                               rtol=2 * BF16_ULP, atol=0.1)
    scale = float(grads[False][2].float().abs().max())
    torch.testing.assert_close(grads[True][2].float(), grads[False][2].float(), rtol=0.02,
                               atol=1e-3 * scale)


# ---------------------------------------------- A (message) over the tiles
MESSAGE_DTYPES = [torch.float32, torch.bfloat16]


def _check_message(H, graph, tiles):
    """A with the tile table against the plain version (float32: summation
    order only; bfloat16: f32 sums rounded once, one ulp), against
    message.cu's form without a table and a second call bit for bit on every
    row, padding zeros included; one launch of the tiled kernel, no call
    unserved."""
    before = LAUNCHES["message"]
    UNSERVED.clear()
    got = message(H, *graph, tiles)
    assert LAUNCHES["message"] == before + 1 and UNSERVED["message"] == 0
    assert got.dtype == H.dtype
    want = message_plain(H, *graph)
    rtol, atol = (1e-5, 1e-5) if H.dtype == torch.float32 else (BF16_ULP, 1e-6)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    pad = graph[1] == graph[3].numel() - 2
    assert not got[pad].any()
    assert torch.equal(got, message(H, *graph))  # message.cu's form
    assert UNSERVED["message"] == 1
    assert torch.equal(got, message(H, *graph, tiles))
    return got


@pytest.mark.parametrize("dtype", MESSAGE_DTYPES)
@pytest.mark.parametrize("d", [128, 384, 512])
@pytest.mark.parametrize("case", sorted(NODE_LAYOUTS))
def test_tiled_message_layouts(cuda, case, d, dtype):
    """Salts, one-atom molecules ("C") and a run of 200 "C" in one tile."""
    b = _node_layout_bmg(case, cuda)
    _check_message(_randn((b.E.shape[0], d), 110, cuda, dtype), _graph(b), b.tile_ptr)


@pytest.mark.parametrize("dtype", MESSAGE_DTYPES)
@pytest.mark.parametrize("d", [128, 384, 512])
def test_tiled_message_tiles_of_every_size(cuda, d, dtype):
    """Tiles of 64 and 128 rows (a chain, and a star whose hub has 64
    in-edges: sums longer than the four read at once), of 65 (with the first
    padding row), then padding tiles of 1, 100 and 28 rows."""
    *graph, tiles = _tiled_graph(cuda)
    assert 128 in (tiles[1:] - tiles[:-1]).tolist()
    _check_message(_randn((graph[0].shape[0], d), 111, cuda, dtype), tuple(graph), tiles)


@pytest.mark.parametrize("dtype", MESSAGE_DTYPES)
@pytest.mark.parametrize("d", [128, 384])
def test_tiled_message_small_batches(any_bmg, cuda, d, dtype):
    b = any_bmg
    _check_message(_randn((b.E.shape[0], d), 112, cuda, dtype), _graph(b), b.tile_ptr)


@pytest.mark.parametrize("dtype", MESSAGE_DTYPES)
def test_tiled_message_benchmark_batch(cuda, bench_bmg, dtype):
    """The main path's shape: the benchmark batch's table at d = 384, the
    same bits in repeated calls, and the launch shape (bfloat16: one copy of
    each whole tile, float32: two column slices, one copy a row)."""
    from chemprop_tpu_torch.ops.message import message_info

    b = bench_bmg
    H = _randn((b.E.shape[0], 384), 113, cuda, dtype)
    got = _check_message(H, _graph(b), b.tile_ptr)
    for _ in range(3):
        assert torch.equal(got, message(H, *_graph(b), b.tile_ptr))
    info = message_info(384, dtype, b.tile_ptr.numel() - 1)
    assert info["slices"] == (1 if dtype == torch.bfloat16 else 2)
    assert info["stages"] >= 2 and info["blocks_per_sm"] >= 1
    assert info["smem_bytes"] <= 232448


@pytest.mark.parametrize("dtype", MESSAGE_DTYPES)
@pytest.mark.parametrize("d", [128, 512])
def test_tiled_message_flags_every_row_it_cannot_form(any_bmg, cuda, d, dtype):
    """A table that passes check_tiles but cuts molecules (a tile every 40
    rows): every row whose source's in-edges, or whose reverse, are not all
    inside its tile is NaN, whole; every other row has the bits of the form
    without a table."""
    b = any_bmg
    n = b.E.shape[0]
    tiles = torch.tensor(list(range(0, n, 40)) + [n], dtype=torch.int32)
    H = _randn((n, d), 114, cuda, dtype)
    got = message(H, *_graph(b), tiles.to(cuda))
    want = message(H, *_graph(b))
    src, rev, ptr = b.src.cpu().long(), b.rev.cpu().long(), b.edge_ptr.cpu().long()
    tile = torch.bucketize(torch.arange(n), tiles[1:].long(), right=True)
    first_pad = int(ptr[-2])
    want_bad = torch.zeros(n, dtype=torch.bool)
    for e in range(first_pad):
        ins = torch.arange(int(ptr[src[e]]), int(ptr[src[e] + 1]))
        want_bad[e] = not ((tile[ins] == tile[e]).all() and tile[rev[e]] == tile[e])
    assert want_bad.any() and not want_bad[:first_pad].all()
    nan = got.isnan().cpu()
    assert torch.equal(nan.any(1), want_bad) and torch.equal(nan.all(1), want_bad)
    assert torch.equal(got[~want_bad.to(cuda)], want[~want_bad.to(cuda)])


@pytest.mark.parametrize("dtype", MESSAGE_DTYPES)
def test_tiled_message_gradient_is_unchanged(bmg, cuda, dtype):
    """The backward is F's masked transposed message, whatever the forward
    took: the same gradient bit for bit with and without the table."""
    H = _randn((bmg.E.shape[0], 128), 115, cuda, dtype)
    c = _randn((bmg.E.shape[0], 128), 116, cuda, dtype)
    grads = []
    for tiles in (bmg.tile_ptr, None):
        x = H.clone().requires_grad_()
        before = LAUNCHES["bwd_message"]
        (g,) = torch.autograd.grad(message(x, *_graph(bmg), tiles), x, c)
        assert LAUNCHES["bwd_message"] == before + 1
        grads.append(g)
    assert torch.equal(grads[0], grads[1])
    want = bwd_message_plain(c, None, *_graph(bmg))[0]
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (BF16_ULP, 1e-6)
    torch.testing.assert_close(grads[0].float(), want.float(), rtol=rtol, atol=atol)


def test_tiled_message_raises_instead_of_falling_back(bmg, cuda):
    n = bmg.E.shape[0]
    H = torch.zeros((n, 128), device=cuda)
    with pytest.raises(ValueError):  # the table on another device
        message(H, *_graph(bmg), bmg.tile_ptr.cpu())
    short = bmg.tile_ptr.clone()
    short[-1] -= 1  # a table that ends short of the rows, read back from the card
    with pytest.raises(ValueError):
        message(H, *_graph(bmg), short)
    wide = torch.tensor([0, ITER2_TILE_ROWS + 1, n], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # a tile of more rows than the kernel holds
        message(H, *_graph(bmg), wide)
    with pytest.raises(TypeError):
        message(H.half(), *_graph(bmg), bmg.tile_ptr)


@pytest.mark.parametrize("dtype", MESSAGE_DTYPES)
def test_a_width_or_a_batch_the_tiled_message_does_not_take(bmg, cuda, dtype):
    """d = 64 with a table, and a batch without one: message.cu's form, each
    call counted in UNSERVED, the plain version's values."""
    H = _randn((bmg.E.shape[0], 64), 117, cuda, dtype)
    big = _big_bmg(cuda)
    Hb = _randn((big.E.shape[0], 128), 118, cuda, dtype)
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (BF16_ULP, 1e-6)
    for x, b in ((H, bmg), (Hb, big)):
        UNSERVED.clear()
        before = LAUNCHES["message"]
        got = message(x, *_graph(b), b.tile_ptr)
        assert LAUNCHES["message"] == before + 1 and UNSERVED["message"] == 1
        torch.testing.assert_close(got.float(), message_plain(x, *_graph(b)).float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("dtype", MESSAGE_DTYPES)
@pytest.mark.parametrize("kwargs", [dict(activation="tanh"), dict(undirected=True)],
                         ids=["tanh", "undirected"])
def test_composed_path_launches_the_tiled_message(bmg, cuda, dtype, kwargs):
    """The composed path on the card: depth - 1 launches of A, none of them
    unserved."""
    from chemprop_tpu_torch.nn import BondMessagePassing

    mp = BondMessagePassing(d_h=64, compute_dtype=dtype, **kwargs).to(cuda)
    LAUNCHES.clear()
    UNSERVED.clear()
    out = mp(bmg)
    assert torch.isfinite(out.float()).all()
    assert LAUNCHES["message"] == mp.depth - 1 and UNSERVED["message"] == 0


# ------------------------------------------- depth loop, window-gather route
@pytest.mark.parametrize("grad_w", [False, True], ids=["library_dw", "grad_w"])
@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("dtype,depth", [(torch.float32, 3), (torch.bfloat16, 2),
                                         (torch.bfloat16, 3)])
def test_depth_loop_on_card_matches_cpu(bmg, cuda, dtype, depth, bias, grad_w):
    """``depth_loop``'s forward and backward through the kernels against the
    same op on the CPU's plain versions: B (A over the tile table in f32) for
    every iteration, F with the running dH0 for every backward step, J with
    ``grad_w`` in bf16; never G or H. At loop_readout's test width: B may put
    a saved y one bf16 ulp from the plain version's, which flips a ReLU mask
    where y is near zero, and at a wider width more such elements carry a
    flip into the largest terms (test_loop_readout_gradients_on_card_match_cpu)."""
    from chemprop_tpu_torch.ops import depth_loop

    d = 128
    H0 = _randn((bmg.E.shape[0], d), 41, cuda, dtype)
    H0[_pad_rows(bmg)] = 0
    W = _randn((d, d), 42, cuda, dtype, scale=d**-0.5)
    b = _randn((d,), 43, cuda, dtype, scale=0.1) if bias else None
    c = _randn((bmg.E.shape[0], d), 44, cuda, dtype)
    c[_pad_rows(bmg)] = 0
    opts = KernelOptions(grad_w=grad_w)

    def run(H0, W, b, c, g):
        xs = [t.clone().requires_grad_() for t in (H0, W) + ((b,) if bias else ())]
        out = depth_loop(xs[0], xs[1], xs[2] if bias else None, *_graph(g), depth, opts,
                         g.tile_ptr)
        return (out, *torch.autograd.grad(out, xs, c))

    LAUNCHES.clear()
    UNSERVED.clear()
    got = run(H0, W, b, c, bmg)
    n = depth - 1
    want_launches = {"bwd_message": n}
    if dtype == torch.bfloat16:
        want_launches["fused_iter"] = n
        if grad_w:
            want_launches["grad_weight"] = n
    else:
        want_launches["message"] = n
    assert dict(LAUNCHES) == want_launches and UNSERVED["message"] == 0
    want = run(*(t if t is None else t.cpu() for t in (H0, W, b, c)), bmg.to("cpu"))
    real = ~_pad_rows(bmg).cpu()
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().float().cpu(), w.detach().float()
        if i in (0, 1):  # the edge tables: the real rows
            g, w = g[real], w[real]
        scale = float(w.abs().max())
        if dtype == torch.float32:  # summation order only, through W's products
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * scale)
        else:  # a bf16 ulp in a saved y may flip a ReLU mask downstream
            err = (g - w).abs()
            assert float(err.max()) <= 0.05 * scale and float(err.mean()) <= 2e-3 * scale
    assert not got[1][_pad_rows(bmg)].any()  # dH0's padding rows: zeros


def _exactly_full_bmg(device):
    """A batch whose real nodes fill every row but the last, the padding
    node the collate always keeps."""
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(make_mol(s)) for s in SMIS]
    n_real = sum(mg.V.shape[0] for mg in mgs)
    b = batch_mol_graphs(mgs, PadSpec(n_real + 1, 768, len(SMIS)))
    assert b.node_mask[:-1].all() and not b.node_mask[-1]
    return b.to(device)


@pytest.mark.parametrize("full", [False, True], ids=["padded", "exactly_full"])
def test_row_gather_on_the_v_src_route(bmg, cuda, full):
    """I on W_i's input gather: ``row_gather(V, src)`` is ``V[src]`` bit for
    bit (the padding edges name the zero padding row), on a collated batch
    and on one filled to N_pad - 1 real nodes; through the message passing
    with ``window_gather`` one forward launch of I, no refusal, and the same
    forward bits as the library gather."""
    from chemprop_tpu_torch.nn import BondMessagePassing

    b = _exactly_full_bmg(cuda) if full else bmg
    V = b.V.to(torch.bfloat16)
    assert torch.equal(row_gather(V, b.src), V[b.src.long()])
    outs = []
    for on in (False, True):
        torch.manual_seed(0)
        mp = BondMessagePassing(d_h=300, compute_dtype=torch.bfloat16,
                                kernel_options=KernelOptions(window_gather=on)).to(cuda)
        LAUNCHES.clear()
        UNSERVED.clear()
        with torch.inference_mode():
            outs.append(mp(b))
        assert LAUNCHES["row_gather"] == int(on) and UNSERVED["row_gather"] == 0
    assert torch.equal(outs[0], outs[1])


def test_window_gather_serves_the_descriptor_model(bmg, cuda):
    """The descriptor model's node table (72 + 3 extra columns, 150-byte
    rows in bf16) goes through I with ``window_gather``: one forward launch,
    nothing refused, and the forward (W_d's output included) bit-equal to the
    library gather's."""
    from dataclasses import replace

    from chemprop_tpu_torch.nn import BondMessagePassing

    n, m = bmg.V.shape[0], bmg.E.shape[0]
    V_f = _randn((n, 3), 81, cuda) * bmg.node_mask[:, None]
    E_f = _randn((m, 2), 82, cuda) * bmg.edge_mask[:, None]
    b = replace(bmg, V=torch.cat([bmg.V, V_f], 1), E=torch.cat([bmg.E, E_f], 1))
    V_d = _randn((n, 3), 83, cuda) * bmg.node_mask[:, None]
    outs = []
    for on in (False, True):
        torch.manual_seed(0)
        mp = BondMessagePassing(d_v=75, d_e=16, d_h=300, d_vd=3, compute_dtype=torch.bfloat16,
                                kernel_options=KernelOptions(window_gather=on)).to(cuda)
        LAUNCHES.clear()
        UNSERVED.clear()
        with torch.inference_mode():
            outs.append(mp(b, V_d))
        assert LAUNCHES["row_gather"] == int(on) and UNSERVED["row_gather"] == 0
    assert torch.equal(outs[0], outs[1])


# ------------------------------------------- F (bwd_message) over the tiles
def _graph_of(mols, n_pad, tiles):
    """``(src, dst, rev, ptr)`` of molecules given as bond lists, sorted by
    dst, then ``n_pad`` padding rows, and the tile table ``tiles``."""
    src, dst, rev, n_atoms, n_rows = [], [], [], 0, 0
    for bonds in mols:
        nb = len(bonds)
        s = [a for a, _ in bonds] + [b for _, b in bonds]
        t = [b for _, b in bonds] + [a for a, _ in bonds]
        order = np.argsort(np.asarray(t), kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(2 * nb)
        r = np.concatenate([np.arange(nb, 2 * nb), np.arange(nb)])
        src += list(np.asarray(s)[order] + n_atoms)
        dst += list(np.asarray(t)[order] + n_atoms)
        rev += list(inv[r[order]] + n_rows)
        n_atoms += max(max(a, b) for a, b in bonds) + 1
        n_rows += 2 * nb
    pad_node = n_atoms
    src += [pad_node] * n_pad
    dst += [pad_node] * n_pad
    rev += list(range(n_rows, n_rows + n_pad))
    ptr = np.searchsorted(np.asarray(dst), np.arange(pad_node + 2), side="left")
    return tuple(np.asarray(x, np.int32) for x in (src, dst, rev, ptr, tiles))


def _every_tile_size_graph(device):
    """Tiles of every size from 1 to 128 rows: a chain of b bonds alone in a
    tile of 2 b rows (b = 1 .. 64: every even size, 128 included), a chain of
    one bond with the first padding row (a tile of 3 rows), then padding
    tiles of every size from 1 to 128."""
    mols = [[(i, i + 1) for i in range(b)] for b in range(1, 65)] + [[(0, 1)]]
    sizes = [2 * b for b in range(1, 65)] + [3] + list(range(1, 129))
    n_pad = 1 + sum(range(1, 129))
    tiles = np.concatenate([[0], np.cumsum(sizes)])
    assert tiles[-1] == sum(2 * len(m) for m in mols) + n_pad
    return tuple(torch.from_numpy(x).to(device) for x in _graph_of(mols, n_pad, tiles))


F_DTYPES = [torch.float32, torch.bfloat16]


def _f_inputs(n, d, dtype, device, seed=120):
    g = _randn((n, d), seed, device, dtype)
    y = _randn((n, d), seed + 1, device, dtype).clamp_min(0)  # a ReLU output
    acc = _randn((n, d), seed + 2, device, dtype)
    return g, y, acc


def _check_f(g, y, acc, graph, tiles, with_gz=True):
    """F with the tile table against the node-warp form of message_bwd.cu bit
    for bit on every row, and against the plain version (float32: summation
    order only; bfloat16: f32 sums rounded once, one ulp); padding rows exact
    zeros; a second call the same bits; one launch, nothing unserved."""
    from chemprop_tpu_torch.ops.message import _transposed

    LAUNCHES.clear()
    UNSERVED.clear()
    G, gz = _transposed(g, y, acc, graph, tiles, with_gz=with_gz)
    assert LAUNCHES["bwd_message"] == 1 and UNSERVED["bwd_message"] == 0
    assert (gz is not None) == with_gz and G.dtype == g.dtype
    G2, gz2 = _transposed(g, y, acc, graph, None, with_gz=with_gz)  # the node-warp form
    assert UNSERVED["bwd_message"] == 1
    assert torch.equal(G, G2)
    want_G, want_gz = bwd_message_plain(g, y, *graph, gz_acc=acc)
    rtol, atol = (1e-5, 1e-5) if g.dtype == torch.float32 else (BF16_ULP, 1e-6)
    torch.testing.assert_close(G.float(), want_G.float(), rtol=rtol, atol=atol)
    pad = graph[1] == graph[3].numel() - 2
    assert not G[pad].any()
    G3, gz3 = _transposed(g, y, acc, graph, tiles, with_gz=with_gz)
    assert torch.equal(G, G3)
    if with_gz:
        assert torch.equal(gz, gz2) and torch.equal(gz, gz3)
        torch.testing.assert_close(gz.float(), want_gz.float(), rtol=rtol, atol=atol)
        assert not gz[pad].any()
    return G, gz


@pytest.mark.parametrize("d", [128, 256, 384, 512])
@pytest.mark.parametrize("with_gz", [True, False], ids=["gz", "no_gz"])
@pytest.mark.parametrize("with_acc", [False, True], ids=["no_acc", "acc"])
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("dtype", F_DTYPES)
def test_tiled_bwd_message_matches_the_node_warp_form(bmg, cuda, dtype, masked, with_acc,
                                                      with_gz, d):
    g, y, acc = _f_inputs(bmg.E.shape[0], d, dtype, cuda)
    _check_f(g, y if masked else None, acc if with_acc else None, _graph(bmg), bmg.tile_ptr,
             with_gz)


@pytest.mark.parametrize("d", [128, 384, 512])
@pytest.mark.parametrize("dtype", F_DTYPES)
def test_tiled_bwd_message_tiles_of_every_size(cuda, dtype, d):
    *graph, tiles = _every_tile_size_graph(cuda)
    assert sorted(set((tiles[1:] - tiles[:-1]).tolist())) == list(range(1, 129))
    g, y, acc = _f_inputs(graph[0].shape[0], d, dtype, cuda, seed=121)
    for a in (None, acc):
        _check_f(g, y, a, tuple(graph), tiles)
    # a star whose hub has 64 in-edges: sums longer than the four read at once
    *graph, tiles = _tiled_graph(cuda)
    g, y, acc = _f_inputs(graph[0].shape[0], d, dtype, cuda, seed=122)
    _check_f(g, y, acc, tuple(graph), tiles)


@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("dtype", F_DTYPES)
@pytest.mark.parametrize("case", sorted(NODE_LAYOUTS))
def test_tiled_bwd_message_layouts(cuda, case, dtype, d):
    """Salts, one-atom molecules ("C") and a run of 200 "C" in one tile."""
    b = _node_layout_bmg(case, cuda)
    g, y, acc = _f_inputs(b.E.shape[0], d, dtype, cuda, seed=123)
    _check_f(g, y, acc, _graph(b), b.tile_ptr)


@pytest.mark.parametrize("dtype", F_DTYPES)
def test_tiled_bwd_message_benchmark_batch(cuda, bench_bmg, dtype):
    """The main path's shape: the benchmark batch's table at d = 384, with and
    without gz_acc, the same bits in repeated calls, and the launch shape:
    g and y (and gz_acc) staged in column slices by TMA boxes of 32 rows
    (then of 8; bfloat16: two
    of 192 columns, three of 128 with gz_acc; float32: four of 96, six of
    64), two stages; the message's own backward (g alone) in bfloat16 one
    copy of each whole tile."""
    from chemprop_tpu_torch.ops.message import bwd_message_info

    b = bench_bmg
    g, y, acc = _f_inputs(b.E.shape[0], 384, dtype, cuda, seed=124)
    for a in (None, acc):
        G, gz = _check_f(g, y, a, _graph(b), b.tile_ptr)
        for _ in range(2):
            again = bwd_message(g, y, *_graph(b), gz_acc=a, tiles=b.tile_ptr)
            assert torch.equal(G, again[0]) and torch.equal(gz, again[1])
    bf16 = dtype == torch.bfloat16
    for tables, slices in ((1, 1 if bf16 else 2), (2, 2 if bf16 else 4), (3, 3 if bf16 else 6)):
        info = bwd_message_info(384, dtype, b.tile_ptr.numel() - 1, tables)
        assert info["slices"] == slices
        assert info["box_rows"] == (0 if slices == 1 else 32)
        assert info["stages"] >= 2 and info["blocks_per_sm"] >= 1
        assert info["smem_bytes"] <= 232448


@pytest.mark.parametrize("dtype", F_DTYPES)
@pytest.mark.parametrize("d", [128, 384])
def test_tiled_bwd_message_flags_every_row_it_cannot_form(any_bmg, cuda, dtype, d):
    """A table that passes check_tiles but cuts molecules (a tile every 40
    rows): every row of a node with an in-edge, or the reverse of one,
    outside its tile is NaN in G, whole; every other row has the bits of the
    node-warp form, and gz is whole everywhere."""
    b = any_bmg
    n = b.E.shape[0]
    tiles = torch.tensor(list(range(0, n, 40)) + [n], dtype=torch.int32)
    g, y, acc = _f_inputs(n, d, dtype, cuda, seed=125)
    G, gz = bwd_message(g, y, *_graph(b), gz_acc=acc, tiles=tiles.to(cuda))
    want_G, want_gz = bwd_message(g, y, *_graph(b), gz_acc=acc)
    assert torch.equal(gz, want_gz)
    rev, ptr = b.rev.cpu().long(), b.edge_ptr.cpu().long()
    tile = torch.bucketize(torch.arange(n), tiles[1:].long(), right=True)
    first_pad = int(ptr[-2])
    want_bad = torch.zeros(n, dtype=torch.bool)
    for v in range(b.V.shape[0] - 1):
        ins = torch.arange(int(ptr[v]), int(ptr[v + 1]))
        if ins.numel():
            home = tile[ins[0]]
            want_bad[ins] = not ((tile[ins] == home).all() and (tile[rev[ins]] == home).all())
    assert want_bad.any() and not want_bad[:first_pad].all()
    nan = G.isnan().cpu()
    assert torch.equal(nan.any(1), want_bad) and torch.equal(nan.all(1), want_bad)
    assert torch.equal(G[~want_bad.to(cuda)], want_G[~want_bad.to(cuda)])


def test_tiled_bwd_message_raises_instead_of_falling_back(bmg, cuda):
    n = bmg.E.shape[0]
    z = torch.zeros((n, 128), device=cuda)
    with pytest.raises(ValueError):  # the table on another device
        bwd_message(z, z, *_graph(bmg), tiles=bmg.tile_ptr.cpu())
    short = bmg.tile_ptr.clone()
    short[-1] -= 1  # a table that ends short of the rows, read back from the card
    with pytest.raises(ValueError):
        bwd_message(z, z, *_graph(bmg), tiles=short)
    wide = torch.tensor([0, ITER2_TILE_ROWS + 1, n], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # a tile of more rows than the kernel holds
        bwd_message(z, z, *_graph(bmg), tiles=wide)
    with pytest.raises(TypeError):
        bwd_message(z.half(), z.half(), *_graph(bmg), tiles=bmg.tile_ptr)


@pytest.mark.parametrize("dtype", F_DTYPES)
def test_a_width_or_a_batch_the_tiled_bwd_message_does_not_take(bmg, cuda, dtype):
    """d = 64 with a table, and a batch without one: the node-warp form, each
    call counted in UNSERVED, the plain version's values."""
    big = _big_bmg(cuda)
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (BF16_ULP, 1e-6)
    for b, d in ((bmg, 64), (big, 128)):
        g, y, acc = _f_inputs(b.E.shape[0], d, dtype, cuda, seed=126)
        UNSERVED.clear()
        LAUNCHES.clear()
        G, gz = bwd_message(g, y, *_graph(b), gz_acc=acc, tiles=b.tile_ptr)
        assert LAUNCHES["bwd_message"] == 1 and UNSERVED["bwd_message"] == 1
        want_G, want_gz = bwd_message_plain(g, y, *_graph(b), gz_acc=acc)
        torch.testing.assert_close(G.float(), want_G.float(), rtol=rtol, atol=atol)
        torch.testing.assert_close(gz.float(), want_gz.float(), rtol=rtol, atol=atol)


# each training route that runs F: dtype, dropout, options, other arguments,
# and F's launches in one step
F_ROUTES = {
    "float32": (torch.float32, 0.0, {}, {}, 2),
    "float32_dropout": (torch.float32, 0.1, {}, {}, 2),
    "bfloat16_dropout": (torch.bfloat16, 0.1, {}, {}, 2),
    "bfloat16_dropout_fused_bwd": (torch.bfloat16, 0.1, dict(fused_bwd=True), {}, 1),
    "bfloat16_per_iteration": (torch.bfloat16, 0.0, dict(fused_readout=False), {}, 2),
    "float32_depth_loop": (torch.float32, 0.0, dict(depth_loop=True), {}, 2),
    "bfloat16_depth_loop": (torch.bfloat16, 0.0, dict(depth_loop=True), {}, 2),
    "bfloat16_tanh": (torch.bfloat16, 0.0, {}, dict(activation="tanh"), 2),
    "float32_undirected": (torch.float32, 0.0, {}, dict(undirected=True), 2),
}


@pytest.mark.parametrize("route", sorted(F_ROUTES))
def test_every_training_route_serves_f_over_the_tiles(cuda, bench_bmg, route):
    """One training step's forward and backward of message passing at the
    benchmark batch: F's launches as the route makes them, none of them
    without the tile table."""
    from chemprop_tpu_torch.nn import BondMessagePassing

    dtype, dropout, options, kwargs, launches = F_ROUTES[route]
    mp = BondMessagePassing(d_h=300, compute_dtype=dtype, dropout=dropout,
                            kernel_options=KernelOptions(**options), **kwargs).to(cuda)
    LAUNCHES.clear()
    UNSERVED.clear()
    out = mp(bench_bmg, is_training=True,
             generator=torch.Generator(device=cuda).manual_seed(0))
    grads = torch.autograd.grad(out.float().sum(), list(mp.parameters()))
    assert all(torch.isfinite(g.float()).all() for g in grads)
    assert LAUNCHES["bwd_message"] == launches and UNSERVED["bwd_message"] == 0


# ------------------------------------------------------------ the task heads
# head, extra arguments, targets of one molecule for 2 tasks
HEADS = {
    "RegressionFFN": ({}, lambda r: r.standard_normal(2)),
    "MveFFN": ({}, lambda r: r.standard_normal(2)),
    "EvidentialFFN": ({}, lambda r: r.standard_normal(2)),
    "QuantileFFN": ({}, lambda r: r.standard_normal(2)),
    "BinaryClassificationFFN": ({}, lambda r: (r.uniform(size=2) > 0.5).astype(float)),
    "BinaryDirichletFFN": ({}, lambda r: (r.uniform(size=2) > 0.5).astype(float)),
    "MulticlassClassificationFFN": ({"n_classes": 3}, lambda r: r.integers(0, 3, 2).astype(float)),
    "MulticlassDirichletFFN": ({"n_classes": 3}, lambda r: r.integers(0, 3, 2).astype(float)),
    "SpectralFFN": ({}, lambda r: np.full(2, 0.5)),
}


def _head_batch(name):
    from chemprop_tpu_torch.data import DataLoader, MoleculeDatapoint, MoleculeDataset

    rng = np.random.default_rng(3)
    ds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=HEADS[name][1](rng)) for s in SMIS])
    return next(iter(DataLoader(ds, batch_size=len(SMIS))))


def _head_model(name, dtype):
    from chemprop_tpu_torch.models import MPNN
    from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, predictors

    extra = dict(HEADS[name][0])
    if name in ("RegressionFFN", "MveFFN", "EvidentialFFN", "QuantileFFN"):
        extra["output_transform"] = False
    return MPNN(BondMessagePassing(d_h=128, compute_dtype=dtype, kernel_options=KernelOptions()),
                MeanAggregation(), getattr(predictors, name)(n_tasks=2, input_dim=128,
                                                             hidden_dim=64, **extra),
                batch_norm=True)


@pytest.mark.parametrize("dtype", F_DTYPES)
@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_forward_and_step_match_the_cpu(cuda, name, dtype):
    """Each head's inference output and one training step on the card against
    the CPU's, from one seed: f32 to summation order, bf16 to the odd bf16
    rounding flip of a hidden value."""
    from chemprop_tpu_torch.train import Trainer

    batch = _head_batch(name)
    outs, losses, states = {}, {}, {}
    for device in ("cpu", cuda):
        trainer = Trainer(_head_model(name, dtype), seed=7, device=device)
        trainer.init_state(batch, 4)
        b = batch.to(device)
        with torch.inference_mode():
            outs[device] = trainer.model(b.bmg).float().cpu()
        UNSERVED.clear()
        losses[device] = float(trainer.train_step(batch))
        assert not any(UNSERVED.values())
        states[device] = {k: v.detach().float().cpu() for k, v in trainer.model.state_dict().items()}
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else dict(rtol=0, atol=2e-2)
    assert outs[cuda].shape == outs["cpu"].shape and outs["cpu"].shape[:2] == (len(SMIS), 2)
    torch.testing.assert_close(outs[cuda], outs["cpu"], **tol)
    assert losses[cuda] == pytest.approx(losses["cpu"], rel=1e-5 if dtype == torch.float32 else 2e-2)
    lr = 1e-4  # Adam's first step moves a weight by at most the rate
    for k, want in states["cpu"].items():
        assert float((states[cuda][k] - want).abs().max()) <= 2 * lr * (1 + 1e-3) + (
            0 if dtype == torch.float32 or not k.startswith("bn.running") else 0.05), k


@pytest.mark.parametrize("alias", ["mse", "bounded-mse", "r2", "binary-mcc", "multiclass-mcc",
                                   "sid", "binned-roc", "binned-prc"])
def test_streaming_metrics_on_cuda_tensors(cuda, alias):
    from chemprop_tpu_torch.nn import metrics

    metric = metrics.MetricRegistry[alias](**({"n_classes": 3} if "multiclass" in alias else {}))
    rng = np.random.default_rng(5)
    shape = (40, 3, 3) if "multiclass" in alias else (40, 3)
    preds = torch.from_numpy(rng.uniform(0.01, 1, shape).astype(np.float32))
    targets = torch.from_numpy((rng.uniform(0.01, 1, (40, 3)) if alias == "sid" else rng.integers(
        0, 3 if "multiclass" in alias else 2, (40, 3))).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=(40, 3)) > 0.2)
    lt = gt = torch.zeros(40, 3, dtype=torch.bool)
    args = (preds, targets, mask, torch.ones(40), lt, gt)
    want = metric.compute(metric.update_state(metric.init_state(), *args))
    got = metric.compute(metric.update_state(metric.init_state(), *(a.to(cuda) for a in args)))
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


def test_collected_metrics_of_a_fit_on_the_card(cuda):
    """AUROC, AUPRC, F1 and accuracy of a validation on the card (the card's
    predictions gathered to the host) equal those of the CPU's validation of
    the same model, and the CPU's own functions on the gathered arrays."""
    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.nn import metrics
    from chemprop_tpu_torch.train import Trainer

    val = {m: metrics.MetricRegistry[m]() for m in ("roc", "prc", "f1", "accuracy")}
    loader = DataLoader(_head_batch_dataset(), batch_size=8)
    records = {}
    for device in ("cpu", cuda):
        trainer = Trainer(_head_model("BinaryClassificationFFN", torch.float32), seed=7,
                          device=device, val_metrics=val)
        trainer.init_state(None, 1)
        records[device] = trainer._validate(loader, True)
        preds = trainer.predict(loader)
    Y = np.stack([d.y for d in loader.dataset.data]).astype(np.float32)
    for m in val:
        assert records[cuda][f"val_{m}"] == pytest.approx(records["cpu"][f"val_{m}"], abs=1e-6)
        assert records[cuda][f"val_{m}"] == pytest.approx(
            val[m].compute_from_arrays(preds, Y, np.isfinite(Y)), abs=1e-12)


def _head_batch_dataset():
    from chemprop_tpu_torch.data import MoleculeDatapoint, MoleculeDataset

    rng = np.random.default_rng(11)
    return MoleculeDataset([MoleculeDatapoint.from_smi(s, y=(rng.uniform(size=2) > 0.5) * 1.0)
                            for s in SMIS * 2])


# ------------------------------------------------ G and H over a split table
def _tox21_bmg(device):
    """Tox21's 500 molecules in one batch: 8 of them have more edge rows than
    a tile, so the batch has a split table and cross rows, no tile table."""
    import csv

    feat = SimpleMoleculeMolGraphFeaturizer()
    with open(DATA / "classification" / "mol.csv", newline="") as f:
        smis = [row[0] for row in list(csv.reader(f))[1:]]
    b = batch_mol_graphs([feat(make_mol(s)) for s in smis]).to(device)
    assert b.tile_ptr is None and b.split_ptr is not None and b.cross_rows.numel() > 0
    return b


@pytest.mark.parametrize("d", [128, 384])
def test_g_and_h_over_the_split_table_match_their_forms_without_one(cuda, d):
    """The tile kernels over the split table, the cross rows formed again
    from gz: every row, padding included, bit-equal to the forms without a
    table, two calls equal, one launch counted per call."""
    b = _tox21_bmg(cuda)
    graph = _graph(b)
    n_e, n_v = b.E.shape[0], b.V.shape[0]
    y = _randn((n_e, d), 81, cuda, torch.bfloat16)
    g_in = _randn((n_e, d), 82, cuda, torch.bfloat16)
    H0 = _randn((n_e, d), 83, cuda, torch.bfloat16)
    W = _randn((d, d), 84, cuda, torch.bfloat16, scale=d**-0.5)
    g_nodes = _randn((n_v, d), 85, cuda, torch.bfloat16)
    split = {"tiles": b.split_ptr, "cross": b.cross_rows}
    LAUNCHES.clear()
    got = bwd_message_nodes(g_nodes, y, *graph, **split)
    assert LAUNCHES["bwd_message_nodes"] == 1
    assert all(torch.equal(x, w) for x, w in zip(got, bwd_message_nodes(g_nodes, y, *graph)))
    assert all(torch.equal(x, w)
               for x, w in zip(got, bwd_message_nodes(g_nodes, y, *graph, **split)))
    for fold in (True, False):
        LAUNCHES.clear()
        got = bwd_message_premul(g_in, y, H0, W, *graph, fold_h0=fold, **split)
        assert LAUNCHES["bwd_message_premul"] == 1
        want = bwd_message_premul(g_in, y, H0, W, *graph, fold_h0=fold)
        assert all(torch.equal(x, w) for x, w in zip(got, want)), fold
        again = bwd_message_premul(g_in, y, H0, W, *graph, fold_h0=fold, **split)
        assert all(torch.equal(x, w) for x, w in zip(got, again)), fold


@pytest.mark.parametrize("depth", [3, 4])
def test_loop_readout_over_the_split_table_serves_g_and_h(cuda, depth):
    """A batch with a chain of 70 carbons: ``loop_readout`` with the split
    table gives the bits of the forms without a table, forward and
    gradients, and leaves nothing unserved."""
    b, d = _big_bmg(cuda), 128
    assert b.tile_ptr is None and b.cross_rows.numel() > 0
    H0 = _randn((b.E.shape[0], d), 86, cuda, torch.bfloat16)
    H0[_pad_rows(b)] = 0
    W = _randn((d, d), 87, cuda, torch.bfloat16, scale=d**-0.5)
    c = _randn((b.V.shape[0], d), 88, cuda, torch.bfloat16)
    c[-1] = 0

    def run(split):
        x, w = H0.clone().requires_grad_(), W.clone().requires_grad_()
        out = loop_readout(x, w, None, *_graph(b), depth, None, None, split)
        return (out, *torch.autograd.grad(out, [x, w], c))

    want = run(None)
    LAUNCHES.clear()
    UNSERVED.clear()
    got = run((b.split_ptr, b.cross_rows))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert UNSERVED["bwd_message_nodes"] == UNSERVED["bwd_message_premul"] == 0
    assert LAUNCHES["bwd_message_nodes"] == 1 and LAUNCHES["bwd_message_premul"] == depth - 2
