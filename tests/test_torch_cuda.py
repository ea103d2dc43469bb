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
    bwd_message,
    bwd_message_nodes,
    bwd_message_premul,
    fused_iter,
    loop_readout,
    message,
    row_gather,
    sorted_segment_sum,
    sorted_segment_sum_counts,
)
from chemprop_tpu_torch.ops.gather import row_gather_plain
from chemprop_tpu_torch.ops.message import (
    bwd_message_nodes_plain,
    bwd_message_plain,
    bwd_message_premul_plain,
    fused_iter_plain,
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
def test_message_matches_plain(bmg, cuda, d):
    H = _randn((bmg.E.shape[0], d), 0, cuda)
    before = LAUNCHES["message"]
    got = message(H, *_graph(bmg))
    assert LAUNCHES["message"] == before + 1
    want = message_plain(H, *_graph(bmg))
    # only the summation order differs
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("relu_stream", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_iter_matches_plain(bmg, cuda, relu_stream, bias, d):
    n = bmg.E.shape[0]
    H = _randn((n, d), 1, cuda, torch.bfloat16)
    H0 = _randn((n, d), 2, cuda, torch.bfloat16)
    W = _randn((d, d), 3, cuda, torch.bfloat16, scale=d**-0.5)
    b = _randn((d,), 4, cuda, torch.bfloat16) if bias else None
    got = fused_iter(H, H0, W, b, *_graph(bmg), relu_stream=relu_stream).float()
    want = fused_iter_plain(H, H0, W, b, *_graph(bmg), relu_stream=relu_stream).float()
    # the bf16 message may round one ulp apart, which W carries into y; y's
    # own rounding adds one ulp
    torch.testing.assert_close(got, want, rtol=2 * BF16_ULP, atol=0.02)


def _long_segments(device):
    """Sorted ids with empty, short and long segments, long ones starting
    and ending inside 32-row tiles and next to each other."""
    lengths = np.array([0, 1, 2, 3, 40, 1, 100, 1000, 0, 33, 31, 32, 64, 5, 997, 2])
    ids = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
    ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return torch.from_numpy(ids).to(device), torch.from_numpy(ptr).to(device)


@pytest.mark.parametrize("data_dtype,out_dtype", sorted(KERNEL_DTYPES, key=str))
@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("case", ["edges", "long"])
def test_segment_sum_matches_plain(bmg, cuda, data_dtype, out_dtype, with_counts, case):
    if case == "edges":
        ids, ptr = bmg.dst, bmg.edge_ptr
    else:
        ids, ptr = _long_segments(cuda)
    x = _randn((ids.shape[0], 384), 5, cuda, data_dtype)
    if with_counts:
        got, counts = sorted_segment_sum_counts(x, ids, ptr, out_dtype)
    else:
        got, counts = sorted_segment_sum(x, ids, ptr, out_dtype), None
    want, want_counts = sorted_segment_sum_plain(x, ids, ptr, out_dtype, with_counts)
    assert got.dtype == out_dtype and got.shape == want.shape
    rtol = BF16_ULP if out_dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-4)
    if with_counts:
        torch.testing.assert_close(counts, want_counts)


def test_segment_sum_is_deterministic(cuda):
    ids, ptr = _long_segments(cuda)
    x = _randn((ids.shape[0], 384), 6, cuda)
    a = sorted_segment_sum(x, ids, ptr)
    assert all(torch.equal(a, sorted_segment_sum(x, ids, ptr)) for _ in range(3))


def test_cuda_wrappers_raise_instead_of_falling_back(bmg, cuda):
    H = torch.zeros((bmg.E.shape[0], 128), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        fused_iter(H, H, torch.zeros((128, 128), device=cuda), None, *_graph(bmg))
    with pytest.raises(ValueError):
        message(H[:, :6], *_graph(bmg))  # not contiguous
    with pytest.raises(TypeError):  # the kernel is float32 only
        message(H.to(torch.bfloat16), *_graph(bmg))
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


@pytest.mark.parametrize("d", [128, 384])
def test_bwd_message_nodes_matches_plain(any_bmg, cuda, d):
    b = any_bmg
    g_nodes = _randn((b.V.shape[0], d), 13, cuda, torch.bfloat16)
    y = _randn((b.E.shape[0], d), 14, cuda, torch.bfloat16).clamp_min(0)
    before = LAUNCHES["bwd_message_nodes"]
    G, gz = bwd_message_nodes(g_nodes, y, *_graph(b))
    assert LAUNCHES["bwd_message_nodes"] == before + 1
    want_G, want_gz = bwd_message_nodes_plain(g_nodes, y, *_graph(b))
    torch.testing.assert_close(G.float(), want_G.float(), rtol=BF16_ULP, atol=1e-6)
    assert torch.equal(gz, want_gz)  # a masked copy
    pad = _pad_rows(b)
    assert not G[pad].any() and not gz[pad].any()


@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("fold_h0", [False, True])
def test_bwd_message_premul_matches_plain(any_bmg, cuda, fold_h0, d):
    b = any_bmg
    n = b.E.shape[0]
    G_in = _randn((n, d), 15, cuda, torch.bfloat16)
    y = _randn((n, d), 16, cuda, torch.bfloat16).clamp_min(0)
    H0 = _randn((n, d), 17, cuda, torch.bfloat16)
    W = _randn((d, d), 18, cuda, torch.bfloat16, scale=d**-0.5)
    before = LAUNCHES["bwd_message_premul"]
    G, z = bwd_message_premul(G_in, y, H0, W, *_graph(b), fold_h0=fold_h0)
    assert LAUNCHES["bwd_message_premul"] == before + 1
    want_G, want_z = bwd_message_premul_plain(G_in, y, H0, W, *_graph(b), fold_h0=fold_h0)
    # dh sums d products in f32 in another order, so gz and z may round to the
    # neighbouring bf16 value; G sums a few such values (each up to one ulp of
    # a value of size ~2 apart) and rounds once more
    torch.testing.assert_close(z.float(), want_z.float(), rtol=2 * BF16_ULP, atol=1e-5)
    torch.testing.assert_close(G.float(), want_G.float(), rtol=2 * BF16_ULP, atol=0.1)
    pad = _pad_rows(b)
    assert not G[pad].any() and not z[pad].any()


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
    for _ in range(3):
        b = bwd_message_premul(G_in, y, G_in, W, *_graph(bmg), fold_h0=True)
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
