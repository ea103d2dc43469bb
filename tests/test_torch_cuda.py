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
from chemprop_tpu_torch.ops import LAUNCHES, fused_iter, message
from chemprop_tpu_torch.ops import sorted_segment_sum, sorted_segment_sum_counts
from chemprop_tpu_torch.ops.message import fused_iter_plain, message_plain
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
