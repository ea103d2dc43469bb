"""The sorted segment sum of the port (kernel C's wrappers) against the JAX
package's, over the segment layouts the card tests give the kernel, and the
host side of the kernel's design: its range geometry, and the cut rule by
which its ranges partition the rows.

On the CPU the wrappers take their plain version; the JAX side runs its
sorted segment sum as its own tests run it on the CPU, through its plain
reference (``jax.ops.segment_sum``). Inputs are made with numpy from a seed.
test_torch_cuda.py holds the CUDA kernel against the plain version on the
card, over the same layouts."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chemprop_tpu.ops.sorted_segments import sorted_segment_sum as jax_segment_sum
from chemprop_tpu.ops.sorted_segments import sorted_segment_sum_counts as jax_segment_sum_counts
from chemprop_tpu_torch.ops import LAUNCHES, sorted_segment_sum, sorted_segment_sum_counts
from chemprop_tpu_torch.ops.segment import (
    FAN_IN,
    KERNEL_DTYPES,
    MAX_RANGE,
    MAX_STAGES,
    MIN_RANGE,
    MIN_STAGES,
    RANGE_BYTES,
    RING_BYTES,
    SMEM_BYTES,
    range_geometry,
)
from test_torch_cuda import SEGMENT_LAYOUTS

BF16_ULP = 2.0**-7


def _layout(case):
    lengths = np.array(SEGMENT_LAYOUTS[case])
    ids = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
    ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    return ids, ptr


def _rand(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == torch.bfloat16:  # bf16-representable values, handed to both packages
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


@pytest.mark.parametrize("data_dtype,out_dtype", sorted(KERNEL_DTYPES, key=str))
@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("case", list(SEGMENT_LAYOUTS))
def test_segment_sum_layouts_match_jax(case, with_counts, data_dtype, out_dtype):
    ids, ptr = _layout(case)
    n_seg = len(ptr) - 1
    x = _rand((len(ids), 64), 11, data_dtype)
    xt = torch.from_numpy(x).to(data_dtype)
    ids_t, ptr_t = torch.from_numpy(ids), torch.from_numpy(ptr)
    jdt = jnp.bfloat16 if out_dtype == torch.bfloat16 else jnp.float32
    # JAX's CPU reference sums in the data dtype, so it is handed the f32
    # values (bf16-representable where the port gets bf16): both then sum in
    # f32 and cast once
    LAUNCHES.clear()
    if with_counts:
        want, want_counts = jax_segment_sum_counts(jnp.asarray(x), jnp.asarray(ids), n_seg, jdt)
        got, counts = sorted_segment_sum_counts(xt, ids_t, ptr_t, out_dtype)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
        assert counts.dtype == torch.float32
    else:
        want = jax_segment_sum(jnp.asarray(x), jnp.asarray(ids), n_seg, jdt)
        got = sorted_segment_sum(xt, ids_t, ptr_t, out_dtype)
    assert sum(LAUNCHES.values()) == 0  # the CPU takes the plain version
    assert got.dtype == out_dtype and got.shape == (n_seg, 64)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    # the long segments hold thousands of rows: f32 sums in another order
    # differ by a few eps of the segment's sum of |x|
    rtol = BF16_ULP if out_dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-4)
    empty = ptr[1:] == ptr[:-1]
    assert not got[empty].any()


@pytest.mark.parametrize("d", [4, 128, 300, 384, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_seg", [57_088, 2_049, 1])
def test_range_geometry(d, dtype, n_seg):
    n = 123_392
    rows, stages, scratch_rows, counters = range_geometry(n, n_seg, d, dtype)
    row_bytes = d * dtype.itemsize
    staged = row_bytes % 16 == 0
    assert MIN_RANGE <= rows <= MAX_RANGE and rows & (rows - 1) == 0
    # two stages of up to 2R rows fit the block's shared memory
    assert not staged or rows == MIN_RANGE or 2 * 2 * rows * row_bytes <= SMEM_BYTES
    # R only stops short of RANGE_BYTES' rows and twice the mean segment's
    # where the stages would not fit
    twice = 2 * rows
    grows = twice <= MAX_RANGE and (twice * row_bytes <= RANGE_BYTES or rows < 2 * n / n_seg)
    assert not grows or (staged and 2 * 2 * twice * row_bytes > SMEM_BYTES)
    assert MIN_STAGES <= stages <= MAX_STAGES
    if not staged:  # not bulk-copied: the ring holds ids alone
        assert stages == MAX_STAGES
    else:
        ring = 2 * rows * row_bytes * stages
        assert stages == MIN_STAGES or ring <= RING_BYTES
        assert ring + 8 * stages * (4 * MAX_RANGE + 8) + 1024 <= 232_448
    n_ranges = -(-n // rows)
    assert scratch_rows == 2 * n_ranges  # two slots per range
    # two counters per range for each level of the tree but the root, which
    # spans every range a segment can have pieces in
    levels = counters // scratch_rows
    assert counters == levels * scratch_rows
    assert FAN_IN**levels >= n_ranges > FAN_IN ** (levels - 1)


def test_range_geometry_of_the_main_path():
    # the M_v readout of the default model in bf16 and f32 (2.2 rows per
    # segment), and the mean readout (28 nodes per graph) in both
    assert range_geometry(123_392, 57_088, 384, torch.bfloat16) == (32, 2, 7712, 4 * 7712)
    assert range_geometry(123_392, 57_088, 384, torch.float32) == (16, 2, 15424, 5 * 15424)
    assert range_geometry(57_088, 2_049, 384, torch.bfloat16) == (64, 2, 1784, 4 * 1784)
    assert range_geometry(57_088, 2_049, 384, torch.float32) == (32, 2, 3568, 4 * 3568)
    assert range_geometry(0, 3, 384, torch.bfloat16) == (32, 2, 0, 0)


def _cuts(ids, ptr, R):
    """The kernel's range starts (``seg_cut`` in csrc/segment.cu): the first
    cut at or after k R, a cut being a segment start or a multiple of R
    inside a segment of more than R rows."""
    n = len(ids)

    def cut(k):
        r = k * R
        if r >= n or r == 0:
            return min(r, n)
        s = ids[r]
        if ids[r - 1] != s:
            return r
        return r if ptr[s + 1] - ptr[s] > R else int(ptr[s + 1])

    return [cut(k) for k in range(-(-n // R) + 1)]


@pytest.mark.parametrize("R", [8, 16, 32, 64])
@pytest.mark.parametrize("case", list(SEGMENT_LAYOUTS))
def test_ranges_partition_the_rows(case, R):
    """What the kernel's sums rely on: the ranges cover the rows in order, a
    range holds fewer than 2R rows, a segment of at most R rows lies in one
    range, and a longer one has one piece in each range from floor(p / R) to
    floor((q - 1) / R), the first starting at p: the pieces the warp that
    stores the last of them adds in range order."""
    ids, ptr = _layout(case)
    starts = _cuts(ids, ptr, R)
    assert starts[0] == 0 and starts[-1] == len(ids)
    assert all(0 <= b - a < 2 * R for a, b in zip(starts, starts[1:]))
    range_of = np.zeros(len(ids), np.int64)
    for k, (a, b) in enumerate(zip(starts, starts[1:])):
        range_of[a:b] = k
    for s in range(len(ptr) - 1):
        p, q = int(ptr[s]), int(ptr[s + 1])
        if q == p:
            continue
        ks = range_of[p:q]
        if q - p <= R:
            assert (ks == ks[0]).all()
        else:
            assert list(np.unique(ks)) == list(range(p // R, (q - 1) // R + 1))
            assert starts[p // R] <= p and range_of[p] == p // R
            # every later piece starts its range
            assert all(starts[k] == k * R for k in range(p // R + 1, (q - 1) // R + 1))


@pytest.mark.parametrize("case", ["edges", "graphs"])
@pytest.mark.parametrize("R", [16, 32, 64])
def test_ranges_partition_a_batch(case, R):
    """The same on a batch of molecules, whose padding segments hold every
    padding row."""
    from chemprop_tpu_torch.chem import make_mol
    from chemprop_tpu_torch.data.collate import batch_mol_graphs
    from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer

    feat = SimpleMoleculeMolGraphFeaturizer()
    smis = ["CCO", "c1ccccc1", "CC(=O)Nc1ccc(O)cc1", "C", "CC(C)CC1=CC=C(C=C1)C(C)C(=O)O"] * 40
    b = batch_mol_graphs([feat(make_mol(s)) for s in smis])
    ids, ptr = (b.dst, b.edge_ptr) if case == "edges" else (b.batch, b.node_ptr)
    ids, ptr = ids.numpy(), ptr.numpy()
    starts = _cuts(ids, ptr, R)
    assert starts[0] == 0 and starts[-1] == len(ids)
    assert all(0 <= b - a < 2 * R for a, b in zip(starts, starts[1:]))
    long = np.flatnonzero(np.diff(ptr) > R)
    assert len(long) > 0  # the padding segment at least
    for s in long:
        p, q = int(ptr[s]), int(ptr[s + 1])
        assert all(starts[k] == k * R for k in range(p // R + 1, (q - 1) // R + 1))
