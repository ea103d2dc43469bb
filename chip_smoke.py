#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``chemprop_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--reps 21]

from the root of a checkout. It needs one CUDA device and exits non-zero,
printing no result, without one or outside a checkout. Phases, each fatal on
failure:

1. the card's name and power limit (``nvidia-smi``); build the kernels from
   ``chemprop_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. hold every kernel against its plain PyTorch version on the card, at the
   shapes of the serving path's benchmark batch: 2048 molecules of
   tests/data/regression/mol/mol.csv, tiled (the batch ``bench.py`` builds),
   hidden width 300 padded to 384: the fused iteration in its four forms,
   its padding rows and a second call bit for bit, its launch shape (the
   blocks the card runs at once); the weight-gradient kernel also at W_i's
   shape (128 input columns), at a ragged and at a short table, each twice,
   bit for bit; the premultiplied backward with the batch's tile table and
   without one, both forms equal bit for bit and two calls equal; the segment
   sum at both readouts (edges to nodes, nodes to graphs) in all three dtype
   pairs, with and without counts, two calls equal; the machine code of the
   three Hopper kernels read for ``wgmma`` and TMA, and of the segment sum
   for bulk copies (``cuobjdump -sass``);
3. the serving path: ``python -m chemprop_tpu_torch.cli predict`` on the 100
   rows of mol.csv with the reference checkpoint
   tests/data/example_model_v2_regression_mol.pt, on ``cuda`` in float32 and
   bfloat16, held against the same entry point's CPU predictions; the launch
   counts are zeroed just before each dtype's run and read just after it,
   and each path must have launched its own kernels;
4. the training path: the default model at full width (hidden width 300,
   depth 3, batch norm) through ``Trainer.fit`` and ``Trainer.predict`` on
   ``cuda``, 50 epochs over the 100 rows of mol.csv in unshuffled batches of
   32, in float32 and in bfloat16; the train MSE must reach 0.05 with batch
   statistics and 0.10 with the running ones, and each dtype's run must
   launch its own kernels and none of the other's; then one float32 step on
   the card against the same step on the CPU, and two bfloat16 fits from one
   seed, whose loss histories must be equal bit for bit;
5. the per-iteration path: the same model with dropout 0.1 in bfloat16
   through ``Trainer.fit``, ``predict`` and ``predict_mc_dropout`` (the loss
   must fall, two fits from one seed must give equal losses bit for bit,
   evaluation must not depend on the dropout generator), once more with the
   ``fused_bwd`` and ``grad_w`` options on (losses within the bfloat16
   tolerance of the first run's); the overfit run of phase 4 in bfloat16 with
   the ``iter2`` and ``grad_w`` options on, to the same bar; and one float32
   step with dropout on the card against the same step on the CPU, the masks
   made on the CPU from one seed and copied;
6. on the benchmark batch: the launches of one forward and of one training
   step of each path, counted on their own; timing with CUDA events of each
   kernel, its plain version and the one PyTorch call that computes the same
   function, where there is one (the weight gradient at W_h's and W_i's
   shapes, the segment sum at both readouts), and the fused iteration's
   unfused route; the forward's and the training step's molecules per
   second, and the step with each option on and off, and of a tanh model at
   depth 2 with ``grad_w`` (its W_h product composed through autograd).

The last lines of standard output are the ``kernels`` JSON line, the card's
name and power limit, and ``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json."""

from __future__ import annotations

import argparse
import csv
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CKPT = REPO / "tests/data/example_model_v2_regression_mol.pt"
MOL_CSV = REPO / "tests/data/regression/mol/mol.csv"
BATCH_SIZE = 2048  # bench.py's benchmark batch
BF16_ULP = 2.0**-7  # relative spacing of bfloat16

# published dense peaks (NVIDIA data sheets): memory bytes/s, bf16 tensor-core
# and f32 (non-tensor) operations/s, by the part named in the card's name
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),  # SXM, 80 GB HBM3
}

# the TPU kernels the port replaces; "timed" names the check whose inputs
# the timing phase uses, so that the row's error is that case's
KERNELS = {
    "message": dict(
        source="chemprop_tpu_torch/csrc/message.cu",
        replaces="chemprop_tpu/ops/fused_message.py:244",
        tpu_kernel="_kernel via _fused_message_impl",
        timed="message[float32]",
    ),
    "fused_iter": dict(
        source="chemprop_tpu_torch/csrc/fused_iter.cu",
        replaces="chemprop_tpu/ops/fused_message.py:290",
        tpu_kernel="_iter_kernel via _iter_impl",
        timed="fused_iter[relu_stream=False,bias=False]",
    ),
    "sorted_segment_sum": dict(
        source="chemprop_tpu_torch/csrc/segment.cu",
        replaces="chemprop_tpu/ops/sorted_segments.py:51",
        tpu_kernel="_make_kernel via _sorted_segment_sum_fwd_impl",
        timed="sorted_segment_sum[edge->node,torch.bfloat16->torch.bfloat16]",
    ),
    "bwd_message": dict(
        source="chemprop_tpu_torch/csrc/message_bwd.cu",
        replaces="chemprop_tpu/ops/fused_message.py:729",
        tpu_kernel="_bwd_msg_kernel via _bwd_msg_impl",
        timed="bwd_message[float32,acc=False,G]",
    ),
    "bwd_message_nodes": dict(
        source="chemprop_tpu_torch/csrc/message_bwd.cu",
        replaces="chemprop_tpu/ops/fused_message.py:863",
        tpu_kernel="_bwd_msg_nodes_kernel via _bwd_msg_nodes_impl",
        timed="bwd_message_nodes[G]",
    ),
    "bwd_message_premul": dict(
        source="chemprop_tpu_torch/csrc/bwd_premul.cu",
        replaces="chemprop_tpu/ops/fused_message.py:1055",
        tpu_kernel="_bwd_msg_premul_kernel via _bwd_msg_premul_impl",
        timed="bwd_message_premul[fold_h0=True,tiles=True,G]",
    ),
    "row_gather": dict(
        source="chemprop_tpu_torch/csrc/gather.cu",
        replaces="chemprop_tpu/ops/window_gather.py:40",
        tpu_kernel="_kernel via _window_gather_impl",
        timed="row_gather[bfloat16]",
    ),
    "fused_iter2": dict(
        source="chemprop_tpu_torch/csrc/message.cu",
        replaces="chemprop_tpu/ops/fused_message.py:394",
        tpu_kernel="_iter2_kernel via _iter2_impl",
        timed="fused_iter2[bias=False,y2]",
    ),
    "iter_bwd": dict(
        source="chemprop_tpu_torch/csrc/message_bwd.cu",
        replaces="chemprop_tpu/ops/fused_message.py:603",
        tpu_kernel="_iter_bwd_kernel via _iter_bwd_impl",
        timed="iter_bwd[dH]",
    ),
    "grad_weight": dict(
        source="chemprop_tpu_torch/csrc/grad_weight.cu",
        replaces="chemprop_tpu/ops/grad_weight.py:34",
        tpu_kernel="_kernel via grad_weight",
        timed="grad_weight",
    ),
}
# the launches of one forward and of one training step in each dtype; a
# kernel that is not named must not be launched at all (depth 3: two
# message-passing iterations, the M_v and the mean readout; the float32
# backward is the per-iteration chain, the bfloat16 one the node-cotangent
# kernel, the premultiplied kernel with fold_h0 and the row gather)
PATH_KERNELS = {
    "predict_float32": {"message": 2, "sorted_segment_sum": 2},
    "predict_bfloat16": {"fused_iter": 2, "sorted_segment_sum": 2},
    "train_float32": {"message": 2, "sorted_segment_sum": 2, "bwd_message": 2},
    "train_bfloat16": {"fused_iter": 2, "sorted_segment_sum": 2, "bwd_message_nodes": 1,
                       "bwd_message_premul": 1, "row_gather": 1},
    # dropout: the per-iteration ops, each with its own masked transposed
    # message; M_v's cotangent is a plain indexing, the mean readout's the row
    # gather. With fused_bwd the second iteration's backward is iter_bwd, which
    # forms its own dW, so grad_w launches grad_weight for W_i and the first
    # iteration alone
    "train_dropout_float32": {"message": 2, "sorted_segment_sum": 2, "bwd_message": 2},
    "train_dropout_bfloat16": {"fused_iter": 2, "sorted_segment_sum": 2, "bwd_message": 2,
                               "row_gather": 1},
    "train_dropout_bfloat16_fused_bwd_grad_w": {
        "fused_iter": 2, "sorted_segment_sum": 2, "bwd_message": 1, "iter_bwd": 1,
        "grad_weight": 2, "row_gather": 1},
    # iter2: the first two iterations are one launch; grad_w: W_i's dW product
    # and W_h's two
    "train_bfloat16_iter2": {"fused_iter2": 1, "sorted_segment_sum": 2, "bwd_message_nodes": 1,
                             "bwd_message_premul": 1, "row_gather": 1},
    "train_bfloat16_grad_w": {"fused_iter": 2, "sorted_segment_sum": 2, "bwd_message_nodes": 1,
                              "bwd_message_premul": 1, "row_gather": 1, "grad_weight": 3},
    "train_bfloat16_iter2_grad_w": {
        "fused_iter2": 1, "sorted_segment_sum": 2, "bwd_message_nodes": 1,
        "bwd_message_premul": 1, "row_gather": 1, "grad_weight": 3},
    # fused_readout off: the per-iteration ops without dropout
    "train_bfloat16_per_iteration": {"fused_iter": 2, "sorted_segment_sum": 2, "bwd_message": 2,
                                     "row_gather": 1},
    "train_dropout_bfloat16_fused_bwd": {"fused_iter": 2, "sorted_segment_sum": 2,
                                         "bwd_message": 1, "iter_bwd": 1, "row_gather": 1},
    "train_dropout_bfloat16_grad_w": {"fused_iter": 2, "sorted_segment_sum": 2, "bwd_message": 2,
                                      "grad_weight": 3, "row_gather": 1},
    # tanh at depth 2, composed: one message and its transposed backward, the
    # M_v and the mean readout, dW of W_i and of the iteration's W_h
    "train_bfloat16_tanh_depth2_grad_w": {"message": 1, "sorted_segment_sum": 2,
                                          "bwd_message": 1, "row_gather": 1, "grad_weight": 2},
}
# the training steps timed and counted on the benchmark batch: dtype, dropout
# rate, opt-in kernels and other message-passing arguments; each is held to
# PATH_KERNELS["train_" + name]
STEPS = {
    "float32": ("float32", 0.0, {}),
    "bfloat16": ("bfloat16", 0.0, {}),
    "bfloat16_iter2": ("bfloat16", 0.0, dict(iter2=True)),
    "bfloat16_grad_w": ("bfloat16", 0.0, dict(grad_w=True)),
    "bfloat16_iter2_grad_w": ("bfloat16", 0.0, dict(iter2=True, grad_w=True)),
    "bfloat16_per_iteration": ("bfloat16", 0.0, dict(fused_readout=False)),
    "dropout_float32": ("float32", 0.1, {}),
    "dropout_bfloat16": ("bfloat16", 0.1, {}),
    "dropout_bfloat16_fused_bwd": ("bfloat16", 0.1, dict(fused_bwd=True)),
    "dropout_bfloat16_grad_w": ("bfloat16", 0.1, dict(grad_w=True)),
    "dropout_bfloat16_fused_bwd_grad_w": ("bfloat16", 0.1, dict(fused_bwd=True, grad_w=True)),
    # another activation composes the message kernel and the products through
    # autograd; grad_w routes W_h's products there too (depth 2: one iteration)
    "bfloat16_tanh_depth2_grad_w": ("bfloat16", 0.0, dict(grad_w=True),
                                    dict(activation="tanh", depth=2)),
}
OVERFIT_BATCH_STATS_MSE, OVERFIT_RUNNING_STATS_MSE = 0.05, 0.10


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name: str) -> tuple[float, float, float]:
    for part, p in PEAKS.items():
        if part in name:
            return p
    fail(f"no published peaks for {name!r}")


def lipo_dataset():
    """The 100 rows of mol.csv with normalised targets, featurised once."""
    import numpy as np

    from chemprop_tpu_torch.data import MoleculeDatapoint, MoleculeDataset

    with open(MOL_CSV, newline="") as f:
        rows = list(csv.reader(f))[1:]
    ds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=np.array([float(y)])) for s, y in rows])
    ds.normalize_targets()
    ds.cache = True
    return ds


def benchmark_batch(ds, device):
    """The dataset's molecules tiled to the benchmark batch, with targets."""
    from chemprop_tpu_torch.data import collate_batch

    data = [ds[i] for i in range(len(ds))]
    data = (data * -(-BATCH_SIZE // len(data)))[:BATCH_SIZE]
    return collate_batch(data).to(device)


def max_err(got, want) -> tuple[float, float]:
    """(max abs error, max |want|)."""
    return float((got.float() - want.float()).abs().max()), float(want.float().abs().max())


def check(name: str, got, want, rtol: float, atol: float, errs: dict, scale=None) -> None:
    """Fail unless ``|got - want| <= atol + rtol * scale`` everywhere;
    ``scale`` is ``|want|`` unless given. Prints the largest error, the limit
    it was held to where it occurred, and the largest share of its limit that
    any element's error took."""
    abs_err, ref = max_err(got, want)
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * (want.float().abs() if scale is None else scale)
    worst = int(err.argmax())
    print(json.dumps({"check": name, "max_abs_err": abs_err, "max_abs_ref": ref,
                      "limit_at_max_err": float(limit.flatten()[worst]),
                      "max_err_over_limit": float((err / limit).max()) if atol > 0 else None,
                      "rtol": rtol, "atol": atol,
                      "scale": "|want|" if scale is None else "sum of |x| over the terms"}))
    if not (err <= limit).all():
        fail(f"{name}: kernel disagrees with its plain version (max abs err {abs_err})")
    errs[name] = abs_err


def check_kernels(bmg, d: int, seed: int) -> tuple[dict, dict]:
    """Phase 2: each kernel against its plain version at the main path's
    shapes, in the dtypes the main paths give it; returns the inputs the
    timing phase reuses and each check's max abs error."""
    import torch

    from chemprop_tpu_torch.ops import (
        bwd_message, bwd_message_nodes, bwd_message_premul, fused_iter, fused_iter2, grad_weight,
        iter_bwd, message, row_gather, sorted_segment_sum, sorted_segment_sum_counts,
    )
    from chemprop_tpu_torch.ops.gather import row_gather_plain
    from chemprop_tpu_torch.ops.grad_weight import grad_weight_plain
    from chemprop_tpu_torch.ops.message import (
        bwd_message_nodes_plain, bwd_message_plain, bwd_message_premul_plain,
        fused_iter2_plain, fused_iter_plain, iter_bwd_plain, message_plain,
    )
    from chemprop_tpu_torch.ops.segment import KERNEL_DTYPES, sorted_segment_sum_plain

    dev = bmg.V.device
    g = torch.Generator(device=dev).manual_seed(seed)
    n_e, n_v = bmg.E.shape[0], bmg.V.shape[0]
    graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
    H32 = torch.randn((n_e, d), generator=g, device=dev)
    H0 = torch.randn((n_e, d), generator=g, device=dev).to(torch.bfloat16)
    H = H32.to(torch.bfloat16)
    W = (torch.randn((d, d), generator=g, device=dev) * d**-0.5).to(torch.bfloat16)
    b = torch.randn(d, generator=g, device=dev).to(torch.bfloat16)
    Hv = torch.randn((n_v, d), generator=g, device=dev).to(torch.bfloat16)
    errs: dict = {}

    # f32: only the summation order differs; bf16 out: one rounding apart
    check("message[float32]", message(H32, *graph), message_plain(H32, *graph), 1e-5, 1e-5, errs)
    # bf16: f32 sums rounded once; a sum in another order may round to the
    # neighbouring bf16 value
    got = message(H, *graph)
    check("message[bfloat16]", got, message_plain(H, *graph), BF16_ULP, 1e-6, errs)
    if got[bmg.dst == n_v - 1].any():
        fail("message[bfloat16]: a padding row is not zero")
    pad_rows = bmg.dst == n_v - 1
    for relu_stream in (True, False):
        for bias in (None, b):
            tag = f"fused_iter[relu_stream={relu_stream},bias={bias is not None}]"
            x = H0 if relu_stream else H
            y = fused_iter(x, H0, W, bias, *graph, relu_stream=relu_stream)
            # the bf16 message may round one ulp apart, which W carries into
            # y; y's own rounding adds one ulp
            check(tag, y, fused_iter_plain(x, H0, W, bias, *graph, relu_stream=relu_stream),
                  2 * BF16_ULP, 0.02, errs)
            # a padding edge's message is zero: its row is relu(H0 [+ b]) exactly
            want_pad = torch.relu(H0.float() + (0 if bias is None else bias.float()))
            if not torch.equal(y[pad_rows], want_pad.to(torch.bfloat16)[pad_rows]):
                fail(f"{tag}: a padding row is not relu(H0 [+ b])")
            if not torch.equal(y, fused_iter(x, H0, W, bias, *graph, relu_stream=relu_stream)):
                fail(f"{tag}: two calls differ")
    # f32 sums in another order differ by up to a few eps times the sum of
    # |x| over the segment (the padding segments hold thousands of rows, and
    # the plain version's index_add_ order itself varies from run to run),
    # so f32 outputs are held to 1e-5 of that; a bf16 output rounds once more.
    # Both readouts (the M_v readout, edges to nodes, and the mean readout,
    # nodes to graphs) in all three dtype pairs, with and without counts;
    # no atomics on the data: a second call gives the same bits
    def abs_sums(data, ids, ptr):
        return sorted_segment_sum_plain(data.abs(), ids, ptr, torch.float32)[0]

    readouts = {"edge->node": (H32, bmg.dst, bmg.edge_ptr),
                "node->graph": (Hv.float(), bmg.batch, bmg.node_ptr)}
    for shape, (x32, ids, ptr) in readouts.items():
        for in_dtype, out_dtype in sorted(KERNEL_DTYPES, key=str):
            data = x32.to(in_dtype)
            for with_counts in (False, True):
                if with_counts:
                    got, counts = sorted_segment_sum_counts(data, ids, ptr, out_dtype)
                else:
                    got, counts = sorted_segment_sum(data, ids, ptr, out_dtype), None
                want, want_counts = sorted_segment_sum_plain(data, ids, ptr, out_dtype,
                                                             with_counts)
                tag = (f"sorted_segment_sum[{shape}{'+counts' if with_counts else ''},"
                       f"{in_dtype}->{out_dtype}]")
                if out_dtype == torch.bfloat16:
                    check(tag, got, want, BF16_ULP, 1e-4, errs)
                else:
                    check(tag, got, want, 1e-5, 1e-6, errs, abs_sums(data, ids, ptr))
                if with_counts and not torch.equal(counts, want_counts):
                    fail(f"{tag}: counts disagree")
                if not torch.equal(got, sorted_segment_sum(data, ids, ptr, out_dtype)):
                    fail(f"{tag}: two calls differ")

    # the backward kernels, at the shapes the training step gives them
    g32 = torch.randn((n_e, d), generator=g, device=dev)
    y32 = torch.randn((n_e, d), generator=g, device=dev).clamp_min(0)  # a ReLU output
    acc32 = torch.randn((n_e, d), generator=g, device=dev)
    gb, yb = g32.to(torch.bfloat16), y32.to(torch.bfloat16)
    g_nodes = torch.randn((n_v, d), generator=g, device=dev).to(torch.bfloat16)
    g_nodes[-1] = 0  # the sacrificial node's cotangent
    Mg = torch.randn((bmg.n_graphs + 1, d), generator=g, device=dev).to(torch.bfloat16)

    def zeros_on_padding(tag, *tables):
        if any(t[pad_rows].any() for t in tables):
            fail(f"{tag}: a padding row is not zero")

    # F. f32: only the summation order differs; bf16: f32 sums rounded once, so
    # a sum taken in another order may round to the neighbouring bf16 value
    for tag, gg, yy, acc, rtol, atol in (
        ("float32,acc=False", g32, y32, None, 1e-5, 1e-5),
        ("float32,acc=True", g32, y32, acc32, 1e-5, 1e-5),
        ("bfloat16,acc=False", gb, yb, None, BF16_ULP, 1e-6),
    ):
        G, gz = bwd_message(gg, yy, *graph, gz_acc=acc)
        want_G, want_gz = bwd_message_plain(gg, yy, *graph, gz_acc=acc)
        check(f"bwd_message[{tag},G]", G, want_G, rtol, atol, errs)
        check(f"bwd_message[{tag},gz]", gz, want_gz, rtol, atol, errs)
        zeros_on_padding(f"bwd_message[{tag}]", G, gz)
    # G: the same sums from the node table; gz is a masked copy, so exact
    G, gz = bwd_message_nodes(g_nodes, yb, *graph)
    want_G, want_gz = bwd_message_nodes_plain(g_nodes, yb, *graph)
    check("bwd_message_nodes[G]", G, want_G, BF16_ULP, 1e-6, errs)
    check("bwd_message_nodes[gz]", gz, want_gz, 0.0, 0.0, errs)
    zeros_on_padding("bwd_message_nodes", G, gz)
    # H: dh = G_in W^T sums d products on the tensor cores, in another order
    # and with their f32 accumulation, so gz and z may round to the
    # neighbouring bf16 value (one ulp of the value, 1e-4 near zero); G sums
    # such values: one ulp of each term, and one more at its own rounding,
    # so its limit scales with the sum of |gz| over its terms. With the tile
    # table it is one launch; without one (a molecule larger than a tile) the
    # same product and the node pass of F: the two forms give the same bits
    for fold in (True, False):
        want_G, want_z = bwd_message_premul_plain(gb, yb, H0, W, *graph, fold_h0=fold)
        gz_abs = ((gb.float() @ W.float().t()) * (yb > 0)).abs()
        terms = torch.zeros((n_v, d), device=dev).index_add_(0, bmg.dst.long(), gz_abs[bmg.rev.long()])
        outs = {}
        for tiles in (bmg.tile_ptr, None):
            tag = f"bwd_message_premul[fold_h0={fold},tiles={tiles is not None}"
            G, z = outs[tiles is not None] = bwd_message_premul(gb, yb, H0, W, *graph,
                                                                fold_h0=fold, tiles=tiles)
            check(f"{tag},G]", G, want_G, 2 * BF16_ULP, 1e-4, errs, terms[bmg.dst.long()])
            check(f"{tag},z]", z, want_z, 2 * BF16_ULP, 1e-4, errs)
            zeros_on_padding(f"{tag}]", G, z)
        if not all(torch.equal(a, b) for a, b in zip(outs[True], outs[False])):
            fail(f"bwd_message_premul[fold_h0={fold}]: the forms with and without tiles differ")
        again = bwd_message_premul(gb, yb, H0, W, *graph, fold_h0=fold, tiles=bmg.tile_ptr)
        if not all(torch.equal(a, b) for a, b in zip(again, outs[True])):
            fail(f"bwd_message_premul[fold_h0={fold}]: two calls differ")
    # I: a copy, so exact; the last row of the table is not zero here, and the
    # rows that name it must come out zero all the same
    got = row_gather(Mg, bmg.batch)
    check("row_gather[bfloat16]", got, row_gather_plain(Mg, bmg.batch), 0.0, 0.0, errs)
    if got[bmg.batch == bmg.n_graphs].any():
        fail("row_gather: a row of the sacrificial id is not zero")
    # D: both outputs equal two fused_iter launches bit for bit, on every row;
    # against the plain version y1 is held as fused_iter is, and y2 carries
    # y1's ulp through the second message and W
    for bias in (None, b):
        tag = f"fused_iter2[bias={bias is not None}"
        y1, y2 = fused_iter2(H0, W, bias, *graph, bmg.tile_ptr)
        w1 = fused_iter(H0, H0, W, bias, *graph, relu_stream=True)
        w2 = fused_iter(w1, H0, W, bias, *graph)
        if not (torch.equal(y1, w1) and torch.equal(y2, w2)):
            fail(f"{tag}]: not equal to two fused_iter launches bit for bit")
        p1, p2 = fused_iter2_plain(H0, W, bias, *graph)
        check(f"{tag},y1]", y1, p1, 2 * BF16_ULP, 0.02, errs)
        check(f"{tag},y2]", y2, p2, 2 * BF16_ULP, 0.05, errs)
    H0z = H0.masked_fill(pad_rows[:, None], 0)  # as W_i leaves them without a bias
    zeros_on_padding("fused_iter2", *fused_iter2(H0z, W, None, *graph, bmg.tile_ptr))
    # E: gz is a masked copy, so exact. G equals bwd_message's, whose sums may
    # round to the neighbouring bf16 value against the plain version's order;
    # dH = G W^T carries that and rounds once more, dW = H^T G sums E products
    # in f32 in another order: both limits scale with the sum of |terms|
    Hx = H.clamp_min(0)  # an iteration's input: a ReLU output, padding rows not zero
    dH, gz, dW = iter_bwd(gb, yb, Hx, W, *graph)
    want_dH, want_gz, want_dW = iter_bwd_plain(gb, yb, Hx, W, *graph)
    G_abs = bwd_message_plain(gb, yb, *graph)[0].float().abs()
    check("iter_bwd[gz]", gz, want_gz, 0.0, 0.0, errs)
    check("iter_bwd[dH]", dH, want_dH, 2 * BF16_ULP, 1e-4, errs, G_abs @ W.float().abs().t())
    check("iter_bwd[dW]", dW, want_dW, 1e-4, 1e-3, errs, Hx.float().t() @ G_abs)
    zeros_on_padding("iter_bwd", dH, gz)
    again = iter_bwd(gb, yb, Hx, W, *graph)
    if not all(torch.equal(a, w) for a, w in zip(again, (dH, gz, dW))):
        fail("iter_bwd: two runs differ")
    # J: exact bf16 products summed in f32 in another order. At W_h's shape
    # (the edge tables), at W_i's (the [V[src] ; E] table, 86 columns padded
    # to 128), at a ragged n (not a multiple of the 64-row step) and at an n
    # smaller than one row split; each the same bits over two runs
    Gt = bwd_message(gb, yb, *graph)[0]
    Xi = torch.randn((n_e, 128), generator=g, device=dev).to(torch.bfloat16)
    for tag, X, Gj in (("grad_weight", Hx, Gt), ("grad_weight[W_i]", Xi, Gt),
                       ("grad_weight[ragged]", Hx[: n_e - 37], Gt[: n_e - 37]),
                       ("grad_weight[short]", Xi[:1000], Gt[:1000])):
        dWj = grad_weight(X, Gj, use_kernel=True)
        check(tag, dWj, grad_weight_plain(X, Gj), 1e-5, 1e-3, errs,
              X.float().abs().t() @ Gj.float().abs())
        if not torch.equal(dWj, grad_weight(X, Gj, use_kernel=True)):
            fail(f"{tag}: two runs differ")
    torch.cuda.synchronize()
    tensors = dict(H32=H32, H=H, H0=H0, W=W, Hv=Hv, g32=g32, y32=y32, acc32=acc32, gb=gb, yb=yb,
                   g_nodes=g_nodes, Mg=Mg, Hx=Hx, Gt=Gt, Xi=Xi)
    return tensors, errs


def cli_predict(dtype: str, device: str | None, out: Path):
    """The user's entry point, in this process so that its launches count."""
    import numpy as np

    from chemprop_tpu_torch.cli.main import main

    argv = ["predict", "--model-path", str(CKPT), "-i", str(MOL_CSV), "-o", str(out),
            "--dtype", dtype]
    if device is not None:
        argv += ["--device", device]
    if main(argv) != 0:
        fail(f"predict --dtype {dtype} returned non-zero")
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != ["name", "pred_0"] or len(rows) != 101:
        fail(f"predict --dtype {dtype}: unexpected CSV layout {rows[0]} x {len(rows)}")
    preds = np.array([float(r[1]) for r in rows[1:]])
    if not np.isfinite(preds).all():
        fail(f"predict --dtype {dtype}: non-finite predictions")
    return preds


def check_path_launches(path: str, launches: dict, exact: bool) -> None:
    """Fail unless the path launched its kernels (with ``exact``, each the
    number of times one forward or one training step does) and no other."""
    for name in KERNELS:
        want, got = PATH_KERNELS[path].get(name, 0), launches.get(name, 0)
        ok = got == want if exact or want == 0 else got > 0
        if not ok:
            fail(f"the {path} path launched {name} {got} times, expected "
                 f"{want}{'' if exact or want == 0 else ' or more'}")


def main_path(out_dir: Path) -> tuple[dict, dict]:
    """Phase 3: the CLI on cuda in f32 and bf16, against its CPU predictions;
    each path's launches are counted on their own."""
    import numpy as np

    from chemprop_tpu_torch.ops import LAUNCHES

    gpu, launches = {}, {}
    for dt in ("float32", "bfloat16"):
        LAUNCHES.clear()
        gpu[dt] = cli_predict(dt, None, out_dir / f"gpu_{dt}.csv")
        launches[f"predict_{dt}"] = dict(LAUNCHES)
        check_path_launches(f"predict_{dt}", launches[f"predict_{dt}"], exact=False)
    print(json.dumps({"main_path_launches": launches}))
    cpu = {dt: cli_predict(dt, "cpu", out_dir / f"cpu_{dt}.csv") for dt in ("float32", "bfloat16")}
    res = {
        "f32_vs_cpu_f32": float(np.abs(gpu["float32"] - cpu["float32"]).max()),
        "bf16_vs_cpu_bf16": float(np.abs(gpu["bfloat16"] - cpu["bfloat16"]).max()),
        "bf16_vs_cpu_f32": float(np.abs(gpu["bfloat16"] - cpu["float32"]).max()),
        "pred_range": [float(cpu["float32"].min()), float(cpu["float32"].max())],
    }
    print(json.dumps({"main_path": res}))
    # f32: another summation order only. bf16 against the CPU's bf16: the
    # same computation, apart from summation order and the odd bf16 rounding
    # flip of a hidden value, which the mean readout and the f32 FFN shrink
    # far below one bf16 ulp of a prediction (2**-6 near 2.2). bf16 against
    # f32: the JAX package's bf16 parity envelope (rtol 0.05, atol 0.1)
    if not np.allclose(gpu["float32"], cpu["float32"], rtol=1e-5, atol=1e-4):
        fail("float32 predictions on cuda disagree with the CPU's")
    if not np.allclose(gpu["bfloat16"], cpu["bfloat16"], rtol=0, atol=1e-3):
        fail("bfloat16 predictions on cuda disagree with the CPU's bfloat16 ones")
    if not np.allclose(gpu["bfloat16"], cpu["float32"], rtol=0.05, atol=0.1):
        fail("bfloat16 predictions on cuda leave the envelope of the CPU's float32 ones")
    return launches, res


def default_model(dtype, dropout: float = 0.0, mp_kwargs: dict | None = None, **options):
    """The default model at full width: the one the reference checkpoint
    holds, with batch norm, as the reference's overfit run trains it;
    ``dropout`` in message passing and in the head, ``mp_kwargs`` other
    message-passing arguments, ``options`` the opt-in kernels (the
    environment is not read)."""
    from chemprop_tpu_torch.models import MPNN
    from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
    from chemprop_tpu_torch.ops import KernelOptions

    return MPNN(
        # d_h 300, depth 3, ReLU, no bias, unless mp_kwargs says otherwise
        BondMessagePassing(compute_dtype=dtype, dropout=dropout,
                           kernel_options=KernelOptions(**options), **(mp_kwargs or {})),
        MeanAggregation(),
        RegressionFFN(output_transform=False, dropout=dropout),
        batch_norm=True,
    )


def train_mse(trainer, loader, ds, use_batch_statistics: bool) -> float:
    import numpy as np

    preds = trainer.predict(loader, use_batch_statistics=use_batch_statistics)
    if preds.shape != (len(ds), 1) or not np.isfinite(preds).all():
        fail(f"Trainer.predict gave shape {preds.shape} or non-finite values")
    return float(np.mean((preds[:, 0] - ds.Y[:, 0]) ** 2))


def train_path(ds) -> tuple[dict, dict]:
    """Phase 4a: the reference's overfit run through ``Trainer.fit`` and
    ``Trainer.predict`` on cuda, in float32, in bfloat16, and in bfloat16 with
    the ``iter2`` and ``grad_w`` options on."""
    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.ops import LAUNCHES
    from chemprop_tpu_torch.train import Trainer

    launches, res = {}, {}
    for name, dt, options in (("float32", torch.float32, {}), ("bfloat16", torch.bfloat16, {}),
                              ("bfloat16_iter2_grad_w", torch.bfloat16,
                               dict(iter2=True, grad_w=True))):
        loader = DataLoader(ds, batch_size=32, shuffle=False)
        LAUNCHES.clear()
        t0 = time.time()
        trainer = Trainer(default_model(dt, **options), max_epochs=50, warmup_epochs=2, seed=12)
        trainer.fit(loader)
        fit_s = time.time() - t0
        if trainer.device.type != "cuda":
            fail(f"the Trainer chose {trainer.device}")
        eval_loader = DataLoader(ds, batch_size=32)
        mse_batch = train_mse(trainer, eval_loader, ds, True)
        mse_running = train_mse(trainer, eval_loader, ds, False)
        launches[f"train_{name}"] = dict(LAUNCHES)
        losses = [h["train_loss"] for h in trainer.history]
        res[name] = {"epochs": len(losses), "steps": trainer.state.step, "fit_s": fit_s,
                     "first_loss": losses[0], "last_loss": losses[-1],
                     "train_mse_batch_statistics": mse_batch, "limit_batch_statistics":
                     OVERFIT_BATCH_STATS_MSE, "train_mse_running_statistics": mse_running,
                     "limit_running_statistics": OVERFIT_RUNNING_STATS_MSE,
                     "launches": launches[f"train_{name}"]}
        print(json.dumps({"train_path": {name: res[name]}}))
        if not all(map(math.isfinite, losses)):
            fail(f"{name} training: a loss is not finite")
        if mse_batch > OVERFIT_BATCH_STATS_MSE:
            fail(f"{name} overfit MSE {mse_batch} > {OVERFIT_BATCH_STATS_MSE} (batch statistics)")
        if mse_running > OVERFIT_RUNNING_STATS_MSE:
            fail(f"{name} overfit MSE {mse_running} > {OVERFIT_RUNNING_STATS_MSE} "
                 "(running statistics)")
        check_path_launches(f"train_{name}", launches[f"train_{name}"], exact=False)
    return launches, res


def compare_steps(states: dict, losses: dict, tag: str) -> dict:
    """Hold the card's state after one float32 step (key None) to the CPU's."""
    lr = 1e-4  # the first step's rate
    n_all = n_off = 0
    worst = 0.0
    for name, want in states["cpu"].items():
        err = (states[None][name] - want).abs()
        worst = max(worst, float(err.max()))
        n_off += int((err > 1e-6 + 1e-4 * want.abs()).sum())
        n_all += err.numel()
    res = {"loss_cuda": losses[None], "loss_cpu": losses["cpu"], "loss_rtol": 1e-5,
           "max_abs_param_diff": worst, "limit_abs_param_diff": 2 * lr,
           "params_outside_rtol_1e-4": n_off, "params": n_all, "limit_share_outside": 1e-3}
    print(json.dumps({tag: res}))
    # f32 on both sides; only summation orders differ
    if abs(losses[None] - losses["cpu"]) > 1e-5 * abs(losses["cpu"]):
        fail(f"{tag}: the float32 training step's loss on cuda disagrees with the CPU's")
    # Adam's first step moves a weight by the rate times its gradient's sign,
    # whatever the gradient's size: where a gradient is at the level of f32
    # rounding, summation order decides the sign, and such an element differs
    # by twice the rate. Every element is within that; all but a thousandth
    # within rtol 1e-4 / atol 1e-6
    if worst > 2 * lr * (1 + 1e-3) or n_off > 1e-3 * n_all:
        fail(f"{tag}: the float32 training step's parameters on cuda disagree with the CPU's")
    return res


def step_against_cpu(ds) -> dict:
    """Phase 4b: one float32 training step on the card against the same step
    on the CPU, from the same state (the same seed) on the same batch."""
    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.train import Trainer

    batch = next(iter(DataLoader(ds, batch_size=32)))
    states, losses = {}, {}
    for device in ("cpu", None):
        trainer = Trainer(default_model(torch.float32), max_epochs=50, warmup_epochs=2, seed=12,
                          device=device)
        trainer.init_state(batch, 4)
        losses[device] = float(trainer.train_step(batch))
        states[device] = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    return compare_steps(states, losses, "train_step_cuda_vs_cpu")


def repeated_fits(ds) -> dict:
    """Phase 4c: two bfloat16 fits of 5 epochs from one seed; no kernel uses
    atomics, so their loss histories are equal bit for bit."""
    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.train import Trainer

    histories = []
    for _ in range(2):
        trainer = Trainer(default_model(torch.bfloat16), max_epochs=5, warmup_epochs=2, seed=12,
                          grad_clip=10.0)
        trainer.fit(DataLoader(ds, batch_size=32, shuffle=True, seed=3))
        histories.append([h["train_loss"] for h in trainer.history])
    res = {"histories": histories, "equal": histories[0] == histories[1]}
    print(json.dumps({"repeated_bfloat16_fits": res}))
    if not res["equal"] or not all(map(math.isfinite, histories[0])):
        fail("two bfloat16 fits from one seed gave different loss histories")
    return res


def dropout_path(ds) -> tuple[dict, dict]:
    """Phase 5a: the per-iteration path. The default model with dropout 0.1
    in bfloat16 through ``Trainer.fit``, ``predict`` and ``predict_mc_dropout``
    on cuda; a second fit from the same seed; a third with ``fused_bwd`` and
    ``grad_w`` on. Each fit's launches are counted on their own."""
    import numpy as np
    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.ops import LAUNCHES
    from chemprop_tpu_torch.train import Trainer

    def fit(**options):
        trainer = Trainer(default_model(torch.bfloat16, 0.1, **options), max_epochs=30,
                          warmup_epochs=2, seed=12)
        trainer.fit(DataLoader(ds, batch_size=32, shuffle=True, seed=3))
        return trainer, [h["train_loss"] for h in trainer.history]

    launches = {}
    LAUNCHES.clear()
    trainer, losses = fit()
    eval_loader = DataLoader(ds, batch_size=32)
    preds = trainer.predict(eval_loader)
    val = trainer.evaluate(eval_loader)
    mc = trainer.predict_mc_dropout(eval_loader, sampling_size=8, seed=1)
    launches["train_dropout_bfloat16"] = dict(LAUNCHES)
    check_path_launches("train_dropout_bfloat16", launches["train_dropout_bfloat16"], exact=False)
    # evaluation draws no mask: the training generator has moved on since (the
    # Monte-Carlo passes drew from their own), and another seed changes nothing
    trainer.state.rng.manual_seed(99)
    if not (np.array_equal(preds, trainer.predict(eval_loader))
            and val == trainer.evaluate(eval_loader)):
        fail("evaluation of the dropout model depends on the dropout generator")
    mc_again = trainer.predict_mc_dropout(eval_loader, sampling_size=8, seed=1)
    spread = mc.std(axis=0)
    mse = float(np.mean((preds[:, 0] - ds.Y[:, 0]) ** 2))
    res = {"epochs": len(losses), "first_loss": losses[0], "last_loss": losses[-1],
           "val_loss": val, "train_mse_running_statistics": mse,
           "mc_shape": list(mc.shape), "mc_mean_spread": float(spread.mean()),
           "mc_mean_vs_predict_rmse": float(np.sqrt(np.mean((mc.mean(axis=0) - preds) ** 2))),
           "launches": launches["train_dropout_bfloat16"]}
    if not all(map(math.isfinite, losses)) or not losses[-1] < 0.5 * losses[0]:
        fail(f"the dropout fit's loss did not fall: {losses[0]} -> {losses[-1]}")
    if mc.shape != (8, len(ds), 1) or not np.isfinite(mc).all() or not np.array_equal(mc, mc_again):
        fail("predict_mc_dropout: wrong shape, non-finite values or not reproducible")
    # the samples differ, and their mean stays within the targets' spread (1
    # after normalisation) of the deterministic prediction
    if not (spread > 0).all() or res["mc_mean_vs_predict_rmse"] > 1.0:
        fail(f"predict_mc_dropout: spread {spread.min()} or mean off the prediction")

    _, again = fit()
    res["repeated_fit_equal"] = again == losses
    if again != losses:
        fail("two dropout fits from one seed gave different loss histories")

    LAUNCHES.clear()
    _, fused = fit(fused_bwd=True, grad_w=True)
    name = "train_dropout_bfloat16_fused_bwd_grad_w"
    launches[name] = dict(LAUNCHES)
    check_path_launches(name, launches[name], exact=False)
    # the same masks and the same G; dH and dW are summed in another order, so
    # a bf16 value rounds the other way now and then, and training amplifies
    # that from epoch to epoch: the first three epochs' losses within 2%, the
    # mean of the last five within 25%
    rel = [abs(a - b) / abs(a) for a, b in zip(losses, fused)]
    tails = [sum(x[-5:]) / 5 for x in (losses, fused)]
    res["fused_bwd_grad_w"] = {"last_loss": fused[-1], "max_rel_diff_first_3_epochs": max(rel[:3]),
                               "max_rel_diff": max(rel), "mean_of_last_5": tails,
                               "launches": launches[name]}
    print(json.dumps({"dropout_path": res}))
    if (not all(map(math.isfinite, fused)) or max(rel[:3]) > 0.02
            or abs(tails[0] - tails[1]) > 0.25 * tails[0]):
        fail("the fit with fused_bwd and grad_w leaves the tolerance of the fit without")
    return launches, res


def dropout_step_against_cpu(ds) -> dict:
    """Phase 5b: one float32 training step with dropout 0.1 on the card
    against the same step on the CPU. The two devices' generators give other
    streams, so the masks are made on the CPU from one seed and copied."""
    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.nn import utils as nn_utils
    from chemprop_tpu_torch.train import Trainer

    batch = next(iter(DataLoader(ds, batch_size=32)))
    draw, masks = nn_utils.dropout_mask, []
    cpu_gen = torch.Generator().manual_seed(7)

    def record(shape, rate, generator, device):
        masks.append(draw(shape, rate, cpu_gen, torch.device("cpu")))
        return masks[-1]

    states, losses = {}, {}
    try:
        for device in ("cpu", None):
            replay = list(masks)
            nn_utils.dropout_mask = record if device == "cpu" else (
                lambda shape, rate, generator, dev: replay.pop(0).to(dev))
            trainer = Trainer(default_model(torch.float32, 0.1), max_epochs=50, warmup_epochs=2,
                              seed=12, device=device)
            trainer.init_state(batch, 4)
            losses[device] = float(trainer.train_step(batch))
            states[device] = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    finally:
        nn_utils.dropout_mask = draw
    if len(masks) != 4 or replay:  # two iterations, the node table, the head
        fail(f"the dropout step drew {len(masks)} masks on the CPU, {len(replay)} left on the card")
    res = compare_steps(states, losses, "train_dropout_step_cuda_vs_cpu")
    res["masks"] = len(masks)
    return res


def time_ms(fn, reps: int, inner: int = 5) -> float:
    """Median over ``reps`` runs of ``inner`` back-to-back calls between two
    CUDA events, per call, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, calls: int = 10) -> float:
    """Device milliseconds per call of the kernels ``fn`` launches, summed
    from a ``torch.profiler`` trace: the host's work between the launches,
    which CUDA events count where it is longer than the kernel, is not."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / calls / 1e3


def timings(bmg, t: dict, d: int, reps: int, card: str) -> dict:
    """Phase 4: kernel, plain and library times with the least time the card
    could take (bytes over the memory rate or operations over the peak)."""
    import torch

    from chemprop_tpu_torch.ops import (
        bwd_message, bwd_message_nodes, bwd_message_premul, fused_iter, fused_iter2, grad_weight,
        iter_bwd, message, row_gather, sorted_segment_sum, sorted_segment_sum_counts,
    )
    from chemprop_tpu_torch.ops.gather import row_gather_plain
    from chemprop_tpu_torch.ops.grad_weight import grad_weight_plain
    from chemprop_tpu_torch.ops.message import (
        bwd_message_nodes_plain, bwd_message_plain, bwd_message_premul_plain,
        fused_iter2_plain, fused_iter_plain, iter_bwd_plain, message_plain,
    )
    from chemprop_tpu_torch.ops.segment import sorted_segment_sum_plain

    bw, bf16_peak, f32_peak = peaks(card)
    graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
    n_e, n_v = bmg.E.shape[0], bmg.V.shape[0]
    real = bmg.edge_mask
    # per edge: the in-edges of its source (one add each) and the reverse edge
    in_deg = (bmg.edge_ptr[1:] - bmg.edge_ptr[:-1]).long()
    adds = float((in_deg[bmg.src.long()][real] + 1).sum()) * d
    n_real = int(real.sum())
    ids_bytes = 4 * (3 * n_e + n_v + 1)
    out = {}

    def bound(nbytes, ops, peak):
        tb, to = nbytes / bw * 1e3, ops / peak * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    # message, f32 as on the main path: H read once, M written once
    b_ms, b_by = bound(2 * n_e * d * 4 + ids_bytes, adds, f32_peak)
    out["message"] = dict(
        ms=time_ms(lambda: message(t["H32"], *graph), reps),
        plain_ms=time_ms(lambda: message_plain(t["H32"], *graph), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="float32",
        bfloat16=dict(  # as the composed path of a non-ReLU or undirected model calls it
            ms=time_ms(lambda: message(t["H"], *graph), reps),
            plain_ms=time_ms(lambda: message_plain(t["H"], *graph), reps),
            bound_ms=bound(2 * n_e * d * 2 + ids_bytes, adds, f32_peak)[0],
        ),
    )
    # fused iteration, bf16: H and H0 read, y written, W read once; the
    # message adds and the product of the real rows' messages with W. No one
    # library call computes it; beside it the unfused route: kernel A's bf16
    # message, a library product, then the residual and the ReLU
    b_ms, b_by = bound(3 * n_e * d * 2 + d * d * 2 + ids_bytes, 2 * n_real * d * d, bf16_peak)
    out["fused_iter"] = dict(
        ms=time_ms(lambda: fused_iter(t["H"], t["H0"], t["W"], None, *graph), reps),
        plain_ms=time_ms(lambda: fused_iter_plain(t["H"], t["H0"], t["W"], None, *graph), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="bfloat16",
        composed_ms=time_ms(
            lambda: torch.relu(t["H0"] + torch.mm(message(t["H"], *graph), t["W"])), reps),
    )
    out["fused_iter"]["share_of_bound"] = b_ms / out["fused_iter"]["ms"]
    # segment sum, the M_v readout in bf16: E rows read, N rows written, ids
    # and ptr read; beside it the same in f32 (the f32 model's)
    ids64 = bmg.dst.long()
    acc = torch.zeros((n_v, d), dtype=torch.bfloat16, device=bmg.V.device)
    b_ms, b_by = bound((n_e + n_v) * d * 2 + 4 * (n_e + n_v + 1), n_e * d, f32_peak)
    out["sorted_segment_sum"] = dict(
        ms=time_ms(lambda: sorted_segment_sum(t["H"], bmg.dst, bmg.edge_ptr), reps),
        plain_ms=time_ms(
            lambda: sorted_segment_sum_plain(t["H"], bmg.dst, bmg.edge_ptr, torch.bfloat16), reps
        ),
        library_ms=time_ms(lambda: acc.index_add_(0, ids64, t["H"]), reps),
        bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="bfloat16",
        float32=dict(
            ms=time_ms(lambda: sorted_segment_sum(t["H32"], bmg.dst, bmg.edge_ptr), reps),
            plain_ms=time_ms(lambda: sorted_segment_sum_plain(
                t["H32"], bmg.dst, bmg.edge_ptr, torch.float32), reps),
            bound_ms=bound((n_e + n_v) * d * 4 + 4 * (n_e + n_v + 1), n_e * d, f32_peak)[0],
        ),
    )
    out["sorted_segment_sum"]["share_of_bound"] = b_ms / out["sorted_segment_sum"]["ms"]
    # the same kernel at the mean readout's shape, bf16 node table to f32
    # graph rows with counts: N rows read, G rows and counts written, ids and
    # ptr read. index_add_ sums in the table's dtype, here bf16's
    n_g1 = bmg.node_ptr.numel() - 1
    batch64 = bmg.batch.long()
    acc_g = torch.zeros((n_g1, d), dtype=torch.bfloat16, device=bmg.V.device)
    b_ms, b_by = bound(n_v * d * 2 + n_g1 * d * 4 + 4 * (n_v + 2 * n_g1 + 1), n_v * d, f32_peak)
    out["sorted_segment_sum_counts"] = dict(
        ms=time_ms(lambda: sorted_segment_sum_counts(t["Hv"], bmg.batch, bmg.node_ptr), reps),
        plain_ms=time_ms(lambda: sorted_segment_sum_plain(
            t["Hv"], bmg.batch, bmg.node_ptr, torch.float32, True), reps),
        library_ms=time_ms(lambda: acc_g.index_add_(0, batch64, t["Hv"]), reps),
        bound_ms=b_ms, bound_by=b_by, shape=[n_v, d], dtype="bfloat16->float32",
    )
    out["sorted_segment_sum_counts"]["share_of_bound"] = (
        b_ms / out["sorted_segment_sum_counts"]["ms"])
    # F, f32 as in the float32 training step: g and y read (and gz_acc, in
    # the second call of a step), G and gz written; rev and ptr read. Per real
    # row and element: one add into the node's sum, one subtraction, one mask
    f_ids = 4 * (n_e + n_v + 1)
    b_ms, b_by = bound(4 * n_e * d * 4 + f_ids, 3 * n_real * d, f32_peak)
    b_acc, _ = bound(5 * n_e * d * 4 + f_ids, 4 * n_real * d, f32_peak)
    out["bwd_message"] = dict(
        ms=time_ms(lambda: bwd_message(t["g32"], t["y32"], *graph), reps),
        plain_ms=time_ms(lambda: bwd_message_plain(t["g32"], t["y32"], *graph), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="float32",
        with_gz_acc=dict(
            ms=time_ms(lambda: bwd_message(t["g32"], t["y32"], *graph, gz_acc=t["acc32"]), reps),
            bound_ms=b_acc,
        ),
        bfloat16=dict(
            ms=time_ms(lambda: bwd_message(t["gb"], t["yb"], *graph), reps),
            bound_ms=bound(4 * n_e * d * 2 + f_ids, 3 * n_real * d, f32_peak)[0],
        ),
    )
    # G, bf16: the node table and y read, G and gz written; dst read as well
    b_ms, b_by = bound((n_v + 3 * n_e) * d * 2 + f_ids + 4 * n_e, 3 * n_real * d, f32_peak)
    out["bwd_message_nodes"] = dict(
        ms=time_ms(lambda: bwd_message_nodes(t["g_nodes"], t["yb"], *graph), reps),
        plain_ms=time_ms(lambda: bwd_message_nodes_plain(t["g_nodes"], t["yb"], *graph), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="bfloat16",
    )
    # H with fold_h0, as at depth 3, over the batch's tile table: G_in, y and
    # H0 read, G and z written, W read once; the product of the real rows with
    # W^T on the tensor cores. Without fold_h0 (from depth 4) H0 is not read.
    # Beside it the form without a tile table and the unfused route: a library
    # product dh = G_in W^T, F's masked transposed message, then z in PyTorch
    b_ms, b_by = bound(5 * n_e * d * 2 + d * d * 2 + f_ids, 2 * n_real * d * d, bf16_peak)
    b_nofold, _ = bound(4 * n_e * d * 2 + d * d * 2 + f_ids, 2 * n_real * d * d, bf16_peak)

    def premul(fn, fold, tiles=bmg.tile_ptr):
        return fn(t["gb"], t["yb"], t["H0"], t["W"], *graph, fold_h0=fold, tiles=tiles)

    def unfused_premul():
        dh = torch.mm(t["gb"], t["W"].t())
        G, gz = bwd_message(dh, t["yb"], *graph)
        return G, gz + dh * (t["H0"] > 0)

    out["bwd_message_premul"] = dict(
        ms=time_ms(lambda: premul(bwd_message_premul, True), reps),
        plain_ms=time_ms(lambda: premul(bwd_message_premul_plain, True), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="bfloat16",
        without_tiles=dict(ms=time_ms(lambda: premul(bwd_message_premul, True, None), reps),
                           bound_ms=b_ms),
        without_fold_h0=dict(ms=time_ms(lambda: premul(bwd_message_premul, False), reps),
                             bound_ms=b_nofold),
        composed_ms=time_ms(unfused_premul, reps),
    )
    out["bwd_message_premul"]["share_of_bound"] = b_ms / out["bwd_message_premul"]["ms"]
    # I, bf16: the graph table and the ids read, the node table written
    n_g = t["Mg"].shape[0]
    b_ms, b_by = bound((n_g + n_v) * d * 2 + 4 * n_v, 0, f32_peak)
    out["row_gather"] = dict(
        ms=time_ms(lambda: row_gather(t["Mg"], bmg.batch), reps),
        plain_ms=time_ms(lambda: row_gather_plain(t["Mg"], bmg.batch), reps),
        library_ms=time_ms(lambda: torch.index_select(t["Mg"], 0, batch64), reps),
        bound_ms=b_ms, bound_by=b_by, shape=[n_v, d], dtype="bfloat16",
    )
    # D, bf16: H0 read, y1 and y2 written, W and the tile table read once; two
    # products of the real rows' messages with W. Beside it the two fused_iter
    # launches it stands for
    n_tiles = bmg.tile_ptr.numel() - 1
    b_ms, b_by = bound(3 * n_e * d * 2 + d * d * 2 + ids_bytes + 4 * (n_tiles + 1),
                       4 * n_real * d * d, bf16_peak)

    def two_iters():
        y1 = fused_iter(t["H0"], t["H0"], t["W"], None, *graph, relu_stream=True)
        return fused_iter(y1, t["H0"], t["W"], None, *graph)

    out["fused_iter2"] = dict(
        ms=time_ms(lambda: fused_iter2(t["H0"], t["W"], None, *graph, bmg.tile_ptr), reps),
        plain_ms=time_ms(lambda: fused_iter2_plain(t["H0"], t["W"], None, *graph), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="bfloat16",
        two_fused_iter_ms=time_ms(two_iters, reps), tiles=n_tiles,
    )
    # E, bf16: g, y and H read, dH and gz written, W read and dW written once;
    # the two products of the real rows. Beside it what it stands for: the
    # masked transposed message, then G W^T and H^T G as library products
    b_ms, b_by = bound(5 * n_e * d * 2 + d * d * 2 + d * d * 4 + f_ids, 4 * n_real * d * d,
                       bf16_peak)

    def composed_bwd():
        G, gz = bwd_message(t["gb"], t["yb"], *graph)
        return G @ t["W"].t(), gz, grad_weight(t["Hx"], G)

    out["iter_bwd"] = dict(
        ms=time_ms(lambda: iter_bwd(t["gb"], t["yb"], t["Hx"], t["W"], *graph), reps),
        plain_ms=time_ms(lambda: iter_bwd_plain(t["gb"], t["yb"], t["Hx"], t["W"], *graph), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="bfloat16",
        composed_ms=time_ms(composed_bwd, reps),
    )
    # J, bf16: X and G read, the [dx, d] f32 product written; at W_h's shape
    # and, nested, at W_i's
    def grad_weight_times(X, G):
        dx = X.shape[1]
        b_ms, b_by = bound(n_e * (dx + d) * 2 + dx * d * 4, 2 * n_e * dx * d, bf16_peak)
        ms = time_ms(lambda: grad_weight(X, G, use_kernel=True), reps)
        return dict(
            ms=ms, plain_ms=time_ms(lambda: grad_weight_plain(X, G), reps),
            library_ms=time_ms(lambda: torch.mm(X.t(), G, out_dtype=torch.float32), reps),
            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms, shape=[n_e, dx, d],
            dtype="bfloat16",
        )

    out["grad_weight"] = grad_weight_times(t["Hx"], t["Gt"])
    out["grad_weight"]["w_i"] = grad_weight_times(t["Xi"], t["Gt"])
    return out


def forward_rate(bmg, reps: int) -> dict:
    """Each dtype's launches in one forward on the benchmark batch (counted
    on their own, and held to the expected counts), then the forward's
    molecules per second (featurisation and collate are host work and not
    included)."""
    import torch

    from chemprop_tpu_torch.models import load_model
    from chemprop_tpu_torch.ops import LAUNCHES

    rates = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model, _ = load_model(CKPT, bmg.V.device, dt)
        LAUNCHES.clear()
        with torch.inference_mode():
            model(bmg)
        launches = dict(LAUNCHES)
        check_path_launches(f"predict_{name}", launches, exact=True)
        with torch.inference_mode():
            ms = time_ms(lambda: model(bmg), reps, inner=3)
        rates[name] = {"launches_per_forward": launches, "forward_ms": ms,
                       "molecules_per_s": BATCH_SIZE / ms * 1e3}
    return rates


def train_rate(batch, reps: int) -> dict:
    """The launches of one training step on the benchmark batch (counted on
    their own, and held to the expected counts) and the step's time and
    molecules per second (the batch lies on the card already): each dtype,
    then bfloat16 with each opt-in kernel on, and the step with dropout."""
    import torch

    from chemprop_tpu_torch.ops import LAUNCHES
    from chemprop_tpu_torch.train import Trainer

    rates = {}
    for name, (dtype, rate, options, *mp_kwargs) in STEPS.items():
        model = default_model(getattr(torch, dtype), rate, *mp_kwargs, **options)
        trainer = Trainer(model, seed=0)
        trainer.init_state(batch, 1)
        trainer.train_step(batch)
        LAUNCHES.clear()
        loss = float(trainer.train_step(batch))
        launches = dict(LAUNCHES)
        check_path_launches(f"train_{name}", launches, exact=True)
        if not math.isfinite(loss):
            fail(f"{name} training step on the benchmark batch: loss {loss}")
        ms = time_ms(lambda: trainer.train_step(batch), reps, inner=3)
        rates[name] = {"launches_per_step": launches, "step_ms": ms,
                       "molecules_per_s": BATCH_SIZE / ms * 1e3}
    return rates


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=21, help="timed runs per measurement (>= 20)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    if not (REPO / "chemprop_tpu_torch" / "csrc").is_dir() or not CKPT.exists():
        print("chip_smoke: run it from the root of a chemprop-tpu checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chemprop_tpu_torch.ops import (
        UNSERVED, build_all, sorted_segment_sum, sorted_segment_sum_counts,
    )
    from chemprop_tpu_torch.ops.build import sass_contains
    from chemprop_tpu_torch.ops.message import bwd_message_premul_info, fused_iter_info
    from chemprop_tpu_torch.ops.segment import sorted_segment_sum_info

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    t0 = time.time()
    logs = build_all()
    build_s = time.time() - t0
    print(json.dumps({"phase": "build", "seconds": build_s}))
    for name, (log, _) in logs.items():
        for line in log.splitlines():
            if "Used" in line or "error" in line:
                print(f"[{name}] {line.strip()}")
    # B's, H's and J's products run on wgmma (HGMMA), and W, W^T, G_in and
    # J's tables come in by TMA (UTMALDG); C's ranges come in by bulk copies
    # (UBLKCP)
    sass = {}
    for name, opcodes in (("fused_iter", ("HGMMA", "UTMALDG")), ("bwd_premul", ("HGMMA", "UTMALDG")),
                          ("grad_weight", ("HGMMA", "UTMALDG")), ("segment", ("UBLKCP",))):
        print(json.dumps({"build": f"csrc/{name}.cu", "seconds": logs[name][1]}))
        sass[name] = sass_contains(name, opcodes)
        print(json.dumps({f"{name}_sass": sass[name] if sass[name] is not None else
                          "not checked: the toolkit has no cuobjdump"}))
        if sass[name] is not None and not all(sass[name].values()):
            fail(f"csrc/{name}.cu's machine code lacks "
                 f"{[k for k, v in sass[name].items() if not v]}")

    d = 384  # hidden width 300, lane-padded as in the JAX package
    ds = lipo_dataset()
    batch = benchmark_batch(ds, "cuda")
    bmg = batch.bmg
    shapes = {"molecules": BATCH_SIZE, "E_pad": bmg.E.shape[0], "E_real": int(bmg.edge_mask.sum()),
              "N_pad": bmg.V.shape[0], "N_real": int(bmg.node_mask.sum()), "d": d}
    print(json.dumps({"benchmark_batch": shapes}))
    if bmg.tile_ptr is None:  # the tile kernels D and H need it
        fail("the benchmark batch has no tile table")
    # B's persistent grid: the blocks the card runs at once bound what runs
    # side by side, and the blocks of a tile's W slices must run together
    launch = fused_iter_info(d, shapes["E_pad"])
    launch["co_resident_blocks"] = launch["blocks_per_sm"] * torch.cuda.get_device_properties(
        0).multi_processor_count
    print(json.dumps({"fused_iter_launch": launch}))
    if launch["grid"] > launch["co_resident_blocks"]:
        fail(f"fused_iter's grid of {launch['grid']} blocks does not run at once")
    # H's persistent grid over the benchmark batch's tiles
    premul_launch = bwd_message_premul_info(d, bmg.tile_ptr.numel() - 1)
    print(json.dumps({"bwd_message_premul_launch": premul_launch}))
    # C's ranges and persistent grid at the M_v and the mean readout
    seg_launch = {
        "edge->node": sorted_segment_sum_info(shapes["E_pad"], shapes["N_pad"], d, torch.bfloat16,
                                              torch.bfloat16),
        "node->graph": sorted_segment_sum_info(shapes["N_pad"], bmg.node_ptr.numel() - 1, d,
                                               torch.bfloat16, torch.float32),
    }
    print(json.dumps({"sorted_segment_sum_launch": seg_launch}))
    tensors, errs = check_kernels(bmg, d, args.seed)

    out_dir = REPO / "chiprun_out"
    (out_dir / "chip_smoke_preds").mkdir(parents=True, exist_ok=True)
    UNSERVED.clear()  # the batches every main path gives a tile kernel, counted from here
    launches, path_res = main_path(out_dir / "chip_smoke_preds")
    train_launches, train_res = train_path(ds)
    launches.update(train_launches)
    step_res = step_against_cpu(ds)
    repeat_res = repeated_fits(ds)
    dropout_launches, dropout_res = dropout_path(ds)
    launches.update(dropout_launches)
    dropout_step_res = dropout_step_against_cpu(ds)

    times = timings(bmg, tensors, d, args.reps, kind)
    rates = forward_rate(bmg, args.reps)
    print(json.dumps({"forward": rates}))
    step_rates = train_rate(batch, args.reps)
    print(json.dumps({"train_step": step_rates}))
    # C's device time at both readouts, traced after every untraced timing
    # (a trace slows the launches after it): one call's host work is longer
    # than the kernel, so the events above count the host
    times["sorted_segment_sum"]["device_ms"] = device_ms(
        lambda: sorted_segment_sum(tensors["H"], bmg.dst, bmg.edge_ptr))
    times["sorted_segment_sum_counts"]["device_ms"] = device_ms(
        lambda: sorted_segment_sum_counts(tensors["Hv"], bmg.batch, bmg.node_ptr))
    unserved = dict(UNSERVED)
    print(json.dumps({"unserved": unserved}))
    if unserved.get("bwd_message_premul", 0):
        fail(f"bwd_message_premul left {unserved['bwd_message_premul']} batches without tiles")

    kernels = []
    for name, meta in KERNELS.items():
        by_path = {p: launches[p].get(name, 0) for p in launches}
        per_fwd = {p: rates[p]["launches_per_forward"].get(name, 0) for p in rates}
        per_step = {p: step_rates[p]["launches_per_step"].get(name, 0) for p in step_rates}
        checks = {tag: err for tag, err in errs.items() if tag.split("[")[0] == name}
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            tpu_kernel=meta["tpu_kernel"], launches=sum(by_path.values()),
            launches_by_path=by_path, launches_per_forward=per_fwd,
            launches_per_train_step=per_step,
            max_abs_err=errs[meta["timed"]], max_abs_err_by_check=checks, **times[name],
        ))
    # C at the mean readout's shape: the same kernel, counted under C's name
    c_entry = next(k for k in kernels if k["name"] == "sorted_segment_sum")
    kernels.append(dict(
        c_entry, name="sorted_segment_sum_counts", launch_counter="sorted_segment_sum",
        tpu_kernel=KERNELS["sorted_segment_sum"]["tpu_kernel"] + " (with_counts)",
        max_abs_err=errs["sorted_segment_sum[node->graph+counts,torch.bfloat16->torch.float32]"],
        **{key: times["sorted_segment_sum_counts"][key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape", "dtype",
            "share_of_bound", "device_ms")}))
    for key in ("float32", "max_abs_err_by_check"):
        kernels[-1].pop(key, None)
    record = {"card": card, "kind": kind, "build_s": build_s,
              "build_s_by_source": {name: sec for name, (_, sec) in logs.items()},
              "sass": sass, "fused_iter_launch": launch,
              "bwd_message_premul_launch": premul_launch,
              "sorted_segment_sum_launch": seg_launch, "unserved": unserved,
              "benchmark_batch": shapes,
              "main_path": path_res, "train_path": train_res, "train_step_cuda_vs_cpu": step_res,
              "repeated_bfloat16_fits": repeat_res, "dropout_path": dropout_res,
              "train_dropout_step_cuda_vs_cpu": dropout_step_res, "forward": rates,
              "train_step": step_rates,
              "kernels": kernels}
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
