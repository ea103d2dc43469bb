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
   hidden width 300 padded to 384: the message over the batch's tile table
   in float32 and bfloat16, bit for bit equal to its form without a table
   (message.cu) on every row and in a second call, its padding rows zero,
   and the sparse product of S - R with H that is timed beside it; the
   masked transposed message over the tile table in float32 and bfloat16,
   with and without gz_acc, and its unmasked form (the message's
   backward), bit for bit equal to its node-warp form (message_bwd.cu) and
   in a second call, its padding rows zero, and the sparse product of
   (S - R)^T timed beside it; the fused iteration in its four forms,
   its padding rows and a second call bit for bit, its launch shape (the
   blocks the card runs at once); the weight-gradient kernel also at W_i's
   shape (128 input columns), at a ragged and at a short table, each twice,
   bit for bit; the premultiplied backward and the node-cotangent backward
   with the batch's tile table and without one, both forms equal bit for bit
   and two calls equal, and both again on Tox21's 500 molecules in one batch
   (no tile table: its split table, molecules of more than 128 rows cut at
   their nodes' boundaries, and the cross rows formed again), bit for bit
   equal to their forms without a table; the segment sum at both readouts (edges to nodes,
   nodes to graphs) in all three dtype pairs, with and without counts, two
   calls equal; the whole-iteration backward with the batch's tile table and
   without one, gz equal bit for bit to the plain version in both forms, two
   calls equal; the two chained iterations over the tile table equal to two
   fused iterations bit for bit, with and without a bias, in two calls, its
   padding rows zero where H0's are, and its launch shape (clusters of one
   block per W slice); the machine code of the five Hopper kernels read for
   ``wgmma`` and TMA (the two chained iterations and the whole-iteration
   backward also for bulk copies), of the message over the tiles, the
   segment sum and the node-cotangent backward for bulk copies, and of the
   masked transposed message over the tiles for bulk copies and TMA
   (``cuobjdump -sass``);
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
   made on the CPU from one seed and copied. No main path may leave a batch
   without its tile table (``ops.UNSERVED``), the message of every float32
   iteration and of the composed tanh step, the ``iter2`` fit's two chained
   iterations and the ``fused_bwd`` fit's whole-iteration backward included;
6. the rest of message passing and of the trainer, at full width, each
   part fatal: (a) a descriptor model (atom descriptors through W_d, 303
   columns padded to 384; molecule descriptors; extra atom and bond features,
   each with its scaling transform, from the repo's .npz files) trained in
   bfloat16 for 30 epochs with validation metrics (MAE, RMSE, R2, every
   epoch finite), ``monitor="val_rmse"``, ``patience`` and
   ``checkpoint_dir``, to the bars ``DESCRIPTOR_TRAIN_LOSS`` and
   ``DESCRIPTOR_VAL_RMSE``; ``best.ckpt`` and ``last.ckpt`` reload through
   ``load_model``, the best one's predictions equal ``Trainer.predict``'s bit
   for bit; (b) six epochs of it with dropout against three, ``last.ckpt``,
   ``resume_from`` and three more: losses and predictions bit for bit; (c)
   ``freeze`` of message passing: its tensors bit-equal, the head's moved;
   (d) the depth loop: one float32 step against the CPU's, the bfloat16
   overfit run to phase 4's bar with and without ``grad_w``, F carrying the
   running dH0 in its second launch of a step, no G or H; (e) the bfloat16
   forward with ``window_gather`` on and off bit for bit, I launched in the
   forward, nothing refused; (f) one float32 step with
   ``activation="leakyrelu:0.1"`` against the CPU's; (g) the float32 taps
   against the CPU's. The phase's seconds are printed on their own line;
7. on the benchmark batch: the launches of one forward and of one training
   step of each path, counted on their own; timing with CUDA events of each
   kernel, its plain version and the one PyTorch call that computes the same
   function, where there is one (the message's sparse product and F's,
   the transposed one, in both dtypes, the weight
   gradient at W_h's and W_i's shapes, the segment sum at both readouts),
   F's two-call library route (the mask, then the sparse product), the
   message and F without a table, the unfused routes of the fused iteration,
   of the two tiled backward kernels and of the whole-iteration backward,
   and the device time of the message in both dtypes and both forms, of the
   segment sum, of the node-cotangent backward, of the two chained
   iterations, of the whole-iteration backward and of F in float32 and
   bfloat16, each with and without the running dH0 and without a table,
   with its sparse product, from a trace; the
   forward's and the training step's molecules per second, and the step with
   each option on and off, and of a tanh model at depth 2 with ``grad_w``
   (its W_h product composed through autograd);
8. the task heads, each part fatal: (a) ``cli predict`` of the seven
   reference checkpoints whose heads are not regression ones (binary,
   multiclass, binary and multiclass Dirichlet, MVE, evidential, quantile) on
   the 100 rows of mol.csv on ``cuda`` in float32 and bfloat16, against the
   CPU's in each dtype at phase 3's limits (class labels equal where the
   CPU's two best classes are apart), each run launching its dtype's kernels;
   (b) bfloat16 fits at full width of a BCE model on
   classification/mol.csv (four tasks with missing labels, ``roc`` and
   ``prc`` validation metrics), a CE model on mol_multiclass.csv and an MVE
   model on mol.csv, ``HEAD_FIT_EPOCHS`` epochs each, the last train loss
   below its bar, every validation metric finite, twice from one seed with
   equal histories bit for bit; a shuffled batch that holds a molecule of
   more than 128 directed edges has no tile table, and its step's G and H
   take its split table (counted on the host, reported beside the fit), so
   that nothing is left unserved; (c) one float32 step of BCE, CE, Dirichlet,
   evidential, quantile and bounded MSE (regression/bounded.csv, its ``<``
   and ``>`` targets as the masks) against the CPU's; (d) every fit's
   ``edges_per_s`` positive and finite. The phase's seconds are printed on
   their own line.

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
MOL_DIR = REPO / "tests/data/regression/mol"
MOL_CSV = MOL_DIR / "mol.csv"
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
        source="chemprop_tpu_torch/csrc/message_tiles.cu",
        replaces="chemprop_tpu/ops/fused_message.py:244",
        tpu_kernel="_kernel via _fused_message_impl",
        timed="message[bfloat16,tiles]",
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
        source="chemprop_tpu_torch/csrc/message_bwd_tiles.cu",
        replaces="chemprop_tpu/ops/fused_message.py:729",
        tpu_kernel="_bwd_msg_kernel via _bwd_msg_impl",
        timed="bwd_message[float32,acc=False,G]",
    ),
    "bwd_message_nodes": dict(
        source="chemprop_tpu_torch/csrc/bwd_nodes.cu",
        replaces="chemprop_tpu/ops/fused_message.py:863",
        tpu_kernel="_bwd_msg_nodes_kernel via _bwd_msg_nodes_impl",
        timed="bwd_message_nodes[tiles=True,G]",
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
        source="chemprop_tpu_torch/csrc/iter2.cu",
        replaces="chemprop_tpu/ops/fused_message.py:394",
        tpu_kernel="_iter2_kernel via _iter2_impl",
        timed="fused_iter2[bias=False,y2]",
    ),
    "iter_bwd": dict(
        source="chemprop_tpu_torch/csrc/iter_bwd.cu",
        replaces="chemprop_tpu/ops/fused_message.py:603",
        tpu_kernel="_iter_bwd_kernel via _iter_bwd_impl",
        timed="iter_bwd[tiles=True,dH]",
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
    # tanh at depth 2, composed: one message over the tile table and its
    # transposed backward, the M_v and the mean readout, dW of W_i and of the
    # iteration's W_h
    "train_bfloat16_tanh_depth2_grad_w": {"message": 1, "sorted_segment_sum": 2,
                                          "bwd_message": 1, "row_gather": 1, "grad_weight": 2},
    # the depth loop: B (A in f32) per iteration, then M_v by C; its backward
    # is F per iteration, the second with the running dH0 (gz_acc), never G
    # or H; grad_w: W_i's dW and W_h's two by J
    "train_float32_depth_loop": {"message": 2, "sorted_segment_sum": 2, "bwd_message": 2},
    "train_bfloat16_depth_loop": {"fused_iter": 2, "sorted_segment_sum": 2, "bwd_message": 2,
                                  "row_gather": 1},
    "train_bfloat16_depth_loop_grad_w": {"fused_iter": 2, "sorted_segment_sum": 2,
                                         "bwd_message": 2, "row_gather": 1, "grad_weight": 3},
    # window_gather: W_i's input gather V[src] by I in the forward, beside the
    # mean readout's backward
    "predict_bfloat16_window_gather": {"fused_iter": 2, "sorted_segment_sum": 2,
                                       "row_gather": 1},
    "predict_descriptors_bfloat16_window_gather": {"fused_iter": 2, "sorted_segment_sum": 2,
                                                   "row_gather": 1},
    "train_bfloat16_window_gather": {"fused_iter": 2, "sorted_segment_sum": 2,
                                     "bwd_message_nodes": 1, "bwd_message_premul": 1,
                                     "row_gather": 2},
    # the descriptor model (V_d through W_d at 303 columns padded to 384, X_d,
    # V_f and E_f): the default bf16 step's kernels at the new node width
    "train_descriptors_bfloat16": {"fused_iter": 2, "sorted_segment_sum": 2,
                                   "bwd_message_nodes": 1, "bwd_message_premul": 1,
                                   "row_gather": 1},
    # dropout: the per-iteration ops
    "train_descriptors_dropout_bfloat16": {"fused_iter": 2, "sorted_segment_sum": 2,
                                           "bwd_message": 2, "row_gather": 1},
    "train_float32_leakyrelu": {"message": 2, "sorted_segment_sum": 2, "bwd_message": 2},
    # phase 8: every head sits on the same message passing, so its paths launch
    # the default model's kernels: serving the seven reference checkpoints of
    # other heads (all depth 3) in each dtype, the bf16 fits of three heads and
    # one f32 step of six criteria
    "predict_heads_float32": {"message": 2, "sorted_segment_sum": 2},
    "predict_heads_bfloat16": {"fused_iter": 2, "sorted_segment_sum": 2},
    **{f"train_heads_bfloat16_{name}": {
        "fused_iter": 2, "sorted_segment_sum": 2, "bwd_message_nodes": 1,
        "bwd_message_premul": 1, "row_gather": 1} for name in ("bce", "ce", "mve")},
    **{f"train_heads_float32_{name}": {"message": 2, "sorted_segment_sum": 2, "bwd_message": 2}
       for name in ("bce", "ce", "dirichlet", "evidential", "quantile", "bounded")},
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
    "float32_depth_loop": ("float32", 0.0, dict(depth_loop=True)),
    "bfloat16_depth_loop": ("bfloat16", 0.0, dict(depth_loop=True)),
    "bfloat16_depth_loop_grad_w": ("bfloat16", 0.0, dict(depth_loop=True, grad_w=True)),
    "bfloat16_window_gather": ("bfloat16", 0.0, dict(window_gather=True)),
}
OVERFIT_BATCH_STATS_MSE, OVERFIT_RUNNING_STATS_MSE = 0.05, 0.10
# phase 8: the reference checkpoints of the other heads, served by the CLI
HEAD_CHECKPOINTS = [
    "example_model_v2_classification_mol.pt",
    "example_model_v2_classification_mol_multiclass.pt",
    "example_model_v2_classification_dirichlet_mol.pt",
    "example_model_v2_multiclass_dirichlet_mol.pt",
    "example_model_v2_regression_mve_mol.pt",
    "example_model_v2_regression_evidential_mol.pt",
    "example_model_v2_regression_quantile_mol.pt",
]
# phase 8(b): the bf16 fits of three heads, HEAD_FIT_EPOCHS epochs each; the
# last epoch's train loss must fall below the bar. The bars come from the same
# fits in bf16 on the CPU (experiments/torch_head_fits.py, which runs
# head_fit(name, torch.bfloat16, "cpu") beside the card's): first and last
# epochs' losses 0.552 -> 0.113 (BCE), 0.960 -> 0.037 (CE), 1.742 -> 0.363
# (MVE), the card's first epochs within 7e-4 of them. Each bar is about twice
# the CPU's last loss: the fits part in their last epochs (summation order;
# MVE's loss rose by 0.46 from one epoch to the next on the CPU)
HEAD_FIT_EPOCHS = 20
HEAD_FIT_BARS = {"bce": 0.25, "ce": 0.08, "mve": 0.8}
# phase 6(a): the descriptor model's 30 epochs must bring the last epoch's train
# loss (normalised targets) to this, and the best epoch's val_rmse to the other
DESCRIPTOR_TRAIN_LOSS, DESCRIPTOR_VAL_RMSE = 0.05, 0.5


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


def bwd_nodes_bytes(bmg, d: int) -> int:
    """The bytes kernel G (``bwd_message_nodes`` over the tile table) must
    move at width ``d``: ``y`` read over the real rows, ``g_nodes`` over the
    nodes that own real rows, ``G`` and ``gz`` written over every row (the
    padding rows as zeros, with no load), ``dst`` and ``rev`` of the real
    rows, the tile table, and the one entry of ``ptr`` that marks the first
    padding row."""
    ptr = bmg.edge_ptr
    n_real = int(bmg.edge_mask.sum())
    owners = int((ptr[1:-1] > ptr[:-2]).sum())  # the padding node, last, left out
    n_tiles = bmg.tile_ptr.numel() - 1
    return (n_real + owners + 2 * bmg.E.shape[0]) * d * 2 + 8 * n_real + 4 * (n_tiles + 1) + 4


def bwd_message_bytes(bmg, d: int, itemsize: int, acc: bool = False, masked: bool = True) -> int:
    """The bytes kernel F (``bwd_message`` over the tile table) must move at
    width ``d`` in a dtype of ``itemsize`` bytes: ``g`` read over the real
    rows, with ``masked`` (a depth iteration's F) ``y`` read over the real
    rows and ``gz`` written over every row, with ``acc`` ``gz_acc`` read over
    the real rows, ``G`` written over every row (the padding rows as zeros,
    with no load), ``dst`` and ``rev`` of the real rows, the tile table, and
    the one entry of ``ptr`` that marks the first padding row. Unmasked (the
    message's own backward) it forms ``G`` alone."""
    n_real = int(bmg.edge_mask.sum())
    n_tiles = bmg.tile_ptr.numel() - 1
    reads = n_real * (1 + int(masked) + int(acc))
    writes = bmg.E.shape[0] * (1 + int(masked))
    return (reads + writes) * d * itemsize + 8 * n_real + 4 * (n_tiles + 1) + 4


def iter_bwd_bytes(bmg, d: int) -> int:
    """The bytes kernel E (``iter_bwd`` over the tile table) must move at
    width ``d``: ``g``, ``y`` and ``H`` read over the real rows, ``dH`` and
    ``gz`` written over every row (the padding rows as zeros, with no load),
    ``W`` read and the float32 ``dW`` written once, ``dst`` and ``rev`` of the
    real rows, the tile table, and the one entry of ``ptr`` that marks the
    first padding row."""
    n_real = int(bmg.edge_mask.sum())
    n_tiles = bmg.tile_ptr.numel() - 1
    return ((3 * n_real + 2 * bmg.E.shape[0]) * d * 2 + d * d * (2 + 4) + 8 * n_real
            + 4 * (n_tiles + 1) + 4)


def message_bytes(bmg, d: int, itemsize: int) -> int:
    """The bytes kernel A (``message`` over the tile table) must move at
    width ``d`` in a dtype of ``itemsize`` bytes: ``H`` read over the real
    rows, ``M`` written over every row (the padding rows as zeros, with no
    load), ``src`` and ``rev`` of the real rows, the ``ptr`` entries of the
    real nodes (the in-edge ranges of the real rows' sources) and the one
    that marks the first padding row, and the tile table."""
    n_real = int(bmg.edge_mask.sum())
    n_nodes = int(bmg.node_mask.sum())
    n_tiles = bmg.tile_ptr.numel() - 1
    return ((n_real + bmg.E.shape[0]) * d * itemsize + 8 * n_real + 4 * (n_nodes + 1) + 4
            + 4 * (n_tiles + 1))


def message_matrix(bmg):
    """``S - R`` as an ``[E x E]`` CSR matrix of float32 ones, on the batch's
    device: row ``e`` of a real edge holds the in-edges of ``src[e]`` other
    than ``rev[e]`` (which is one of them: its +1 and -1 cancel), a padding
    row nothing. ``torch.sparse.mm`` of it with ``H`` computes kernel A's
    function in one library call; the port never calls it."""
    import torch

    src, rev, ptr = bmg.src.long(), bmg.rev.long(), bmg.edge_ptr.long()
    n = src.numel()
    rows_all = torch.arange(n, device=src.device)
    deg = torch.where(rows_all < ptr[-2], ptr[src + 1] - ptr[src], 0)
    rows = torch.repeat_interleave(rows_all, deg)
    first = torch.repeat_interleave(ptr[src], deg)
    offset = torch.arange(rows.numel(), device=src.device) - torch.repeat_interleave(
        torch.cumsum(deg, 0) - deg, deg)
    cols = first + offset
    keep = cols != rev[rows]
    rows, cols = rows[keep], cols[keep]
    crow = torch.zeros(n + 1, dtype=torch.long, device=src.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_csr_tensor(crow, cols, torch.ones(cols.numel(), device=src.device),
                                   size=(n, n))


def fused_iter2_bytes(bmg, d: int) -> int:
    """The bytes kernel D (``fused_iter2`` over the tile table) must move at
    width ``d``: ``H0`` read and ``y1``, ``y2`` written over every row (the
    padding rows carry ``relu(H0 [+ b])``), ``W`` read once, ``src`` and
    ``rev`` of the real rows, the ``ptr`` entries of the real nodes (the
    in-edge ranges of the real rows' sources), and the tile table."""
    n_real = int(bmg.edge_mask.sum())
    n_nodes = int(bmg.node_mask.sum())
    n_tiles = bmg.tile_ptr.numel() - 1
    return (3 * bmg.E.shape[0] * d * 2 + d * d * 2 + 8 * n_real + 4 * (n_nodes + 1)
            + 4 * (n_tiles + 1))


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
    from chemprop_tpu_torch.ops.message import _transposed as transposed
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

    # A over the tile table and in message.cu's form: f32, only the summation
    # order differs from the plain version's; bf16, f32 sums rounded once, so
    # a sum in another order may round to the neighbouring bf16 value. The
    # two forms sum the same values in the same order: the same bits on every
    # row, padding zeros included, and a second call the same bits again
    pad_rows = bmg.dst == n_v - 1
    SR = message_matrix(bmg)
    for x, rtol, atol in ((H32, 1e-5, 1e-5), (H, BF16_ULP, 1e-6)):
        dt = str(x.dtype).removeprefix("torch.")
        want = message_plain(x, *graph)
        tiled = message(x, *graph, bmg.tile_ptr)
        check(f"message[{dt},tiles]", tiled, want, rtol, atol, errs)
        check(f"message[{dt}]", message(x, *graph), want, rtol, atol, errs)
        if not torch.equal(tiled, message(x, *graph)):
            fail(f"message[{dt}]: the forms with and without tiles differ")
        if not torch.equal(tiled, message(x, *graph, bmg.tile_ptr)):
            fail(f"message[{dt}]: two calls differ")
        if tiled[pad_rows].any():
            fail(f"message[{dt}]: a padding row is not zero")
    # the library yardstick computes the same function, (S - R) H, in f32
    check("message[sparse.mm]", torch.sparse.mm(SR, H32), message_plain(H32, *graph), 1e-5,
          1e-5, errs)
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
    gb, yb, accb = g32.to(torch.bfloat16), y32.to(torch.bfloat16), acc32.to(torch.bfloat16)
    g_nodes = torch.randn((n_v, d), generator=g, device=dev).to(torch.bfloat16)
    g_nodes[-1] = 0  # the sacrificial node's cotangent
    Mg = torch.randn((bmg.n_graphs + 1, d), generator=g, device=dev).to(torch.bfloat16)

    def zeros_on_padding(tag, *tables):
        if any(t[pad_rows].any() for t in tables):
            fail(f"{tag}: a padding row is not zero")

    # F over the batch's tile table. f32: only the summation order differs;
    # bf16: f32 sums rounded once, so a sum taken in another order may round
    # to the neighbouring bf16 value. The node-warp form of message_bwd.cu (a
    # batch without a table) sums the same values in the same order: the same
    # bits on every row, and a second call the same bits again. Beside the
    # masked forms, the message's own backward (no mask, no gz)
    for tag, gg, yy, acc, rtol, atol in (
        ("float32,acc=False", g32, y32, None, 1e-5, 1e-5),
        ("float32,acc=True", g32, y32, acc32, 1e-5, 1e-5),
        ("bfloat16,acc=False", gb, yb, None, BF16_ULP, 1e-6),
        ("bfloat16,acc=True", gb, yb, accb, BF16_ULP, 1e-6),
    ):
        G, gz = bwd_message(gg, yy, *graph, gz_acc=acc, tiles=bmg.tile_ptr)
        want_G, want_gz = bwd_message_plain(gg, yy, *graph, gz_acc=acc)
        check(f"bwd_message[{tag},G]", G, want_G, rtol, atol, errs)
        check(f"bwd_message[{tag},gz]", gz, want_gz, rtol, atol, errs)
        zeros_on_padding(f"bwd_message[{tag}]", G, gz)
        node_warp = bwd_message(gg, yy, *graph, gz_acc=acc)
        if not (torch.equal(G, node_warp[0]) and torch.equal(gz, node_warp[1])):
            fail(f"bwd_message[{tag}]: the tiled and the node-warp form differ")
        again = bwd_message(gg, yy, *graph, gz_acc=acc, tiles=bmg.tile_ptr)
        if not (torch.equal(G, again[0]) and torch.equal(gz, again[1])):
            fail(f"bwd_message[{tag}]: two calls differ")
        if tag == "float32,acc=False":
            want_G32 = want_G
    for tag, gg, rtol, atol in (("float32", g32, 1e-5, 1e-5), ("bfloat16", gb, BF16_ULP, 1e-6)):
        G = transposed(gg, None, None, graph, bmg.tile_ptr, with_gz=False)[0]
        check(f"bwd_message[{tag},unmasked,G]", G, bwd_message_plain(gg, None, *graph)[0], rtol,
              atol, errs)
        zeros_on_padding(f"bwd_message[{tag},unmasked]", G)
        if not torch.equal(G, transposed(gg, None, None, graph, None, with_gz=False)[0]):
            fail(f"bwd_message[{tag},unmasked]: the tiled and the node-warp form differ")
    # F's library yardstick: the sparse product of (S - R)^T, in CSR form,
    # with the masked cotangent computes G in one call (f32, summation order)
    SRt = SR.to_sparse_coo().t().coalesce().to_sparse_csr()
    gz32m = g32 * (y32 > 0)
    check("bwd_message[sparse_yardstick,G]", torch.sparse.mm(SRt, gz32m), want_G32, 1e-5, 1e-5,
          errs)
    # G: the same sums from the node table; gz is a masked copy, so exact.
    # With the tile table it is one launch of the tile kernel; without one
    # (a molecule larger than a tile) the node-warp kernel: the same bits
    want_G, want_gz = bwd_message_nodes_plain(g_nodes, yb, *graph)
    outs = {}
    for tiles in (bmg.tile_ptr, None):
        tag = f"bwd_message_nodes[tiles={tiles is not None}"
        G, gz = outs[tiles is not None] = bwd_message_nodes(g_nodes, yb, *graph, tiles=tiles)
        check(f"{tag},G]", G, want_G, BF16_ULP, 1e-6, errs)
        check(f"{tag},gz]", gz, want_gz, 0.0, 0.0, errs)
        zeros_on_padding(f"{tag}]", G, gz)
    if not all(torch.equal(a, b) for a, b in zip(outs[True], outs[False])):
        fail("bwd_message_nodes: the forms with and without tiles differ")
    again = bwd_message_nodes(g_nodes, yb, *graph, tiles=bmg.tile_ptr)
    if not all(torch.equal(a, b) for a, b in zip(again, outs[True])):
        fail("bwd_message_nodes: two calls differ")
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
        again = fused_iter2(H0, W, bias, *graph, bmg.tile_ptr)
        if not (torch.equal(again[0], y1) and torch.equal(again[1], y2)):
            fail(f"{tag}]: two calls differ")
    H0z = H0.masked_fill(pad_rows[:, None], 0)  # as W_i leaves them without a bias
    zeros_on_padding("fused_iter2", *fused_iter2(H0z, W, None, *graph, bmg.tile_ptr))
    # E: gz is a masked copy, so exact. G equals bwd_message's, whose sums may
    # round to the neighbouring bf16 value against the plain version's order;
    # dH = G W^T carries that and rounds once more, dW = H^T G sums E products
    # in f32 in another order: both limits scale with the sum of |terms|.
    # With the tile table it is one launch over the molecule tiles (and the
    # ordered sum of its clusters' dW); without one (a molecule larger than a
    # tile) three launches: the same gz, and dH and dW in another order
    Hx = H.clamp_min(0)  # an iteration's input: a ReLU output, padding rows not zero
    want_dH, want_gz, want_dW = iter_bwd_plain(gb, yb, Hx, W, *graph)
    G_abs = bwd_message_plain(gb, yb, *graph)[0].float().abs()
    Hx_abs = Hx.float().masked_fill(pad_rows[:, None], 0)
    outs = {}
    for tiles in (bmg.tile_ptr, None):
        tag = f"iter_bwd[tiles={tiles is not None}"
        dH, gz, dW = outs[tiles is not None] = iter_bwd(gb, yb, Hx, W, *graph, tiles=tiles)
        check(f"{tag},gz]", gz, want_gz, 0.0, 0.0, errs)
        check(f"{tag},dH]", dH, want_dH, 2 * BF16_ULP, 1e-4, errs, G_abs @ W.float().abs().t())
        check(f"{tag},dW]", dW, want_dW, 1e-4, 1e-3, errs, Hx_abs.t() @ G_abs)
        zeros_on_padding(f"{tag}]", dH, gz)
        again = iter_bwd(gb, yb, Hx, W, *graph, tiles=tiles)
        if not all(torch.equal(a, w) for a, w in zip(again, (dH, gz, dW))):
            fail(f"{tag}]: two runs differ")
    if not torch.equal(outs[True][1], outs[False][1]):
        fail("iter_bwd: gz of the forms with and without tiles differ")
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
    tensors = dict(H32=H32, H=H, H0=H0, W=W, Hv=Hv, SR=SR, SRt=SRt, g32=g32, y32=y32,
                   acc32=acc32, accb=accb, gz32m=gz32m, gb=gb, yb=yb, g_nodes=g_nodes, Mg=Mg,
                   Hx=Hx, Gt=Gt, Xi=Xi)
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


def overfit(ds, name: str, dt, options: dict) -> tuple[dict, dict]:
    """The reference's overfit run through ``Trainer.fit`` and
    ``Trainer.predict`` on cuda: 50 epochs over the 100 rows of mol.csv in
    unshuffled batches of 32, held to the bar with batch statistics and with
    the running ones, and to the path's kernels (``train_<name>``)."""
    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.ops import LAUNCHES
    from chemprop_tpu_torch.train import Trainer

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
    launches = dict(LAUNCHES)
    losses = [h["train_loss"] for h in trainer.history]
    res = {"epochs": len(losses), "steps": trainer.state.step, "fit_s": fit_s,
           "first_loss": losses[0], "last_loss": losses[-1],
           "train_mse_batch_statistics": mse_batch, "limit_batch_statistics":
           OVERFIT_BATCH_STATS_MSE, "train_mse_running_statistics": mse_running,
           "limit_running_statistics": OVERFIT_RUNNING_STATS_MSE, "launches": launches}
    print(json.dumps({"train_path": {name: res}}))
    if not all(map(math.isfinite, losses)):
        fail(f"{name} training: a loss is not finite")
    if mse_batch > OVERFIT_BATCH_STATS_MSE:
        fail(f"{name} overfit MSE {mse_batch} > {OVERFIT_BATCH_STATS_MSE} (batch statistics)")
    if mse_running > OVERFIT_RUNNING_STATS_MSE:
        fail(f"{name} overfit MSE {mse_running} > {OVERFIT_RUNNING_STATS_MSE} "
             "(running statistics)")
    check_path_launches(f"train_{name}", launches, exact=False)
    return launches, res


def train_path(ds) -> tuple[dict, dict]:
    """Phase 4a: the reference's overfit run in float32, in bfloat16, and in
    bfloat16 with the ``iter2`` and ``grad_w`` options on."""
    import torch

    launches, res = {}, {}
    for name, dt, options in (("float32", torch.float32, {}), ("bfloat16", torch.bfloat16, {}),
                              ("bfloat16_iter2_grad_w", torch.bfloat16,
                               dict(iter2=True, grad_w=True))):
        launches[f"train_{name}"], res[name] = overfit(ds, name, dt, options)
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


def step_against_cpu(ds, tag: str = "train_step_cuda_vs_cpu", mp_kwargs: dict | None = None,
                     path: str = "train_float32", **options) -> dict:
    """Phase 4b: one float32 training step on the card against the same step
    on the CPU, from the same state (the same seed) on the same batch; with
    ``mp_kwargs`` and ``options`` another model or route (phase 6). The
    card's step launches ``path``'s kernels, each as often as one step does."""
    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.ops import LAUNCHES
    from chemprop_tpu_torch.train import Trainer

    batch = next(iter(DataLoader(ds, batch_size=32)))
    states, losses = {}, {}
    for device in ("cpu", None):
        trainer = Trainer(default_model(torch.float32, mp_kwargs=mp_kwargs, **options),
                          max_epochs=50, warmup_epochs=2, seed=12, device=device)
        trainer.init_state(batch, 4)
        LAUNCHES.clear()
        losses[device] = float(trainer.train_step(batch))
        states[device] = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    launches = dict(LAUNCHES)
    check_path_launches(path, launches, exact=True)
    return {**compare_steps(states, losses, tag), "launches": launches}


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


def descriptor_datasets():
    """Phase 6: the 100 rows of mol.csv with their molecule descriptors (1
    each), atom descriptors (3 per atom), atom features (3) and bond features
    (2), from the repo's .npz files. The training set's targets and extra
    inputs are normalised (the scalers returned); the evaluation set keeps the
    raw inputs, which the model's transforms scale at evaluation, and the
    normalised targets."""
    import numpy as np

    from chemprop_tpu_torch.data import MoleculeDatapoint, MoleculeDataset
    from chemprop_tpu_torch.featurizers.molgraph import SimpleMoleculeMolGraphFeaturizer

    with open(MOL_CSV, newline="") as f:
        rows = list(csv.reader(f))[1:]

    def arrays(name):
        z = np.load(MOL_DIR / f"{name}.npz")
        return [z[f"arr_{i}"] for i in range(len(z.files))]

    x_d = np.load(MOL_DIR / "descriptors.npz")["arr_0"]
    V_d, V_f, E_f = arrays("atom_descriptors"), arrays("atom_features"), arrays("bond_features")
    dps = [MoleculeDatapoint.from_smi(s, y=np.array([float(y)]), x_d=x_d[i], V_d=V_d[i],
                                      V_f=V_f[i], E_f=E_f[i]) for i, (s, y) in enumerate(rows)]
    out = []
    for normalise in (True, False):
        ds = MoleculeDataset(dps, featurizer=SimpleMoleculeMolGraphFeaturizer(
            extra_atom_fdim=3, extra_bond_fdim=2))
        ds.normalize_targets()
        if normalise:
            scalers = {key: ds.normalize_inputs(key) for key in ("X_d", "V_f", "E_f", "V_d")}
        ds.cache = True
        out.append(ds)
    return out[0], out[1], scalers


def descriptor_model(dtype, scalers: dict, dropout: float = 0.0, **options):
    """The default model at full width with atom descriptors (W_d: 303
    columns, padded to 384), molecule descriptors after the batch norm, and
    the extra atom and bond features, each with its scaling transform;
    ``options`` the opt-in kernels (the environment is not read)."""
    from chemprop_tpu_torch.models import MPNN
    from chemprop_tpu_torch.nn import (
        BondMessagePassing, GraphTransform, MeanAggregation, RegressionFFN, ScaleTransform,
    )
    from chemprop_tpu_torch.ops import KernelOptions

    def scale(key, pad=0):
        return ScaleTransform.from_standard_scaler(scalers[key], pad=pad)

    mp = BondMessagePassing(d_v=75, d_e=16, compute_dtype=dtype, dropout=dropout, d_vd=3,
                            kernel_options=KernelOptions(**options), V_d_transform=scale("V_d"),
                            graph_transform=GraphTransform(scale("V_f", 72), scale("E_f", 14)))
    return MPNN(mp, MeanAggregation(), RegressionFFN(input_dim=304, output_transform=False,
                                                     dropout=dropout),
                batch_norm=True, X_d_transform=scale("X_d"))


def predict_loaded(model, loader):
    """Inference-space predictions of a loaded model over ``loader``, real
    rows in order (what ``Trainer.predict`` computes)."""
    import numpy as np
    import torch

    chunks = []
    with torch.inference_mode():
        for host in loader:
            b = host.to("cuda")
            chunks.append(model(b.bmg, b.V_d, b.X_d).float().cpu().numpy()[host.pad_mask])
    return np.concatenate(chunks)


def extras_fit(train, raw, scalers, ckpt_dir: Path) -> tuple[dict, dict]:
    """Phase 6(a): the descriptor model in bf16 for 30 epochs with validation
    metrics, ``monitor`` on val_rmse, ``patience`` and ``checkpoint_dir``;
    ``best.ckpt`` and ``last.ckpt`` reloaded through ``load_model``, the
    best one's predictions held to ``Trainer.predict``'s bit for bit."""
    import numpy as np
    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.models import load_model
    from chemprop_tpu_torch.nn.metrics import MAE, RMSE, R2Score
    from chemprop_tpu_torch.ops import LAUNCHES
    from chemprop_tpu_torch.train import Trainer

    LAUNCHES.clear()
    trainer = Trainer(descriptor_model(torch.bfloat16, scalers), max_epochs=30, warmup_epochs=2,
                      seed=12, val_metrics={"mae": MAE(), "rmse": RMSE(), "r2": R2Score()},
                      monitor="val_rmse", patience=10, checkpoint_dir=ckpt_dir)
    val = DataLoader(raw, batch_size=32)
    trainer.fit(DataLoader(train, batch_size=32), val)
    preds = trainer.predict(val)
    launches = dict(LAUNCHES)
    check_path_launches("train_descriptors_bfloat16", launches, exact=False)
    hist = trainer.history
    best_rmse = min(h["val_rmse"] for h in hist)
    res = {"epochs": len(hist), "first_loss": hist[0]["train_loss"],
           "last_loss": hist[-1]["train_loss"], "limit_last_loss": DESCRIPTOR_TRAIN_LOSS,
           "best_epoch": trainer.best_epoch, "best_val_rmse": best_rmse,
           "limit_val_rmse": DESCRIPTOR_VAL_RMSE,
           "last_record": {k: v for k, v in hist[-1].items() if k != "time_s"},
           "launches": launches}
    metrics_ok = all(math.isfinite(h[f"val_{k}"]) for h in hist for k in ("mae", "rmse", "r2"))
    files = {tag: (ckpt_dir / f"{tag}.ckpt").exists() for tag in ("best", "last")}
    if all(files.values()):
        best_model, _ = load_model(ckpt_dir / "best.ckpt")
        last_model, _ = load_model(ckpt_dir / "last.ckpt")
        res["best_ckpt_equals_predict"] = bool(np.array_equal(predict_loaded(best_model, val),
                                                              preds))
        res["last_ckpt_finite"] = bool(np.isfinite(predict_loaded(last_model, val)).all())
    print(json.dumps({"descriptors_fit": res}))
    if not metrics_ok:
        fail("the descriptor fit recorded a non-finite validation metric")
    if hist[-1]["train_loss"] > DESCRIPTOR_TRAIN_LOSS or best_rmse > DESCRIPTOR_VAL_RMSE:
        fail(f"the descriptor fit reached train loss {hist[-1]['train_loss']} (bar "
             f"{DESCRIPTOR_TRAIN_LOSS}) and val_rmse {best_rmse} (bar {DESCRIPTOR_VAL_RMSE})")
    if not all(files.values()):
        fail(f"checkpoint_dir holds {files}")
    if not res["best_ckpt_equals_predict"] or not res["last_ckpt_finite"]:
        fail("best.ckpt does not predict what Trainer.predict does, or last.ckpt does not load")
    return launches, res


def extras_resume(train, scalers, ckpt_dir: Path) -> tuple[dict, dict]:
    """Phase 6(b): the descriptor model with dropout 0.1 in bf16, six epochs
    straight against three, ``last.ckpt``, ``resume_from`` and three more;
    the loss histories and the predictions must be equal bit for bit (the
    kernels give the same bits in two calls, and the file holds the dropout
    generator's state)."""
    import numpy as np
    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.ops import LAUNCHES
    from chemprop_tpu_torch.train import Trainer

    def trainer(**kw):
        return Trainer(descriptor_model(torch.bfloat16, scalers, dropout=0.1), max_epochs=6,
                       warmup_epochs=2, seed=12, **kw)

    LAUNCHES.clear()
    full = trainer()
    full.fit(DataLoader(train, batch_size=32, shuffle=True, seed=3))
    launches = dict(LAUNCHES)
    check_path_launches("train_descriptors_dropout_bfloat16", launches, exact=False)
    loader = DataLoader(train, batch_size=32, shuffle=True, seed=3)
    first = trainer(checkpoint_dir=ckpt_dir)
    first.init_state(None, len(loader))
    first.max_epochs = 3  # init_state fixed the schedule for six epochs
    first.fit(loader)
    resumed = trainer()
    resumed.start_epoch = resumed.resume_from(ckpt_dir / "last.ckpt", None, len(loader))
    resumed.fit(loader)  # the interrupted run's loader: its epochs' order goes on
    eval_loader = DataLoader(train, batch_size=32)
    preds = []
    for t in (full, resumed):
        t.best_variables = None  # the last state
        preds.append(t.predict(eval_loader))
    straight = [h["train_loss"] for h in full.history]
    pieced = [h["train_loss"] for h in first.history + resumed.history]
    res = {"start_epoch": resumed.start_epoch, "straight": straight, "resumed": pieced,
           "losses_equal": straight == pieced,
           "predictions_equal": bool(np.array_equal(*preds)), "launches": launches}
    print(json.dumps({"resume": res}))
    if resumed.start_epoch != 3 or not res["losses_equal"] or not res["predictions_equal"]:
        fail("resuming from last.ckpt did not continue the fit bit for bit")
    return launches, res


def extras_freeze(ds) -> dict:
    """Phase 6(c): ``freeze`` on message passing's JAX paths: its tensors are
    bit-equal before and after a bf16 fit, the head's move."""
    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.train import Trainer

    loader = DataLoader(ds, batch_size=32)
    trainer = Trainer(default_model(torch.bfloat16), max_epochs=3, warmup_epochs=1, seed=12,
                      grad_clip=1.0, freeze=lambda path: path.startswith("message_passing"))
    trainer.init_state(None, len(loader))
    before = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    trainer.fit(loader)
    after = trainer.state.params
    frozen = [k for k in before if k.startswith("message_passing")]
    res = {"frozen_tensors": len(frozen),
           "frozen_equal": all(torch.equal(before[k], after[k]) for k in frozen),
           "head_moved": all(not torch.equal(before[k], after[k]) for k in before
                             if k.startswith("predictor"))}
    print(json.dumps({"freeze": res}))
    if not frozen or not res["frozen_equal"] or not res["head_moved"]:
        fail(f"freeze: {res}")
    return res


def depth_loop_gz_acc(ds) -> dict:
    """Phase 6(d): one bf16 step of the depth loop on the card, each F launch
    recorded with whether it carried the running dH0 (``gz_acc``)."""
    import importlib

    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.ops import LAUNCHES
    from chemprop_tpu_torch.train import Trainer

    # the module (the package exports its function of the same name)
    message_ops = importlib.import_module("chemprop_tpu_torch.ops.message")
    real, calls = message_ops.bwd_message, []

    def spy(*args, gz_acc=None, **kwargs):
        calls.append(gz_acc is not None)
        return real(*args, gz_acc=gz_acc, **kwargs)

    batch = next(iter(DataLoader(ds, batch_size=32)))
    trainer = Trainer(default_model(torch.bfloat16, depth_loop=True), seed=12)
    trainer.init_state(batch, 4)
    message_ops.bwd_message = spy
    try:
        LAUNCHES.clear()
        trainer.train_step(batch)
    finally:
        message_ops.bwd_message = real
    res = {"bwd_message_calls_with_gz_acc": calls, "launches": dict(LAUNCHES)}
    print(json.dumps({"depth_loop_step": res}))
    if calls != [False, True] or res["launches"].get("bwd_message") != 2:
        fail(f"the depth loop's backward did not carry dH0 in F: {res}")
    return res


def window_gather_forward(bmg, desc, scalers: dict) -> tuple[dict, dict]:
    """Phase 6(e): the bf16 forward with ``window_gather`` on and off, bit
    for bit, with I's forward launch counted and nothing refused: the default
    model on the benchmark batch, and the descriptor model (75-column node
    rows, padded to the kernel's 16-byte chunks) on ``desc``, a batch of its
    evaluation set."""
    import torch

    from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED
    from chemprop_tpu_torch.train import Trainer

    refused = UNSERVED["row_gather"]
    launches, res = {}, {}
    cases = {"predict_bfloat16_window_gather": (
                 lambda on: default_model(torch.bfloat16, window_gather=on), (bmg,)),
             "predict_descriptors_bfloat16_window_gather": (
                 lambda on: descriptor_model(torch.bfloat16, scalers, window_gather=on),
                 (desc.bmg, desc.V_d, desc.X_d))}
    for path, (make, inputs) in cases.items():
        outs = []
        for on in (False, True):
            trainer = Trainer(make(on), seed=12)
            trainer.init_state(None, 1)
            LAUNCHES.clear()
            with torch.inference_mode():
                outs.append(trainer.model.fingerprint(*inputs))
            if on:
                launches[path] = dict(LAUNCHES)
        res[path] = {"equal": bool(torch.equal(*outs)), "launches": launches[path]}
    res["unserved"] = UNSERVED["row_gather"] - refused
    print(json.dumps({"window_gather": res}))
    for path in cases:
        check_path_launches(path, launches[path], exact=True)
    if not all(res[path]["equal"] for path in cases) or res["unserved"]:
        fail(f"window_gather: {res}")
    return launches, res


def taps_against_cpu(ds) -> dict:
    """Phase 6(g): the f32 activation taps (H_0, each iteration's H, M_v) on the
    card against the CPU's, real rows, at the f32 limits of phase 3."""
    import copy

    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.train import Trainer

    batch = next(iter(DataLoader(ds, batch_size=32)))
    trainer = Trainer(default_model(torch.float32), seed=12)
    trainer.init_state(None, 1)
    taps = {}
    with torch.inference_mode():
        for dev, model in (("cuda", trainer.model), ("cpu", copy.deepcopy(trainer.model).cpu())):
            taps[dev] = {}
            model.fingerprint(batch.bmg.to(dev), taps=taps[dev])
    res, ok = {}, set(taps["cuda"]) == set(taps["cpu"]) == {"H_0", "H", "M_v"}
    for name, values in taps["cpu"].items():
        rows = batch.bmg.node_mask if name == "M_v" else batch.bmg.edge_mask
        for i, want in enumerate(values):
            got = taps["cuda"][name][i].cpu()
            res[f"{name}[{i}]"] = float((got - want)[rows].abs().max())
            ok &= bool(torch.allclose(got[rows], want[rows], rtol=1e-5, atol=1e-4))
    print(json.dumps({"taps_cuda_vs_cpu": res}))
    if not ok or len(taps["cpu"]["H"]) != 2:
        fail(f"the f32 taps on cuda disagree with the CPU's: {res}")
    return res


def extras_phase(ds, bmg, out_dir: Path) -> tuple[dict, dict]:
    """Phase 6: descriptors, validation metrics, checkpoints, resume, freeze,
    the depth loop, the window gather, an activation argument and the taps."""
    import shutil

    import torch

    from chemprop_tpu_torch.data import DataLoader

    t0 = time.time()
    ckpt = out_dir / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    train, raw, scalers = descriptor_datasets()
    launches, res = {}, {}
    launches["train_descriptors_bfloat16"], res["descriptors"] = extras_fit(
        train, raw, scalers, ckpt / "fit")
    launches["train_descriptors_dropout_bfloat16"], res["resume"] = extras_resume(
        train, scalers, ckpt / "resume")
    res["freeze"] = extras_freeze(ds)
    res["depth_loop_float32_step"] = step_against_cpu(
        ds, "train_depth_loop_step_cuda_vs_cpu", path="train_float32_depth_loop", depth_loop=True)
    for name, options in (("bfloat16_depth_loop", dict(depth_loop=True)),
                          ("bfloat16_depth_loop_grad_w", dict(depth_loop=True, grad_w=True))):
        launches[f"train_{name}"], res[name] = overfit(ds, name, torch.bfloat16, options)
    res["depth_loop_step"] = depth_loop_gz_acc(ds)
    desc = next(iter(DataLoader(raw, batch_size=32))).to("cuda")
    wg_launches, res["window_gather"] = window_gather_forward(bmg, desc, scalers)
    launches.update(wg_launches)
    res["leakyrelu_float32_step"] = step_against_cpu(
        ds, "train_leakyrelu_step_cuda_vs_cpu", mp_kwargs=dict(activation="leakyrelu:0.1"),
        path="train_float32_leakyrelu")
    res["taps"] = taps_against_cpu(ds)
    res["seconds"] = time.time() - t0
    print(json.dumps({"phase": "extras", "seconds": res["seconds"]}))
    return launches, res


def check_split_tables(d: int, seed: int, errs: dict) -> dict:
    """Phase 2, G and H on a split tile table: Tox21's 500 molecules
    (classification/mol.csv, 8 of them of more than 128 directed edges) in one
    batch, which has no tile table; its split table cuts those molecules at
    their nodes' boundaries, and ``cross_rows`` lists the rows that read
    another tile. G and H (``fold_h0`` on and off) with the split table must
    give the bits of their forms without a table on every row, in two calls,
    and hold against their plain versions at the limits of the tiled
    check."""
    import torch

    from chemprop_tpu_torch.chem import make_mol
    from chemprop_tpu_torch.data.collate import batch_mol_graphs
    from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer
    from chemprop_tpu_torch.ops import bwd_message_nodes, bwd_message_premul
    from chemprop_tpu_torch.ops.message import (
        bwd_message_nodes_plain, bwd_message_premul_plain,
    )

    feat = SimpleMoleculeMolGraphFeaturizer()
    rows = read_targets(REPO / "tests/data/classification/mol.csv")
    b = batch_mol_graphs([feat(make_mol(smi)) for smi, *_ in rows]).to("cuda")
    if b.tile_ptr is not None or b.split_ptr is None or not b.cross_rows.numel():
        fail("the Tox21 batch should have a split table with cross rows and no tile table")
    graph = (b.src, b.dst, b.rev, b.edge_ptr)
    n_e, n_v = b.E.shape[0], b.V.shape[0]
    pad_rows = b.dst == n_v - 1
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    yb = torch.randn((n_e, d), generator=g, device="cuda").to(torch.bfloat16)
    gb = torch.randn((n_e, d), generator=g, device="cuda").to(torch.bfloat16)
    H0 = torch.randn((n_e, d), generator=g, device="cuda").to(torch.bfloat16)
    W = (torch.randn((d, d), generator=g, device="cuda") * d**-0.5).to(torch.bfloat16)
    g_nodes = torch.randn((n_v, d), generator=g, device="cuda").to(torch.bfloat16)
    g_nodes[-1] = 0
    split = {"tiles": b.split_ptr, "cross": b.cross_rows}

    def same(tag, got, want):
        if not all(torch.equal(x, w) for x, w in zip(got, want)):
            fail(f"{tag}: the split table's bits differ from the form without a table")
        if any(t[pad_rows].any() for t in got):
            fail(f"{tag}: a padding row is not zero")

    out = bwd_message_nodes(g_nodes, yb, *graph, **split)
    same("bwd_message_nodes[split]", out, bwd_message_nodes(g_nodes, yb, *graph))
    same("bwd_message_nodes[split,again]", bwd_message_nodes(g_nodes, yb, *graph, **split), out)
    want_G, want_gz = bwd_message_nodes_plain(g_nodes, yb, *graph)
    check("bwd_message_nodes[split,G]", out[0], want_G, BF16_ULP, 1e-6, errs)
    check("bwd_message_nodes[split,gz]", out[1], want_gz, 0.0, 0.0, errs)
    for fold in (True, False):
        tag = f"bwd_message_premul[split,fold_h0={fold}"
        out = bwd_message_premul(gb, yb, H0, W, *graph, fold_h0=fold, **split)
        same(f"{tag}]", out, bwd_message_premul(gb, yb, H0, W, *graph, fold_h0=fold))
        same(f"{tag},again]", bwd_message_premul(gb, yb, H0, W, *graph, fold_h0=fold, **split),
             out)
        want_G, want_z = bwd_message_premul_plain(gb, yb, H0, W, *graph, fold_h0=fold)
        gz_abs = ((gb.float() @ W.float().t()) * (yb > 0)).abs()
        terms = torch.zeros((n_v, d), device="cuda").index_add_(0, b.dst.long(),
                                                                 gz_abs[b.rev.long()])
        check(f"{tag},G]", out[0], want_G, 2 * BF16_ULP, 1e-4, errs, terms[b.dst.long()])
        check(f"{tag},z]", out[1], want_z, 2 * BF16_ULP, 1e-4, errs)
    res = {"rows": n_e, "real_rows": int(b.edge_mask.sum()), "tiles": b.split_ptr.numel() - 1,
           "cross_rows": b.cross_rows.numel(), "d": d}
    print(json.dumps({"split_tables": res}))
    return res


def read_targets(path: Path, bounded: bool = False) -> list[tuple]:
    """``(smiles, y, lt, gt)`` of each row of a CSV whose first column is the
    SMILES: an empty target is NaN; with ``bounded``, ``<x`` and ``>x`` set
    the row's lt and gt masks."""
    import numpy as np

    out = []
    with open(path, newline="") as f:
        for row in list(csv.reader(f))[1:]:
            cells = [v.strip() for v in row[1:]]
            lt = np.array([bounded and v.startswith("<") for v in cells])
            gt = np.array([bounded and v.startswith(">") for v in cells])
            y = np.array([float(v.lstrip("<>=")) if v else np.nan for v in cells])
            out.append((row[0], y, lt, gt))
    return out


def head_dataset(rows, normalize_with=None, bounded: bool = False):
    """A dataset of ``rows``; regression targets normalised with the scaler
    given (``True``: its own)."""
    from chemprop_tpu_torch.data import MoleculeDatapoint, MoleculeDataset

    ds = MoleculeDataset([MoleculeDatapoint.from_smi(
        s, y=y, lt_mask=lt if bounded else None, gt_mask=gt if bounded else None)
        for s, y, lt, gt in rows])
    scaler = None
    if normalize_with is not None:
        scaler = ds.normalize_targets(None if normalize_with is True else normalize_with)
    ds.cache = True
    return ds, scaler


def head_model(dtype, head: str, **kwargs):
    """The default model at full width (hidden width 300, depth 3, batch
    norm) with the head ``head`` of ``nn.predictors``."""
    from chemprop_tpu_torch.models import MPNN
    from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, predictors
    from chemprop_tpu_torch.ops import KernelOptions

    cls = getattr(predictors, head)
    if issubclass(cls, predictors.RegressionFFN):
        kwargs.setdefault("output_transform", False)
    return MPNN(BondMessagePassing(compute_dtype=dtype, kernel_options=KernelOptions()),
                MeanAggregation(), cls(**kwargs), batch_norm=True)


def head_fit_data(name: str) -> tuple:
    """Phase 8(b)'s fits: (train, val, head, head arguments, validation
    metrics). BCE on classification/mol.csv (four tasks with missing labels),
    CE on mol_multiclass.csv, MVE on mol.csv; the last rows validate."""
    from chemprop_tpu_torch.nn import metrics

    data = REPO / "tests/data"
    if name == "bce":
        rows = read_targets(data / "classification/mol.csv")
        return (*[head_dataset(part)[0] for part in (rows[:400], rows[400:])],
                "BinaryClassificationFFN", {"n_tasks": 4},
                {"roc": metrics.BinaryAUROC(), "prc": metrics.BinaryAUPRC()})
    if name == "ce":
        rows = read_targets(data / "classification/mol_multiclass.csv")
        return (*[head_dataset(part)[0] for part in (rows[:400], rows[400:])],
                "MulticlassClassificationFFN", {"n_classes": 3},
                {"multiclass-mcc": metrics.MulticlassMCCMetric(n_classes=3)})
    rows = read_targets(MOL_CSV)
    train, scaler = head_dataset(rows[:80], True)
    return (train, head_dataset(rows[80:], scaler)[0], "MveFFN", {}, {"rmse": metrics.RMSE()})


class CountUntiled:
    """A loader that counts the batches it yields, and those without a tile
    table (a molecule of more than ``ITER2_TILE_ROWS`` directed edges), whose
    steps give G and H the batch's split table."""

    def __init__(self, loader):
        self.loader, self.untiled, self.batches = loader, 0, 0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            self.untiled += batch.bmg.tile_ptr is None
            self.batches += 1
            yield batch


def head_fit(name: str, dtype, device=None) -> tuple[list, int, int]:
    """One of phase 8(b)'s fits: HEAD_FIT_EPOCHS epochs in shuffled batches of
    50 with a validation loader; its history, its training batches without a
    tile table and its training batches."""
    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.train import Trainer

    train, val, head, kwargs, val_metrics = head_fit_data(name)
    trainer = Trainer(head_model(dtype, head, **kwargs), max_epochs=HEAD_FIT_EPOCHS,
                      warmup_epochs=2, seed=12, val_metrics=val_metrics, device=device)
    loader = CountUntiled(DataLoader(train, batch_size=50, shuffle=True, seed=3))
    trainer.fit(loader, DataLoader(val, batch_size=50))
    return trainer.history, loader.untiled, loader.batches


def head_csv(path: Path):
    """(header, values, labels) of a predictions CSV: a multiclass head's
    class probabilities ``[n, t, c]`` and labels ``[n, t]``, any other head's
    point values ``[n, t]`` and no labels."""
    import numpy as np

    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    probs = [i for i, h in enumerate(header) if h.endswith("_prob")]
    if not probs:
        return header, np.array([[float(x) for x in r[1:]] for r in body]), None
    return (header, np.array([[[float(x) for x in r[i].split(",")] for i in probs] for r in body]),
            np.array([[int(r[i - 1]) for i in probs] for r in body]))


def serve_heads(out_dir: Path) -> tuple[dict, dict]:
    """Phase 8(a): ``cli predict`` of each of the seven checkpoints on the
    100 rows of mol.csv on cuda in f32 and bf16, against the CPU's in each
    dtype, at phase 3's limits; each run's launches counted on their own."""
    import numpy as np

    from chemprop_tpu_torch.cli.main import main
    from chemprop_tpu_torch.ops import LAUNCHES

    launches = {f"predict_heads_{dt}": {} for dt in ("float32", "bfloat16")}
    res = {}
    for ckpt in HEAD_CHECKPOINTS:
        out = {}
        for dt in ("float32", "bfloat16"):
            for device in (None, "cpu"):
                path = out_dir / f"{ckpt}.{dt}.{device or 'cuda'}.csv"
                argv = ["predict", "--model-path", str(REPO / "tests/data" / ckpt), "-i",
                        str(MOL_CSV), "-o", str(path), "--dtype", dt]
                LAUNCHES.clear()
                if main(argv + (["--device", device] if device else [])) != 0:
                    fail(f"predict {ckpt} --dtype {dt} returned non-zero")
                if device is None:
                    run = dict(LAUNCHES)
                    check_path_launches(f"predict_heads_{dt}", run, exact=False)
                    total = launches[f"predict_heads_{dt}"]
                    for k, v in run.items():
                        total[k] = total.get(k, 0) + v
                out[dt, device] = head_csv(path)
        header, f32, labels = out["float32", "cpu"]
        errs = {
            "f32_vs_cpu_f32": float(np.abs(out["float32", None][1] - f32).max()),
            "bf16_vs_cpu_bf16": float(np.abs(out["bfloat16", None][1]
                                             - out["bfloat16", "cpu"][1]).max()),
            "bf16_vs_cpu_f32": float(np.abs(out["bfloat16", None][1] - f32).max()),
        }
        res[ckpt] = {"header": header, "shape": list(f32.shape), **errs}
        if any(h != header or v.shape != f32.shape or not np.isfinite(v).all()
               for h, v, _ in out.values()) or len(f32) != 100:
            fail(f"predict {ckpt}: the runs' columns, shapes or values disagree: {res[ckpt]}")
        # phase 3's limits (f32: summation order; bf16: the odd rounding flip)
        if not np.allclose(out["float32", None][1], f32, rtol=1e-5, atol=1e-4):
            fail(f"{ckpt}: float32 predictions on cuda disagree with the CPU's")
        if not np.allclose(out["bfloat16", None][1], out["bfloat16", "cpu"][1], rtol=0, atol=1e-3):
            fail(f"{ckpt}: bfloat16 predictions on cuda disagree with the CPU's bfloat16 ones")
        if not np.allclose(out["bfloat16", None][1], f32, rtol=0.05, atol=0.1):
            fail(f"{ckpt}: bfloat16 predictions on cuda leave the float32 envelope")
        if labels is not None:
            # a class label may differ only where the CPU's two best classes
            # are closer than twice the dtype's limit
            top2 = np.sort(f32, axis=-1)[..., -2:]
            for (dt, device), (_, _, lab) in out.items():
                decided = top2[..., 1] - top2[..., 0] > (2e-4 if dt == "float32" else 2e-3)
                if not np.array_equal(lab[decided], labels[decided]):
                    fail(f"{ckpt}: {dt} {device or 'cuda'} class labels disagree")
    print(json.dumps({"heads_serve": res, "launches": launches}))
    return launches, res


def heads_fits() -> tuple[dict, dict]:
    """Phase 8(b, d): the bf16 fits of BCE, CE and MVE at full width, each
    twice from one seed (loss histories equal bit for bit), below its bar,
    every validation metric and edge rate finite; the first fit's launches.
    Tox21's and the multiclass set's largest molecules (8 of 500 and 3 of
    499 have more than 128 directed edges) leave a shuffled batch without a
    tile table now and then: its step's G and H take its split table, so the
    fits must leave nothing in ``ops.UNSERVED``; such batches are counted on
    the host and reported."""
    import torch

    from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED

    launches, res = {}, {}
    for name in ("bce", "ce", "mve"):
        LAUNCHES.clear()
        before = dict(UNSERVED)
        t0 = time.time()
        first, untiled, batches = head_fit(name, torch.bfloat16)
        fit_s = time.time() - t0
        launches[f"train_heads_bfloat16_{name}"] = dict(LAUNCHES)
        again, untiled_again, batches_again = head_fit(name, torch.bfloat16)
        untiled, batches = untiled + untiled_again, batches + batches_again
        unserved = {k: v - before.get(k, 0) for k, v in UNSERVED.items() if v != before.get(k, 0)}
        if unserved:
            fail(f"the {name} fits left {unserved} unserved ({untiled} of their batches had "
                 "no tile table)")
        losses = [h["train_loss"] for h in first]
        val_keys = sorted(k for k in first[0] if k.startswith("val_"))
        rates = [h["edges_per_s"] for h in first]
        res[name] = {"fit_s": fit_s, "epochs": len(first), "first_loss": losses[0],
                     "last_loss": losses[-1], "bar": HEAD_FIT_BARS[name],
                     "last_val": {k: first[-1][k] for k in val_keys},
                     "edges_per_s_median": statistics.median(rates),
                     "repeated_fit_equal": [h["train_loss"] for h in again] == losses
                     and all(a[k] == b[k] for a, b in zip(first, again) for k in val_keys),
                     "split_table_batches_of_both_fits": untiled,
                     "batches_of_both_fits": batches,
                     "launches": launches[f"train_heads_bfloat16_{name}"]}
        print(json.dumps({"heads_fit": {name: res[name]}}))
        if not all(map(math.isfinite, losses)) or not losses[-1] < HEAD_FIT_BARS[name]:
            fail(f"the {name} fit's last loss {losses[-1]} is not below {HEAD_FIT_BARS[name]}")
        if not all(math.isfinite(h[k]) for h in first for k in val_keys) or len(val_keys) < 2:
            fail(f"the {name} fit recorded a validation metric that is not finite: {val_keys}")
        if not all(math.isfinite(r) and r > 0 for r in rates):
            fail(f"the {name} fit's edges_per_s is not positive and finite: {rates}")
        if not res[name]["repeated_fit_equal"]:
            fail(f"two {name} fits from one seed gave different histories")
        check_path_launches(f"train_heads_bfloat16_{name}", launches[f"train_heads_bfloat16_{name}"],
                            exact=False)
    return launches, res


def heads_steps() -> tuple[dict, dict]:
    """Phase 8(c): one float32 training step of six criteria on the card
    against the same step on the CPU (phase 4b's limits), each launching the
    f32 step's kernels once."""
    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.nn import metrics
    from chemprop_tpu_torch.ops import LAUNCHES
    from chemprop_tpu_torch.train import Trainer

    data = REPO / "tests/data"
    clf = head_dataset(read_targets(data / "classification/mol.csv")[:32])[0]
    multi = head_dataset(read_targets(data / "classification/mol_multiclass.csv")[:32])[0]
    reg = head_dataset(read_targets(MOL_CSV)[:32], True)[0]
    bounded = read_targets(data / "regression/bounded.csv", bounded=True)
    # ten "<", ten ">" and twelve plain targets
    bnd = head_dataset(bounded[40:60] + bounded[100:112], True, bounded=True)[0]
    cases = {
        "bce": (clf, "BinaryClassificationFFN", {"n_tasks": 4}),
        "ce": (multi, "MulticlassClassificationFFN", {"n_classes": 3}),
        "dirichlet": (clf, "BinaryDirichletFFN", {"n_tasks": 4}),
        "evidential": (reg, "EvidentialFFN", {}),
        "quantile": (reg, "QuantileFFN", {}),
        "bounded": (bnd, "RegressionFFN", {"criterion": metrics.BoundedMSE(task_weights=[1.0])}),
    }
    launches, res = {}, {}
    for name, (ds, head, kwargs) in cases.items():
        batch = next(iter(DataLoader(ds, batch_size=32)))
        states, losses = {}, {}
        for device in ("cpu", None):
            trainer = Trainer(head_model(torch.float32, head, **kwargs), max_epochs=50,
                              warmup_epochs=2, seed=12, device=device)
            trainer.init_state(batch, 4)
            LAUNCHES.clear()
            losses[device] = float(trainer.train_step(batch))
            states[device] = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
        path = f"train_heads_float32_{name}"
        launches[path] = dict(LAUNCHES)
        check_path_launches(path, launches[path], exact=True)
        res[name] = {**compare_steps(states, losses, f"heads_step_{name}"),
                     "launches": launches[path]}
    return launches, res


def heads_phase(out_dir: Path) -> tuple[dict, dict]:
    """Phase 8: the task heads (serving, bf16 fits, f32 steps)."""
    t0 = time.time()
    (out_dir / "chip_smoke_heads").mkdir(parents=True, exist_ok=True)
    launches, res = {}, {}
    serve_launches, res["serve"] = serve_heads(out_dir / "chip_smoke_heads")
    fit_launches, res["fits"] = heads_fits()
    step_launches, res["steps"] = heads_steps()
    for part in (serve_launches, fit_launches, step_launches):
        launches.update(part)
    res["seconds"] = time.time() - t0
    print(json.dumps({"phase": "heads", "seconds": res["seconds"]}))
    return launches, res


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
    """Phase 7: kernel, plain and library times with the least time the card
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

    # A over the batch's tile table (message_bytes): bf16 as the composed path
    # of a non-ReLU or undirected model calls it, f32 as the f32 model's
    # iterations do. Beside it message.cu's form (a batch without a table)
    # and the one library call that computes the same function: the sparse
    # product of S - R, in CSR form, with H
    def message_times(x):
        b_ms, b_by = bound(message_bytes(bmg, d, x.element_size()), adds, f32_peak)
        ms = time_ms(lambda: message(x, *graph, bmg.tile_ptr), reps)
        try:  # the matrix is made once, outside the timed calls
            SR = t["SR"].to(x.dtype)
            library_ms = time_ms(lambda: torch.sparse.mm(SR, x), reps)
        except RuntimeError as e:  # the yardstick only: the card's PyTorch may refuse bf16
            library_ms = f"torch.sparse.mm refused {x.dtype}: {e}".splitlines()[0]
        return dict(
            ms=ms, plain_ms=time_ms(lambda: message_plain(x, *graph), reps),
            library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
            shape=[n_e, d], dtype=str(x.dtype).removeprefix("torch."),
            without_tiles=dict(ms=time_ms(lambda: message(x, *graph), reps)),
        )

    out["message"] = message_times(t["H"])
    out["message"]["float32"] = message_times(t["H32"])
    out["message"]["library"] = "torch.sparse.mm(S - R in CSR, H)"
    # fused iteration, bf16: H and H0 read, y written, W read once; the
    # message adds and the product of the real rows' messages with W. No one
    # library call computes it; beside it the unfused route: kernel A's bf16
    # message over the tile table, a library product, then the residual and
    # the ReLU
    b_ms, b_by = bound(3 * n_e * d * 2 + d * d * 2 + ids_bytes, 2 * n_real * d * d, bf16_peak)
    out["fused_iter"] = dict(
        ms=time_ms(lambda: fused_iter(t["H"], t["H0"], t["W"], None, *graph), reps),
        plain_ms=time_ms(lambda: fused_iter_plain(t["H"], t["H0"], t["W"], None, *graph), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="bfloat16",
        composed_ms=time_ms(lambda: torch.relu(
            t["H0"] + torch.mm(message(t["H"], *graph, bmg.tile_ptr), t["W"])), reps),
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
    # F over the batch's tile table (bwd_message_bytes): f32 as in the float32
    # training step, bf16 as in the bf16 dropout step, and each with gz_acc
    # as the depth loop's (and the f32 chain's) second call; per real row and
    # element an add into the node's sum, a subtraction and a mask (and the
    # add of gz_acc). Beside it the node-warp form (a batch without a table)
    # and two library routes: the one call that forms G alone, the sparse
    # product of (S - R)^T in CSR with the masked cotangent (made outside the
    # timed call), and the two calls that form both outputs, the mask (with
    # gz_acc added) and then that product
    def f_times(gg, yy, acc):
        isz = gg.element_size()
        b_ms, b_by = bound(bwd_message_bytes(bmg, d, isz, acc is not None),
                           (3 + int(acc is not None)) * n_real * d, f32_peak)
        ms = time_ms(lambda: bwd_message(gg, yy, *graph, gz_acc=acc, tiles=bmg.tile_ptr), reps)
        res = dict(
            ms=ms, plain_ms=time_ms(lambda: bwd_message_plain(gg, yy, *graph, gz_acc=acc), reps),
            bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms, shape=[n_e, d],
            dtype=str(gg.dtype).removeprefix("torch."),
            without_tiles=dict(ms=time_ms(lambda: bwd_message(gg, yy, *graph, gz_acc=acc),
                                          reps)))
        gzm = gg * (yy > 0)
        try:  # the matrix is made once, outside the timed calls
            SRt = t["SRt"].to(gg.dtype)

            def two_calls():
                z = gg * (yy > 0)
                return torch.sparse.mm(SRt, z), z if acc is None else z + acc

            res["library_ms"] = time_ms(lambda: torch.sparse.mm(SRt, gzm), reps)
            res["library_two_call_ms"] = time_ms(two_calls, reps)
        except RuntimeError as e:  # the yardstick only: the card's PyTorch may refuse bf16
            res["library_ms"] = res["library_two_call_ms"] = (
                f"torch.sparse.mm refused {gg.dtype}: {e}".splitlines()[0])
        return res

    out["bwd_message"] = f_times(t["g32"], t["y32"], None)
    out["bwd_message"]["with_gz_acc"] = f_times(t["g32"], t["y32"], t["acc32"])
    out["bwd_message"]["bfloat16"] = f_times(t["gb"], t["yb"], None)
    out["bwd_message"]["bfloat16"]["with_gz_acc"] = f_times(t["gb"], t["yb"], t["accb"])
    out["bwd_message"]["library"] = "torch.sparse.mm((S - R)^T in CSR, g * [y > 0]): G alone"
    out["bwd_message"]["library_two_call"] = (
        "g * [y > 0] (+ gz_acc), then torch.sparse.mm((S - R)^T in CSR, .): G and gz")
    # G, bf16, over the batch's tile table (bwd_nodes_bytes). Beside it the
    # form without a table and the unfused route: the node table gathered at
    # dst by index_select, then F
    n_tiles = bmg.tile_ptr.numel() - 1
    b_ms, b_by = bound(bwd_nodes_bytes(bmg, d), 3 * n_real * d, f32_peak)
    dst64 = bmg.dst.long()
    out["bwd_message_nodes"] = dict(
        ms=time_ms(lambda: bwd_message_nodes(t["g_nodes"], t["yb"], *graph,
                                             tiles=bmg.tile_ptr), reps),
        plain_ms=time_ms(lambda: bwd_message_nodes_plain(t["g_nodes"], t["yb"], *graph), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="bfloat16",
        without_tiles=dict(ms=time_ms(lambda: bwd_message_nodes(t["g_nodes"], t["yb"], *graph),
                                      reps), bound_ms=b_ms),
        composed_ms=time_ms(lambda: bwd_message(torch.index_select(t["g_nodes"], 0, dst64),
                                                t["yb"], *graph, tiles=bmg.tile_ptr), reps),
    )
    out["bwd_message_nodes"]["share_of_bound"] = b_ms / out["bwd_message_nodes"]["ms"]
    # H with fold_h0, as at depth 3, over the batch's tile table: G_in, y and
    # H0 read, G and z written, W read once; the product of the real rows with
    # W^T on the tensor cores. Without fold_h0 (from depth 4) H0 is not read.
    # Beside it the form without a tile table and the unfused route: a library
    # product dh = G_in W^T, F's masked transposed message, then z in PyTorch
    f_ids = 4 * (n_e + n_v + 1)
    b_ms, b_by = bound(5 * n_e * d * 2 + d * d * 2 + f_ids, 2 * n_real * d * d, bf16_peak)
    b_nofold, _ = bound(4 * n_e * d * 2 + d * d * 2 + f_ids, 2 * n_real * d * d, bf16_peak)

    def premul(fn, fold, tiles=bmg.tile_ptr):
        return fn(t["gb"], t["yb"], t["H0"], t["W"], *graph, fold_h0=fold, tiles=tiles)

    def unfused_premul():
        dh = torch.mm(t["gb"], t["W"].t())
        G, gz = bwd_message(dh, t["yb"], *graph, tiles=bmg.tile_ptr)
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
    # D, bf16, over the batch's tile table (fused_iter2_bytes: H0 read, y1 and
    # y2 written over every row, W once, the ids of the real rows, the tile
    # table); two products of the real rows' messages with W. Beside it the two
    # fused_iter launches it stands for
    b_ms, b_by = bound(fused_iter2_bytes(bmg, d), 4 * n_real * d * d, bf16_peak)

    def two_iters():
        y1 = fused_iter(t["H0"], t["H0"], t["W"], None, *graph, relu_stream=True)
        return fused_iter(y1, t["H0"], t["W"], None, *graph)

    out["fused_iter2"] = dict(
        ms=time_ms(lambda: fused_iter2(t["H0"], t["W"], None, *graph, bmg.tile_ptr), reps),
        plain_ms=time_ms(lambda: fused_iter2_plain(t["H0"], t["W"], None, *graph), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="bfloat16",
        two_fused_iter_ms=time_ms(two_iters, reps), tiles=n_tiles,
    )
    out["fused_iter2"]["share_of_bound"] = b_ms / out["fused_iter2"]["ms"]
    # E, bf16, over the batch's tile table (iter_bwd_bytes: g, y and H over
    # the real rows, dH and gz over every row, W and dW once; the two products
    # of the real rows). Beside it the form without a table and what it
    # stands for: the masked transposed message, then G W^T and H^T G as
    # library products
    b_ms, b_by = bound(iter_bwd_bytes(bmg, d), 4 * n_real * d * d, bf16_peak)

    def composed_bwd():
        G, gz = bwd_message(t["gb"], t["yb"], *graph, tiles=bmg.tile_ptr)
        return G @ t["W"].t(), gz, grad_weight(t["Hx"], G)

    def e_bwd(tiles=bmg.tile_ptr):
        return iter_bwd(t["gb"], t["yb"], t["Hx"], t["W"], *graph, tiles=tiles)

    out["iter_bwd"] = dict(
        ms=time_ms(e_bwd, reps),
        plain_ms=time_ms(lambda: iter_bwd_plain(t["gb"], t["yb"], t["Hx"], t["W"], *graph), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="bfloat16",
        without_tiles=dict(ms=time_ms(lambda: e_bwd(None), reps), bound_ms=b_ms),
        composed_ms=time_ms(composed_bwd, reps), tiles=n_tiles,
    )
    out["iter_bwd"]["share_of_bound"] = b_ms / out["iter_bwd"]["ms"]
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
        UNSERVED, build_all, bwd_message, bwd_message_nodes, iter_bwd, sorted_segment_sum,
        sorted_segment_sum_counts,
    )
    from chemprop_tpu_torch.ops.build import sass_contains
    from chemprop_tpu_torch.ops.message import (
        bwd_message_info, bwd_message_nodes_info, bwd_message_premul_info, fused_iter2,
        fused_iter2_info, fused_iter_info, iter_bwd_info, message, message_info,
    )
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
    # B's, D's, H's, J's and E's products run on wgmma (HGMMA), and W, W^T,
    # H0, G_in, J's tables and E's g, y, H and W come in by TMA (UTMALDG); C's
    # ranges and A's and G's tiles come in by bulk copies (UBLKCP), and so do
    # E's G and D's message stages from the other blocks of their clusters;
    # F's column slices come in by TMA boxes, its whole tiles by bulk copies
    sass = {}
    for name, opcodes in (("fused_iter", ("HGMMA", "UTMALDG")),
                          ("iter2", ("HGMMA", "UTMALDG", "UBLKCP")),
                          ("bwd_premul", ("HGMMA", "UTMALDG")),
                          ("grad_weight", ("HGMMA", "UTMALDG")), ("segment", ("UBLKCP",)),
                          ("bwd_nodes", ("UBLKCP",)), ("message_tiles", ("UBLKCP",)),
                          ("message_bwd_tiles", ("UBLKCP", "UTMALDG")),
                          ("iter_bwd", ("HGMMA", "UTMALDG", "UBLKCP"))):
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
    if bmg.tile_ptr is None:  # the tile kernels D, G and H need it
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
    # G's persistent grid over the same tiles
    nodes_launch = bwd_message_nodes_info(d, bmg.tile_ptr.numel() - 1)
    print(json.dumps({"bwd_message_nodes_launch": nodes_launch}))
    # D's clusters over the same tiles: one CTA per W slice, the clusters the
    # card runs at once, each over a contiguous range of whole tiles
    iter2_launch = fused_iter2_info(d, bmg.tile_ptr.numel() - 1)
    print(json.dumps({"fused_iter2_launch": iter2_launch}))
    # E's clusters over the same tiles: the clusters of d / 64 blocks the card
    # runs at once
    iter_bwd_launch = iter_bwd_info(d, bmg.tile_ptr.numel() - 1)
    print(json.dumps({"iter_bwd_launch": iter_bwd_launch}))
    # F's persistent grid over the same tiles, in both dtypes, with g alone
    # (the message's backward), g and y, and g, y and gz_acc staged
    bwd_message_launch = {
        f"{str(dt).removeprefix('torch.')},tables={k}": bwd_message_info(
            d, dt, bmg.tile_ptr.numel() - 1, k)
        for dt in (torch.bfloat16, torch.float32) for k in (1, 2, 3)}
    print(json.dumps({"bwd_message_launch": bwd_message_launch}))
    # A's persistent grid over the same tiles, in both dtypes
    message_launch = {
        str(dt).removeprefix("torch."): message_info(d, dt, bmg.tile_ptr.numel() - 1)
        for dt in (torch.bfloat16, torch.float32)}
    print(json.dumps({"message_launch": message_launch}))
    # C's ranges and persistent grid at the M_v and the mean readout
    seg_launch = {
        "edge->node": sorted_segment_sum_info(shapes["E_pad"], shapes["N_pad"], d, torch.bfloat16,
                                              torch.bfloat16),
        "node->graph": sorted_segment_sum_info(shapes["N_pad"], bmg.node_ptr.numel() - 1, d,
                                               torch.bfloat16, torch.float32),
    }
    print(json.dumps({"sorted_segment_sum_launch": seg_launch}))
    tensors, errs = check_kernels(bmg, d, args.seed)
    split_res = check_split_tables(d, args.seed, errs)

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
    extras_launches, extras_res = extras_phase(ds, bmg, out_dir)
    launches.update(extras_launches)
    heads_launches, heads_res = heads_phase(out_dir)
    launches.update(heads_launches)
    # the timings take A's and F's forms without a table on purpose: the main
    # paths' unserved calls are read before them, the benchmark steps' after
    unserved = dict(UNSERVED)

    times = timings(bmg, tensors, d, args.reps, kind)
    UNSERVED.clear()
    rates = forward_rate(bmg, args.reps)
    print(json.dumps({"forward": rates}))
    step_rates = train_rate(batch, args.reps)
    print(json.dumps({"train_step": step_rates}))
    for name, count in UNSERVED.items():
        unserved[name] = unserved.get(name, 0) + count
    # C's device time at both readouts, G's, D's and E's, traced after every
    # untraced timing (a trace slows the launches after it): one call's host
    # work is longer than C, so the events above count the host
    times["sorted_segment_sum"]["device_ms"] = device_ms(
        lambda: sorted_segment_sum(tensors["H"], bmg.dst, bmg.edge_ptr))
    times["sorted_segment_sum_counts"]["device_ms"] = device_ms(
        lambda: sorted_segment_sum_counts(tensors["Hv"], bmg.batch, bmg.node_ptr))
    times["bwd_message_nodes"]["device_ms"] = device_ms(
        lambda: bwd_message_nodes(tensors["g_nodes"], tensors["yb"], bmg.src, bmg.dst, bmg.rev,
                                  bmg.edge_ptr, tiles=bmg.tile_ptr))
    times["fused_iter2"]["device_ms"] = device_ms(
        lambda: fused_iter2(tensors["H0"], tensors["W"], None, bmg.src, bmg.dst, bmg.rev,
                            bmg.edge_ptr, bmg.tile_ptr))
    times["iter_bwd"]["device_ms"] = device_ms(
        lambda: iter_bwd(tensors["gb"], tensors["yb"], tensors["Hx"], tensors["W"], bmg.src,
                         bmg.dst, bmg.rev, bmg.edge_ptr, tiles=bmg.tile_ptr))
    graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
    # F's device time in its four forms, over the tile table and without one,
    # and the sparse yardstick's
    F = times["bwd_message"]
    for entry, gg, yy, acc in ((F, "g32", "y32", None), (F["with_gz_acc"], "g32", "y32", "acc32"),
                               (F["bfloat16"], "gb", "yb", None),
                               (F["bfloat16"]["with_gz_acc"], "gb", "yb", "accb")):
        args = (tensors[gg], tensors[yy], *graph)
        kw = {"gz_acc": tensors[acc] if acc else None}
        entry["device_ms"] = device_ms(lambda: bwd_message(*args, **kw, tiles=bmg.tile_ptr))
        entry["without_tiles"]["device_ms"] = device_ms(lambda: bwd_message(*args, **kw))
        if not isinstance(entry["library_ms"], str):
            SRt, gzm = tensors["SRt"].to(tensors[gg].dtype), tensors[gg] * (tensors[yy] > 0)
            entry["library_device_ms"] = device_ms(lambda: torch.sparse.mm(SRt, gzm))
    # A's device time in both dtypes, in both forms, and the sparse product's
    for entry, x in ((times["message"], tensors["H"]),
                     (times["message"]["float32"], tensors["H32"])):
        entry["device_ms"] = device_ms(lambda: message(x, *graph, bmg.tile_ptr))
        entry["without_tiles"]["device_ms"] = device_ms(lambda: message(x, *graph))
        if not isinstance(entry["library_ms"], str):
            SR = tensors["SR"].to(x.dtype)
            entry["library_device_ms"] = device_ms(lambda: torch.sparse.mm(SR, x))
    print(json.dumps({"unserved": unserved}))
    for name in ("message", "fused_iter2", "bwd_message", "bwd_message_premul",
                 "bwd_message_nodes", "iter_bwd", "row_gather"):
        if unserved.get(name, 0):
            fail(f"{name} left {unserved[name]} batches unserved")

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
              "sass": sass, "fused_iter_launch": launch, "fused_iter2_launch": iter2_launch,
              "bwd_message_premul_launch": premul_launch,
              "bwd_message_nodes_launch": nodes_launch, "iter_bwd_launch": iter_bwd_launch,
              "message_launch": message_launch, "bwd_message_launch": bwd_message_launch,
              "sorted_segment_sum_launch": seg_launch, "unserved": unserved,
              "split_tables": split_res,
              "benchmark_batch": shapes,
              "main_path": path_res, "train_path": train_res, "train_step_cuda_vs_cpu": step_res,
              "repeated_bfloat16_fits": repeat_res, "dropout_path": dropout_res,
              "train_dropout_step_cuda_vs_cpu": dropout_step_res, "extras": extras_res,
              "heads": heads_res,
              "forward": rates,
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
