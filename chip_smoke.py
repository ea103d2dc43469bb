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
   equal to their forms without a table, with the message and the masked
   transposed message (unmasked, masked, with gz_acc) in float32 and
   bfloat16 over the same split table, the two chained iterations over it
   with their two row passes (bit for bit two fused iterations, two calls
   equal), the whole-iteration backward over it with the cross rows' G
   formed first and taken into its tile launch (gz bit for bit its form
   without a table, dH and dW within its limits, two calls equal, dH outside
   the cross rows the bits of a launch that takes none of them, a row the
   list leaves out NaN), and the four passes alone (``SPLIT_PASSES``) against
   their plain versions and timed; the segment
   sum at both readouts (edges to nodes, nodes to graphs) in all three dtype
   pairs, with and without counts, two calls equal; the whole-iteration
   backward with the batch's tile table and without one, gz equal bit for
   bit to the plain version in both forms, two calls equal; the two chained
   iterations over the tile table equal to two fused iterations bit for
   bit, with and without a bias, in two calls, its padding rows zero where
   H0's are, and its launch shape (clusters of one
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
   with its sparse product, from a trace (``kernel_trace``: a trace that
   holds a record of every launch, else null; ``device_traces`` counts
   them); the
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
   their own line;
9. the command line's ``train`` and ``serve``, in this process so that the
   launch counts see them, each part fatal: (a) ``train`` on mol.csv at full
   width with batch norm, the mean readout, a scaffold-balanced split and an
   ensemble of two,
   ``CLI_TRAIN_EPOCHS`` epochs in float32 and in bfloat16, each run's
   launches counted on their own (A, C, F in f32; B, C, G, H, I in bf16;
   nothing unserved); the first member's first epoch against the same
   command on the CPU (rtol 1e-4 in f32, 1e-3 in bf16), and the parameters
   after one epoch of the same command (two Adam steps) on the card
   against the CPU's, each tensor's share of elements apart by more than
   ``CLI_PARAM_TAU`` within ``CLI_PARAM_SHARE`` (a kernel of the backward
   with its output zeroed breaks it, where the loss moves by 1e-3 or less:
   experiments/torch_cli_train_check.py); bfloat16's last
   epoch below ``CLI_TRAIN_BF16_BAR`` (0.15: the same command on the CPU
   ended its two members at 0.0416 and 0.0686);
   every artefact written; each ``best.ckpt`` through ``predict`` on the
   card against its ``test_predictions.csv`` at phase 3's limits; (b)
   ``make_server`` on port 0 in a thread over (a)'s bfloat16 ``best.ckpt``
   and, in float32, the reference checkpoint: a burst of ``SERVE_CLIENTS``
   concurrent clients, each with 4-8 SMILES of mol.csv and one invalid one,
   every row against ``predict`` of the same checkpoint on the card at phase
   3's limits, the invalid rows null with their errors, fewer dispatches
   than requests, 413 over ``--max-batch``, each dispatch launching one
   forward's kernels; the burst's requests per second and its p50 and p99
   latency are printed with the card's name and power limit. The phase's
   seconds are printed on their own line;
10. the prediction side of the command line, in this process, each run's
   launches held exactly to its forwards' and steps', nothing unserved: (a)
   ``predict`` of the chemprop v1 file (its featurizer mode found by
   ``predict``) on its 50 reference SMILES in float32 and bfloat16, against
   the CPU at phase 3's limits, float32 also within 1e-4 of the v1
   reference's predictions; (b) ``convert`` of the v1 and the v2 file, whose
   outputs ``predict`` on the card to their sources' CSVs byte for byte;
   (c) ``predict`` with uncertainty, each output CSV against the CPU's at
   phase 3's float32 limits: an ensemble of the reference checkpoint and
   phase 9's first float32 member with ``zscaling`` calibration, the MVE,
   evidential (total), binary (``isotonic`` calibration on Tox21's rows
   50-99) and multiclass Dirichlet checkpoints with their methods; (d)
   Monte-Carlo dropout in bfloat16 with the CPU's masks carried across; (e)
   ``fingerprint`` in float32; (f) one epoch of ``train --from-foundation``
   the v2 file in float32 and bfloat16 against the CPU as phase 9(a) holds
   ``train``. The phase's seconds are printed on their own line with the
   card's name and power limit;
11. ``hpopt`` and the other architectures, in this process, each run first
   on the CPU, whose plain versions' calls count the launches the card's run
   must make exactly (``rehearsal``), nothing unserved: (a)(b) one epoch of
   ``train`` with ``--atom-messages``, with ``--aggregation attentive`` and
   with both, in float32 and bfloat16 without batch norm, held to the CPU's
   run as phase 9(a) holds ``train`` (the attentive readout's bias, which has
   no gradient, exempt from the parameters' share), then ``predict`` of its
   ``best.ckpt``
   on the card against its ``test_predictions.csv`` and the CPU's at phase
   3's limits; (c) ``hpopt`` with FIFO and random draws, three trials of two
   epochs over every keyword in bfloat16 from ``HPOPT_SEED``, the CPU's
   dropout masks replayed on the card: the same trials as the CPU's, a
   hidden width of 600 or more, another activation than ReLU and a dropout
   among them, every score finite and within the CPU's by phase 3's bf16
   limit carried into the loss plus ``HPOPT_LOSS_RTOL`` times the trial's
   sum of step rates over phase 9(a)'s (``hold_trials``); (d) ``hpopt`` with ASHA, three trials, eta 3, three epochs: the
   survivor resumed from its ``last.ckpt`` for epochs 1-2. The phase's
   seconds are printed on their own line with the card's name and power
   limit. Phase 2 also holds the segment sum at atom message passing's
   message table, [H ; E ; 0] at 400 columns, in both dtypes, and phase 7
   times it;
12. molecule featurizers, multicomponent and reaction models, in this
   process, each run first rehearsed on the CPU: its launches (the second
   passes over split tables included: mol+mol.csv's dyes of more than 128
   directed edges give their component one) exactly the rehearsal's, and
   no call without a table (``ops.UNSERVED``), printed as
   ``{"multicomponent_unserved": ...}``: (a) one
   bf16 ``train`` epoch on mol.csv with ``--molecule-featurizers
   morgan_binary v1_rdkit_2d``, its loss within phase 9(a)'s limit of the
   CPU's, then ``predict`` of its ``best.ckpt`` with them against the CPU's
   and its ``test_predictions.csv``; (b) ``predict`` of the reference
   mol+mol, rxn and rxn+mol checkpoints on their CSVs in f32 and bf16
   against the CPU's (the rxn+mol components through the component-order
   fix); (c) one ``train`` epoch in f32 and bf16 of mol+mol with two blocks,
   of mol+mol with ``--mpn-shared``, of rxn (the condensed graph of
   reaction, reac_diff) and of rxn+mol, without batch norm, each held to
   the CPU's as phase 9(a) holds ``train`` (loss, each parameter tensor's
   share of elements apart). Predictions are held at phase 3's limits in
   the units of each model's unscaling. The phase's seconds are printed on
   their own line with the card's name and power limit;
13. mol-atom-bond models, in this process, each run first rehearsed on the
   CPU as in phase 12, G, H and D never launched (the MAB path takes no
   ``loop_readout``): (a) ``predict`` of the 14 reference checkpoints of
   tests/data/mol_atom_bond/example_models in f32 and bf16 on the inputs the
   JAX package's tests give them (the constraints of
   ``regression_constrained.pt``, the five extra inputs of
   ``regression_with_extras.pt``), against the CPU's at phase 3's limits in
   each column's unscaled units, and the atom-mapped corpus's 500 molecules
   in f32 against the reference's own predictions (rtol 1e-3, atol 3e-4)
   with no call unserved; (b) one ``train`` epoch in f32 and bf16 of a
   molecule, atom and bond head on regression.csv and of the atom head on
   the corpus, without batch norm, each held to the CPU's as phase 9(a)
   holds ``train``. The phase's seconds are printed on their own line with
   the card's name and power limit;
14. interpretation, in this process, each run first rehearsed on the CPU as
   in phase 12 (where a bf16 search takes another turn on the card, its
   launches are held to a rehearsal of its own batches): the reference
   regression and binary classification checkpoints in f32 and bf16, (a)
   exact Myerson attributions of mol.csv's first molecule of 12-16 heavy
   atoms and sampled ones (200 permutations) of its first of more than 20,
   (b) MCTS rationales of both with default parameters, (c) ``predict
   --callback myerson`` and ``--callback mcts`` of the regression
   checkpoint on mol.csv's first three rows; each against the same run on
   the CPU: every subgraph prediction at phase 3's limits, attributions
   within 2 n times the largest subgraph difference (the CLI's: 2 n times
   phase 3's limit), the attributions' sum within 1e-4 of the molecule's
   prediction in f32 (bf16: phase 3's limit), the rationales' atom sets equal
   in f32 and their scores at phase 3's limits (bf16: the sets only one side
   found are listed with their margin to ``prop_delta``). The phase's
   seconds, subgraphs and batches are printed on their own line with the
   card's name and power limit;
15. export (``models.export``): the default model at full width, its weights
   from ``--seed``, in f32 and bf16, exported on the card from the benchmark
   batch, its program's launches first rehearsed on the CPU (exported there
   from mol.csv's batch); one call on the benchmark batch and one on its
   graphs rotated and padded wider (other node and edge counts), each
   launching exactly the eager forward's kernels (A 2 + C 2 in f32, B 2 +
   C 2 in bf16) and the rehearsal's, nothing unserved, within 1e-5 (f32) or
   1e-3 (bf16) of the eager forward; the eager and exported calls timed;
   each ``.pt2`` loaded and run in a new process that imports only
   ``chemprop_tpu_torch.ops`` (its load seconds, launches and output held
   the same way); (d) the same model exported from Tox21's split batch in
   f32 and in bf16 with ``iter2``, rehearsed on the CPU: A's tile kernel
   and its pass, or D and its two passes, launched as the rehearsal and the
   eager forward launch them, nothing unserved, within the same limits;
   (e) a bf16 fit with dropout 0.1, ``iter2`` and ``fused_bwd`` over 150 of
   Tox21's molecules (E and its pass in the steps, D and its passes in the
   prediction), launching exactly as rehearsed on the CPU, nothing
   unserved;
16. the native featurizer and the kmeans split on the command line: one
   f32 ``train`` epoch with ``--split kmeans
   --use-cuikmolmaker-featurization`` on the card, rehearsed on the CPU
   (launches and unserved calls exactly, the loss within phase 9(a)'s
   limit), then the same epoch with Python featurization, whose splits and
   losses must be the same bits; ``predict`` of its ``best.ckpt`` with the
   flag and without, the same rows. Phases 15 and 16 print their seconds
   and numbers on their own lines with the card's name and power limit;
17. multi-GPU, each part fatal: (a) the giant polymer ``"C1(CCCCC1)" *
   3000`` (18,000 atoms) cut into 4 local shards, the partitioned forward
   and one Adam step of the default model (no batch norm) in f32, rehearsed
   on the CPU (kernels C and I exactly the rehearsal's launches, no other),
   held against the rehearsal, against the same run on the card with the
   plain versions of C and I, and against the card's dense single-device
   forward and step (forward rtol 1e-4 / atol 1e-5, loss rtol 1e-4, the
   parameters as phase 4(b) holds one step); (b) ``Trainer(mesh=...)`` over
   a process group of one on NCCL, three steps on the benchmark batch with
   batch norm in f32 and bf16: the plain trainer's losses and parameters
   bit for bit, its launches, nothing more unserved; (c) ``train``,
   ``predict`` and ``fingerprint --edge-partition 4`` on mol.csv's first 30
   rows and the giant polymer on the card against the CPU. Its seconds are
   printed with the card's name and power limit;
18. v1 files of several molecules, the command line's ``Subcommand``
   surface and ``steps_per_dispatch``, each part fatal: (a) a v1 file of two
   molecules built by ``two_molecule_v1`` (the tests' recipe: a second,
   noised encoder and a 600-input readout) into
   ``chiprun_out/chip_smoke_v1_multi/``, then ``predict`` and
   ``fingerprint`` of it on the 100 rows of mol+mol.csv in f32 and bf16,
   rehearsed on the CPU (A, or B in bf16, and C for each component, A's
   second pass over the dyes' split table; the calls without a tile table
   exactly the rehearsal's), held to the CPU in
   units of the unscaling (predictions) or of the fingerprints' RMS: f32 at
   phase 3's limits, bf16 within 1e-3 or twice what bf16 rounding moves the
   CPU's output from its f32 output, and within phase 3's bf16 envelope; (b) ``python -m chemprop_tpu_torch.cli --version`` and
   one f32 ``train`` epoch through the parser built from the
   ``*Subcommand`` classes, rehearsed, its loss within phase 9(a)'s f32
   limit; (c) two bf16 fits of the default model, 3 epochs from one seed,
   one with ``steps_per_dispatch=4``: the same loss history and parameters
   bit for bit. Its seconds are printed with the card's name and power
   limit;
19. the training input pipeline: a bf16 ``Trainer.fit`` of the default model
   at full width (phase 4's: d_h 300 padded to 384, depth 3, batch norm,
   mean readout, no dropout), ``PIPELINE_EPOCHS`` epochs of mol.csv's 100
   rows in shuffled batches of 32, through the loader's thread
   (``prefetch=2``), a dataset whose cache two worker processes featurised
   (``n_workers=2``, forked after CUDA is up; the cache equal to the serial
   one) and the trainer's device prefetch (pinned batches copied on a copy
   stream two batches ahead). Rehearsed on the CPU first (B 2, C 2, G 1,
   H 1, I 1 per step; the calls without a tile table exactly the
   rehearsal's), then held bit for bit (losses and every parameter and
   batch-norm tensor) to a loop of ``train_step`` over the same host batches
   collated inline (``prefetch=0``, ``n_workers=0``), which launches the
   same kernels; to the same fit with ``mesh`` at world size 1 over NCCL
   (each rank's shard moved ahead); and to a fit with the device prefetch
   alone (the loader at ``prefetch=0``). The fit and the plain loop run
   under ``torch.cuda.set_sync_debug_mode("warn")``: their synchronisations
   per epoch must be equal and at most one, the epoch's loss fetch (each is
   counted by the line that made it), and no tile table may be read back
   (``check_tiles``). It prints each epoch's ``edges_per_s`` of the fit, the
   fit without the loader's thread and the plain loop, and, after every
   untraced timing, the device's idle share over one more epoch of the fit
   traced by ``torch.profiler`` (the union of its device intervals against
   the untraced epochs' wall time);
20. the loader's isolation of oversized molecules and the examples, each
   part fatal: (a) mol.csv's 100 rows with ``ISOLATION_GIANT`` (480
   directed edges) at rows ``ISOLATION_ROWS``, the default model at full
   width: a bf16 ``Trainer.fit`` of ``ISOLATION_EPOCHS`` epochs in shuffled
   batches of ``ISOLATION_BATCH`` (five a epoch, where ``len`` counts four),
   then fixed-order ``predict`` of its weights in f32 and bf16, each
   rehearsed on the CPU (launches and calls without a tile table exactly
   the rehearsal's); each batch's calls without a tile table read around
   its step or forward (``per_batch``): none in any batch, with the giant's
   split table too, and none with ``_isolate_oversized = False``;
   the predictions in dataset order against the same rows at batch size 1
   at phase 3's f32 and bf16 limits; a second fit from the seed, its
   losses equal bit for bit; (b) ``MABTrainer.predict`` of
   ``ISOLATION_MAB`` in f32 over regression.csv's molecules with the giant
   in the middle, in batches of ``ISOLATION_MAB_BATCH``, rehearsed, its
   giant emitted last and each table in dataset order against batch size
   1 at phase 3's f32 limits in units of the table's largest value; (c)
   every script of examples_torch/ in this process on ``cuda`` at its full
   size (``EXAMPLES_QUICK`` with ``--quick``), each one's seconds,
   launches and calls without a tile table printed, fatal where it raises
   or launches no hand-written kernel; what a script changes of the
   process's state (logging, torch's dtype, threads, TF32 and random
   state, numpy's, the working directory, ``sys.argv``) is put back after
   it and named (``kept_state``). Its seconds, those of (c) and the whole
   run's so far are printed with the card's name and power limit.

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
# the second passes over a split table's cross rows (a batch holding a
# molecule of more than 128 directed edges): each forms the rows that the
# tile kernels of the TPU kernel it serves cannot form in their tile (E's
# before its tile launch, which takes them in).
# Phase 2 checks and times them alone on Tox21; a path launches them where
# its batches hold split tables, so their counts are held to a rehearsal's,
# never to ``PATH_KERNELS``
SPLIT_PASSES = {
    "message_rows": dict(
        source="chemprop_tpu_torch/csrc/message.cu",
        replaces="chemprop_tpu/ops/fused_message.py:244",
        tpu_kernel="_kernel via _fused_message_impl (kw=2, 3), the rows across tiles",
        timed="message_rows[float32]",
    ),
    "bwd_message_rows": dict(
        source="chemprop_tpu_torch/csrc/message_bwd.cu",
        replaces="chemprop_tpu/ops/fused_message.py:729",
        tpu_kernel="_bwd_msg_kernel via _bwd_msg_impl (kw=2, 3), the rows across tiles; "
                   "also G's and H's",
        timed="bwd_message_rows[float32]",
    ),
    "fused_iter_rows": dict(
        source="chemprop_tpu_torch/csrc/fused_iter.cu",
        replaces="chemprop_tpu/ops/fused_message.py:394",
        tpu_kernel="_iter2_kernel via _iter2_impl (kw=2, 3), the rows of y1, then y2, across "
                   "tiles",
        timed="fused_iter_rows[y2]",
    ),
    "iter_bwd_rows": dict(
        source="chemprop_tpu_torch/csrc/message_bwd.cu",
        replaces="chemprop_tpu/ops/fused_message.py:603",
        tpu_kernel="_iter_bwd_kernel via _iter_bwd_impl (kw=2, 3), G of the rows across tiles, "
                   "which E's tile launch then takes in",
        timed="iter_bwd_rows[G_c]",
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
    # phase 9: `train` through the CLI (its steps, validation and test
    # predictions) and `serve` (one forward per dispatch)
    "train_cli_float32": {"message": 2, "sorted_segment_sum": 2, "bwd_message": 2},
    "train_cli_bfloat16": {"fused_iter": 2, "sorted_segment_sum": 2, "bwd_message_nodes": 1,
                           "bwd_message_premul": 1, "row_gather": 1},
    "serve_bfloat16_best_ckpt": {"fused_iter": 2, "sorted_segment_sum": 2},
    "serve_float32_reference_pt": {"message": 2, "sorted_segment_sum": 2},
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
# phase 9(a): `train` on mol.csv, CLI_TRAIN_EPOCHS epochs; bf16's last epoch's
# train loss (normalised MSE) must fall below the bar. The same command in bf16
# on the CPU (`python -m chemprop_tpu_torch.cli train ... --device cpu`, the
# H100 machine's CPU) went 2.168 -> 0.0416 (first member) and 1.207 -> 0.0686
# (second); the card's first member went 2.167 -> 0.0446, its second ended at
# 0.0554. The losses still move by up to 0.1 between the last epochs, so the
# bar is about twice the CPU's larger last loss
CLI_TRAIN_EPOCHS = 20
CLI_TRAIN_BF16_BAR = 0.15
# phase 9(a): the first epoch's two Adam steps (rates 1e-4 and 3.25e-4 of the
# warm-up) on the card against the CPU: no parameter tensor may have more than
# CLI_PARAM_SHARE of its elements apart by more than CLI_PARAM_TAU, half the
# two rates. experiments/torch_cli_train_check.py on the H100 (700 W): the
# port's worst tensor 0.02 (f32) and 0.03 (bf16), both W_o's bias, whose
# gradient under batch norm is near zero, so Adam's step takes its rounding's
# sign (W_h 0 and 0.0081, W_i 0 and 0.0032); with a kernel's output zeroed,
# W_h 0.635 (F, f32) and 0.632 (G, bf16), W_i 0.148 (H's cotangent of H0, bf16)
CLI_FIRST_LRS = 1e-4 + 3.25e-4
CLI_PARAM_TAU = CLI_FIRST_LRS / 2
CLI_PARAM_SHARE = 0.07
# phase 9(b): the burst of concurrent clients, their SMILES drawn from SERVE_SEED
SERVE_CLIENTS, SERVE_SEED = 16, 0
# phase 10: the reference v1 file and its predictions, Tox21 (its first 100
# rows the binary head's inputs and calibration set), the rows of each input
# and calibration set, the Monte-Carlo samples
V1_CKPT = REPO / "tests/data/example_model_v1_regression_mol.pt"
V1_GOLDEN = REPO / "tests/data/example_model_v1_regression_mol_prediction.csv"
TOX21_CSV = REPO / "tests/data/classification/mol.csv"
PREDICT_BATCH, PREDICT_ROWS, MC_SAMPLES = 64, 50, 4
# scipy's Nelder-Mead stops when its simplex lies within 1e-4 in x and in the
# objective: inputs 1e-7 apart moved zscaling's fitted variance scale by up to
# 8e-4 of itself in five seeded fits of 50 rows (tests/test_torch_uncertainty.py
# ::test_zscaling_scale_moves_within_the_fits_tolerance)
FITTED_SCALE_RTOL = 5e-3
# phase 6(a): the descriptor model's 30 epochs must bring the last epoch's train
# loss (normalised targets) to this, and the best epoch's val_rmse to the other
DESCRIPTOR_TRAIN_LOSS, DESCRIPTOR_VAL_RMSE = 0.05, 0.5
# phase 11(a)(b): the other architectures of `train`, each a one-epoch run on
# the card and on the CPU in both dtypes, without batch norm: under it the
# fingerprint's columns lose their offsets, so W_o's bias has a gradient
# near zero, whose sign Adam's first steps follow: on the H100 (700 W) a bf16
# epoch of atom message passing with batch norm had 0.107 of W_o's bias apart
# by more than CLI_PARAM_TAU (phase 9's bond model 0.02-0.03). The attentive
# readout's bias has no gradient at all (a softmax is unchanged by a shift of
# its logits), so it is exempt from the share of elements apart
ARCHITECTURES = {
    "atom_messages": ("--atom-messages",),
    "attentive": ("--aggregation", "attentive"),
    "atom_messages_attentive": ("--atom-messages", "--aggregation", "attentive"),
}
ZERO_GRADIENT = ("agg/W/bias",)
# phase 11(c): hpopt's draws come from numpy's generator, so a seed picks the
# trials. HPOPT_SEED was found by drawing the configs of seeds 0, 1, ... on
# the CPU with `cli.hpopt._sample` (the first whose three trials hold a hidden
# width of 600 or more, an activation other than ReLU and a dropout above 0,
# and a ReLU trial of depth 3 or more without dropout, whose steps take B, G
# and H, at the least work): a ReLU trial at width 600 (lane-padded to 640),
# and two tanh trials with dropout 0.05 and 0.2, one at depth 4 in batches of
# 32. The phase asserts those properties of the trials it ran
HPOPT_SEED = 552
HPOPT_TRIALS, HPOPT_EPOCHS = 3, 2
# a trial's score (its best validation loss, an MSE of scaled targets) on the
# card against the CPU's, the dropout masks carried across, is held to two
# terms. The forward's: phase 3 holds bf16 predictions to atol
# BF16_PREDICT_ATOL, which moves an MSE of L by up to 2 sqrt(L) times it. The
# steps': phase 9(a) holds the bf16 loss after two Adam steps, whose rates
# sum to CLI_FIRST_LRS, to rtol HPOPT_LOSS_RTOL; an Adam step moves an
# element by at most its rate, in the sign its gradient has on each device,
# so the two runs part in proportion to the sum of the rates of the steps
# taken. (On the H100, 700 W, a tanh trial whose six steps' rates sum to
# 5.9e-3 read 5.4e-3 of the CPU's score, a ReLU trial whose two steps'
# rates sum to 2.1e-4 read 8.3e-4.)
BF16_PREDICT_ATOL = 1e-3
HPOPT_LOSS_RTOL = 1e-3
# phase 12(a): the molecule featurizers of the bf16 train epoch on mol.csv, and
# the width of their vectors (2048 Morgan bits and 200 descriptors)
MOLECULE_FEATURIZERS = ("morgan_binary", "v1_rdkit_2d")
MOLECULE_FEATURIZER_WIDTH = 2048 + 200
# phase 12(b): the reference multicomponent and reaction checkpoints, their
# bundled CSVs (under tests/data/regression) and input columns
MULTI_REFERENCES = {
    "mol+mol": ("example_model_v2_regression_mol+mol.pt", "mol+mol/mol+mol.csv",
                ["-s", "smiles", "solvent"]),
    "rxn": ("example_model_v2_regression_rxn.pt", "rxn/rxn.csv", ["--reaction-columns", "smiles"]),
    "rxn+mol": ("example_model_v2_regression_rxn+mol.pt", "rxn+mol/rxn+mol.csv",
                ["--reaction-columns", "rxn_smiles", "-s", "solvent_smiles"]),
}
# phase 12(c): one train epoch of each, full width, no batch norm (phase 11's
# finding: under it W_o's bias has a gradient near zero, whose sign Adam's
# first steps follow); each epoch is two steps, as phase 9(a)'s, so that
# first_epoch_params' limits apply: 79 and 80 training rows in batches of 64,
# rxn+mol's 320 in batches of 160; each with the blocks its model must have
# (0: a single-molecule MPNN over the condensed graph of reaction)
_MM = REPO / "tests/data/regression/mol+mol/mol+mol.csv"
MULTI_TRAINS = {
    "mol_mol": (["-i", _MM, "-s", "smiles", "solvent"], 2),
    "mol_mol_shared": (["-i", _MM, "-s", "smiles", "solvent", "--mpn-shared"], 1),
    "rxn": (["-i", REPO / "tests/data/regression/rxn/rxn.csv", "--reaction-columns", "smiles",
             "--rxn-mode", "reac_diff"], 0),
    "rxn_mol": (["-i", REPO / "tests/data/regression/rxn+mol/rxn+mol.csv", "--reaction-columns",
                 "rxn_smiles", "-s", "solvent_smiles", "-b", 160], 2),
}
# phase 11: the plain versions that the wrappers take on a CPU tensor where
# they launch their kernels on a CUDA one, by module and kernel name; a
# rehearsal on the CPU counts their calls (not those nested in another plain
# version) as the launches of the same run on the card
PLAIN_VERSIONS = {
    "message": {"message_plain": "message", "fused_iter_plain": "fused_iter",
                "fused_iter2_plain": "fused_iter2", "bwd_message_plain": "bwd_message",
                "bwd_message_nodes_plain": "bwd_message_nodes",
                "bwd_message_premul_plain": "bwd_message_premul", "iter_bwd_plain": "iter_bwd",
                "message_rows_plain": "message_rows",
                "bwd_message_rows_plain": "bwd_message_rows",
                "fused_iter_rows_plain": "fused_iter_rows",
                "iter_bwd_rows_plain": "iter_bwd_rows"},
    "segment": {"sorted_segment_sum_plain": "sorted_segment_sum"},
    "gather": {"row_gather_plain": "row_gather"},
}

# phase 13: the mol-atom-bond (MAB) reference checkpoints, the reference's
# predictions of its atom-mapped corpus (500 molecules, at most 122 directed
# edges each: every batch has its tile table) and the JAX package's limits
# against them; a MAB path never runs loop_readout, so G and H (and D) must
# not launch
MAB_DIR = REPO / "tests/data/mol_atom_bond"
MAB_MODELS = MAB_DIR / "example_models"
MAB_CORPUS = MAB_DIR / "atomic_regression_atom_mapped.csv"
MAB_GOLDEN = MAB_DIR / "atomic_regression_atom_mapped_preds.csv"
MAB_GOLDEN_RTOL, MAB_GOLDEN_ATOL = 1e-3, 3e-4
MAB_ABSENT = ("bwd_message_nodes", "bwd_message_premul", "fused_iter2")
_MAB_TARGETS = ["--mol-target-columns", "mol_y1", "mol_y2", "--atom-target-columns", "atom_y1",
                "atom_y2", "--bond-target-columns", "bond_y1", "bond_y2"]
# phase 13(b): one train epoch, two Adam steps as phase 9(a)'s (9 training rows
# of regression.csv in batches of 5; the corpus's 400 in batches of 200), full
# width, no batch norm
MAB_TRAINS = {
    "three_heads": ["-i", MAB_DIR / "regression.csv", "--keep-h", "-b", 5, *_MAB_TARGETS],
    "atom_corpus": ["-i", MAB_CORPUS, "--atom-target-columns", "charges", "-b", 200],
}

# phase 14: interpretation at full width, the reference regression and binary
# classification checkpoints (d_h 300 padded to 384, depth 3, batch norm, mean
# readout): exact Myerson on the first molecule of mol.csv with EXACT_ATOMS
# heavy atoms, sampled Myerson (INTERPRET_SAMPLES permutations) and MCTS with
# default parameters on the first of more than SAMPLED_ABOVE; then the CLI's
# callbacks on INTERPRET_CLI_ROWS rows. mol.csv's largest molecule has 51
# bonds, so every subgraph batch has its tile table
INTERPRET_MODELS = {"regression": CKPT,
                    "classification": REPO / "tests/data/example_model_v2_classification_mol.pt"}
EXACT_ATOMS = (12, 16)
SAMPLED_ABOVE = 20
INTERPRET_SAMPLES = 200
INTERPRET_CLI_ROWS = 3


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


def lipo_dataset(n_workers: int = 0):
    """The 100 rows of mol.csv with normalised targets, featurised once (by
    ``n_workers`` forked processes where it is above 1)."""
    import numpy as np

    from chemprop_tpu_torch.data import MoleculeDatapoint, MoleculeDataset

    with open(MOL_CSV, newline="") as f:
        rows = list(csv.reader(f))[1:]
    ds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=np.array([float(y)])) for s, y in rows],
                         n_workers=n_workers)
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


def atom_message_width(d: int, d_e: int) -> int:
    """The width of atom message passing's message table [H ; E ; 0]: the
    lane-padded hidden width and the bond features, to a multiple of 8
    (``AtomMessagePassing.d_message``)."""
    return -(-(d + d_e) // 8) * 8


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
    # C at the atom-message width: atom message passing's message table
    # [H ; E ; 0], 384 + 14 bond features laid out to 400 columns (16-byte
    # rows), edges to nodes in both dtypes, with the limits above; drawn from
    # a generator of its own, so that the other checks keep their inputs
    g_msg = torch.Generator(device=dev).manual_seed(seed + 1)
    d_msg = atom_message_width(d, bmg.E.shape[1])
    HE32 = torch.randn((n_e, d_msg), generator=g_msg, device=dev)
    for data in (HE32, HE32.to(torch.bfloat16)):
        tag = f"sorted_segment_sum[atom-message,{data.dtype}->{data.dtype}]"
        got = sorted_segment_sum(data, bmg.dst, bmg.edge_ptr)
        want = sorted_segment_sum_plain(data, bmg.dst, bmg.edge_ptr, data.dtype)[0]
        if data.dtype == torch.bfloat16:
            check(tag, got, want, BF16_ULP, 1e-4, errs)
        else:
            check(tag, got, want, 1e-5, 1e-6, errs, abs_sums(data, bmg.dst, bmg.edge_ptr))
        if not torch.equal(got, sorted_segment_sum(data, bmg.dst, bmg.edge_ptr)):
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
                   Hx=Hx, Gt=Gt, Xi=Xi, HE32=HE32, HE=HE32.to(torch.bfloat16))
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


def check_path_launches(path: str, launches: dict, exact: bool, want: dict | None = None) -> None:
    """Fail unless the path launched its kernels (with ``exact``, each the
    number of times one forward or one training step does, or ``want``'s
    count for a run of several) and no other; the second passes over split
    tables (``SPLIT_PASSES``) are held to ``want`` alone."""
    counts = PATH_KERNELS[path] if want is None else want
    for name in [*KERNELS, *(SPLIT_PASSES if want is not None else ())]:
        n, got = counts.get(name, 0), launches.get(name, 0)
        ok = got == n if exact or n == 0 else got > 0
        if not ok:
            fail(f"the {path} path launched {name} {got} times, expected "
                 f"{n}{'' if exact or n == 0 else ' or more'}")


def unserved_since(before: dict) -> dict:
    """The calls ``ops.UNSERVED`` counted since it held ``before``. A phase
    reads its own share this way and never clears the counter, which the
    final gate reads over every main path."""
    from chemprop_tpu_torch.ops import UNSERVED

    return {k: v - before.get(k, 0) for k, v in UNSERVED.items() if v != before.get(k, 0)}


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


def tox21_bmg(device: str = "cuda"):
    """Tox21's 500 molecules (classification/mol.csv, 8 of them of more than
    128 directed edges) in one batch on ``device``: no tile table; its split
    table cuts those molecules at their nodes' boundaries, ``cross_rows``
    lists the rows that read another tile, ``y1_rows`` / ``y2_rows`` the rows
    D cannot form in its tile."""
    from chemprop_tpu_torch.chem import make_mol
    from chemprop_tpu_torch.data.collate import batch_mol_graphs
    from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer

    feat = SimpleMoleculeMolGraphFeaturizer()
    rows = read_targets(REPO / "tests/data/classification/mol.csv")
    return batch_mol_graphs([feat(make_mol(smi)) for smi, *_ in rows]).to(device)


def check_split_tables(d: int, seed: int, errs: dict, reps: int, card: str) -> dict:
    """Phase 2, the tile kernels on a split tile table: Tox21's 500 molecules
    in one batch (:func:`tox21_bmg`). A (f32 and bf16), F (f32 and bf16,
    unmasked, masked and with gz_acc), G and H (``fold_h0`` on and off) with
    the split table must give the bits of their forms without a table on
    every row, in two calls, and hold against their plain versions at the
    limits of the tiled check; D with D's lists the bits of two B launches
    (its form without a table), E with the cross rows ``gz`` bit-equal to
    its form without a table and ``dH``, ``dW`` within E's limits of the
    plain version, both in two calls; its ``dH`` outside the cross rows the
    bits of a launch that takes none of them (whose rows there are NaN), and
    a cross row the list leaves out NaN. Then the passes alone
    (``message_rows``, ``bwd_message_rows``, ``fused_iter_rows`` over
    ``y2_rows``, and ``iter_bwd_rows``, E's launch that forms the cross rows'
    ``G`` before its tile launch) against their plain versions, and timed
    beside them with the least time the card could take (``SPLIT_PASSES``);
    beside ``iter_bwd_rows`` the two library products that E's tile launch
    now does for those rows (``torch.mm`` of ``G_c W^T`` and of
    ``H[rows]^T G_c``), as yardsticks."""
    import torch

    from chemprop_tpu_torch.ops import (
        bwd_message, bwd_message_nodes, bwd_message_premul, fused_iter, fused_iter2, iter_bwd,
        message,
    )
    from chemprop_tpu_torch.ops.message import (
        _cross_rows, _fused_iter_rows, _iter_bwd_rows, _message_rows, _transposed, bwd_message_nodes_plain,
        bwd_message_plain, bwd_message_premul_plain, bwd_message_rows_plain, fused_iter2_plain,
        fused_iter_rows_plain, iter_bwd_plain, iter_bwd_rows_plain, message_plain,
        message_rows_plain,
    )

    b = tox21_bmg()
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
    H32 = torch.randn((n_e, d), generator=g, device="cuda")
    g32 = torch.randn((n_e, d), generator=g, device="cuda")
    y32 = torch.randn((n_e, d), generator=g, device="cuda").clamp_min(0)  # a ReLU output
    acc32 = torch.randn((n_e, d), generator=g, device="cuda")
    split = {"tiles": b.split_ptr, "cross": b.cross_rows}
    table = (b.split_ptr, b.cross_rows)

    def same(tag, got, want):
        got, want = [t for t in got if t is not None], [t for t in want if t is not None]
        if not all(torch.equal(x, w) for x, w in zip(got, want)):
            fail(f"{tag}: the split table's bits differ from the form without a table")
        if any(t[pad_rows].any() for t in got):
            fail(f"{tag}: a padding row is not zero")

    # A, then F in its three forms: the tile kernel, then the pass over the
    # cross rows (F's from g and y, never from gz_out), in f32 (only the
    # summation order differs from the plain version's) and bf16 (f32 sums
    # rounded once: a sum in another order may round to the neighbouring
    # bf16 value)
    for dt, rtol, atol in ((torch.float32, 1e-5, 1e-5), (torch.bfloat16, BF16_ULP, 1e-6)):
        name = str(dt).removeprefix("torch.")
        x = H32.to(dt)
        out = message(x, *graph, **split)
        same(f"message[split,{name}]", (out,), (message(x, *graph),))
        same(f"message[split,{name},again]", (message(x, *graph, **split),), (out,))
        check(f"message[split,{name}]", out, message_plain(x, *graph), rtol, atol, errs)
        gg, yy, acc = g32.to(dt), y32.to(dt), acc32.to(dt)
        for form, y_, a_ in (("masked", yy, None), ("gz_acc", yy, acc)):
            tag = f"bwd_message[split,{name},{form}"
            out = bwd_message(gg, y_, *graph, gz_acc=a_, **split)
            same(f"{tag}]", out, bwd_message(gg, y_, *graph, gz_acc=a_))
            same(f"{tag},again]", bwd_message(gg, y_, *graph, gz_acc=a_, **split), out)
            want_G, want_gz = bwd_message_plain(gg, y_, *graph, gz_acc=a_)
            check(f"{tag},G]", out[0], want_G, rtol, atol, errs)
            check(f"{tag},gz]", out[1], want_gz, rtol, atol, errs)
        tag = f"bwd_message[split,{name},unmasked"
        out = _transposed(gg, None, None, graph, table, with_gz=False)
        same(f"{tag}]", out, _transposed(gg, None, None, graph, None, with_gz=False))
        same(f"{tag},again]", _transposed(gg, None, None, graph, table, with_gz=False), out)
        check(f"{tag},G]", out[0], bwd_message_plain(gg, None, *graph)[0], rtol, atol, errs)

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

    # D with its lists: the launch over the split table, then B's row pass
    # over y1_rows and over y2_rows, the bits of two B launches on every row;
    # against the plain version held as the tiled check holds D
    rows = (b.y1_rows, b.y2_rows)
    H0z = H0.masked_fill(pad_rows[:, None], 0)  # as W_i leaves them without a bias
    y1, y2 = fused_iter2(H0z, W, None, *graph, b.split_ptr, rows)
    w1 = fused_iter(H0z, H0z, W, None, *graph, relu_stream=True)
    same("fused_iter2[split]", (y1, y2), (w1, fused_iter(w1, H0z, W, None, *graph)))
    same("fused_iter2[split,again]", fused_iter2(H0z, W, None, *graph, b.split_ptr, rows),
         (y1, y2))
    p1, p2 = fused_iter2_plain(H0z, W, None, *graph)
    check("fused_iter2[split,y1]", y1, p1, 2 * BF16_ULP, 0.02, errs)
    check("fused_iter2[split,y2]", y2, p2, 2 * BF16_ULP, 0.05, errs)
    # E with the cross rows: gz a masked copy, exact, and the bits of the
    # form without a table; G's sums as there, dH and dW in another order
    Hx = H0.clamp_min(0)  # an iteration's input: a ReLU output, padding rows not zero
    out = iter_bwd(gb, yb, Hx, W, *graph, tiles=b.split_ptr, cross=b.cross_rows)
    if not torch.equal(out[1], iter_bwd(gb, yb, Hx, W, *graph)[1]):
        fail("iter_bwd[split]: gz differs from the form without a table")
    if not all(torch.equal(x, w) for x, w in zip(
            iter_bwd(gb, yb, Hx, W, *graph, tiles=b.split_ptr, cross=b.cross_rows), out)):
        fail("iter_bwd[split]: two calls differ")
    want_dH, want_gz, want_dW = iter_bwd_plain(gb, yb, Hx, W, *graph)
    G_abs = bwd_message_plain(gb, yb, *graph)[0].float().abs()
    Hx_abs = Hx.float().masked_fill(pad_rows[:, None], 0)
    check("iter_bwd[split,gz]", out[1], want_gz, 0.0, 0.0, errs)
    check("iter_bwd[split,dH]", out[0], want_dH, 2 * BF16_ULP, 1e-4, errs,
          G_abs @ W.float().abs().t())
    check("iter_bwd[split,dW]", out[2], want_dW, 1e-4, 1e-3, errs, Hx_abs.t() @ G_abs)
    if out[0][pad_rows].any() or out[1][pad_rows].any():
        fail("iter_bwd[split]: a padding row is not zero")
    # a row's dH depends on its own row of G alone: a launch that takes no
    # cross row (an empty list: those rows NaN) gives every other row's bits,
    # and one whose list leaves a row out gives that row NaN, the others' bits
    listed = torch.zeros(n_e, dtype=torch.bool, device="cuda")
    listed[b.cross_rows.long()] = True
    for tag, rows, nan_rows in (("none", b.cross_rows[:0], listed),
                                ("one_left_out", b.cross_rows[1:], None)):
        if nan_rows is None:
            nan_rows = torch.zeros_like(listed)
            nan_rows[b.cross_rows[0].long()] = True
        dH = iter_bwd(gb, yb, Hx, W, *graph, tiles=b.split_ptr, cross=rows)[0]
        if not (torch.equal(dH.isnan().all(1), nan_rows) and torch.equal(dH.isnan().any(1),
                                                                             nan_rows)):
            fail(f"iter_bwd[split,{tag}]: the rows the launch cannot form are not NaN, whole")
        if not torch.equal(dH[~nan_rows], out[0][~nan_rows]):
            fail(f"iter_bwd[split,{tag}]: dH outside those rows differs")

    # the passes alone over their rows, the other rows NaN: those rows
    # against the plain versions, the others untouched; then timed
    cross, ids = b.cross_rows, (b.src.contiguous(), b.rev.contiguous(), b.edge_ptr.contiguous())
    bw, bf16_peak, f32_peak = peaks(card)
    times = {}
    for dt, rtol, atol in ((torch.float32, 1e-5, 1e-5), (torch.bfloat16, BF16_ULP, 1e-6)):
        name = str(dt).removeprefix("torch.")
        x, gg, yy = H32.to(dt), g32.to(dt), y32.to(dt)
        runs = {
            "message_rows": (lambda o: _message_rows(x, *ids, cross, o),
                             lambda o: message_rows_plain(x, *graph, cross, o),
                             message_rows_bytes(b, d, x.element_size()), x),
            "bwd_message_rows": (
                lambda o: _cross_rows(gg, yy, b.dst, b.rev, b.edge_ptr, cross, o),
                lambda o: bwd_message_rows_plain(gg, yy, *graph, cross, o),
                bwd_message_rows_bytes(b, d, gg.element_size()), gg),
        }
        for kernel, (run, plain, nbytes, like) in runs.items():
            out = torch.full_like(like, float("nan"))
            run(out)
            want = plain(torch.full_like(like, float("nan")))
            others = torch.ones(n_e, dtype=torch.bool, device="cuda")
            others[cross.long()] = False
            if not torch.isnan(out[others]).all():
                fail(f"{kernel}[{name}]: a row outside the cross rows was written")
            check(f"{kernel}[{name}]", out[cross.long()], want[cross.long()], rtol, atol, errs)
            adds = pass_adds(b, kernel) * d
            tb, to = nbytes / bw * 1e3, adds / f32_peak * 1e3
            ms = time_ms(lambda: run(out), reps)
            entry = dict(ms=ms, plain_ms=time_ms(lambda: plain(out), reps), library_ms=None,
                         bound_ms=max(tb, to), bound_by="bytes" if tb >= to else "operations",
                         share_of_bound=max(tb, to) / ms, shape=[cross.numel(), d], dtype=name,
                         device_ms=device_ms(lambda: run(out)))
            if dt == torch.float32:
                times[kernel] = entry
            else:
                times[kernel][name] = entry
    # D's pass over y2_rows from y1 (its second pass, the longer list), bf16
    # only: the listed rows bit-equal to B and against the plain version, the
    # others untouched
    y2_rows, r = b.y2_rows, b.y2_rows.long()
    run = lambda o: _fused_iter_rows(w1, H0z, W, None, *ids, y2_rows, o)  # noqa: E731
    plain = lambda o: fused_iter_rows_plain(w1, H0z, W, None, *graph, y2_rows, o)  # noqa: E731
    out = torch.full_like(yb, float("nan"))
    run(out)
    want = plain(torch.full_like(yb, float("nan")))
    others = torch.ones(n_e, dtype=torch.bool, device="cuda")
    others[r] = False
    if not torch.isnan(out[others]).all():
        fail("fused_iter_rows: a row outside its list was written")
    if not torch.equal(out[r], fused_iter(w1, H0z, W, None, *graph)[r]):
        fail("fused_iter_rows: its rows differ from B's")
    check("fused_iter_rows[y2]", out[r], want[r], 2 * BF16_ULP, 0.02, errs)
    tb, to = fused_iter_rows_bytes(b, d) / bw * 1e3, fused_iter_rows_ops(b, d) / bf16_peak * 1e3
    ms = time_ms(lambda: run(out), reps)
    times["fused_iter_rows"] = dict(
        ms=ms, plain_ms=time_ms(lambda: plain(out), reps), library_ms=None, bound_ms=max(tb, to),
        bound_by="bytes" if tb >= to else "operations", share_of_bound=max(tb, to) / ms,
        shape=[y2_rows.numel(), d], dtype="bfloat16", device_ms=device_ms(lambda: run(out)))
    # E's launch before its tile launch, bf16: G_c bit-equal to F's pass at
    # the cross rows (the same sums, rounded once) and within one bf16 ulp of
    # the plain version, the map right at every cross row; timed beside the
    # two library products that E's tile launch now does for those rows
    r = cross.long()
    Gc, slot = _iter_bwd_rows(gb, yb, b.dst, b.rev, b.edge_ptr, cross)
    G_f = torch.full_like(yb, float("nan"))
    _cross_rows(gb, yb, b.dst, b.rev, b.edge_ptr, cross, G_f)
    if not torch.equal(Gc, G_f[r]):
        fail("iter_bwd_rows: G_c differs from bwd_message_rows at the cross rows")
    if not torch.equal(slot[r], torch.arange(cross.numel(), dtype=torch.int32, device="cuda")):
        fail("iter_bwd_rows: the map does not give each cross row its slot in G_c")
    plain = lambda: iter_bwd_rows_plain(gb, yb, *graph, cross)  # noqa: E731
    check("iter_bwd_rows[G_c]", Gc, plain(), BF16_ULP, 1e-6, errs)
    run = lambda: _iter_bwd_rows(gb, yb, b.dst, b.rev, b.edge_ptr, cross)  # noqa: E731
    tb = iter_bwd_rows_bytes(b, d) / bw * 1e3
    to = pass_adds(b, "iter_bwd_rows") * d / f32_peak * 1e3
    Hr, Wt = Hx[r].contiguous(), W.t().contiguous()
    products = {"G_c W^T": lambda: torch.mm(Gc, Wt),
                "H[rows]^T G_c": lambda: torch.mm(Hr.t(), Gc, out_dtype=torch.float32)}
    ms = time_ms(run, reps)
    times["iter_bwd_rows"] = dict(
        ms=ms, plain_ms=time_ms(plain, reps), library_ms=None, bound_ms=max(tb, to),
        bound_by="bytes" if tb >= to else "operations", share_of_bound=max(tb, to) / ms,
        shape=[cross.numel(), d], dtype="bfloat16", device_ms=device_ms(run),
        library_products_ms={k: time_ms(f, reps) for k, f in products.items()},
        library_products_device_ms={k: device_ms(f) for k, f in products.items()})
    res = {"rows": n_e, "real_rows": int(b.edge_mask.sum()), "tiles": b.split_ptr.numel() - 1,
           "cross_rows": cross.numel(), "y1_rows": b.y1_rows.numel(),
           "y2_rows": b.y2_rows.numel(), "d": d, "times": times}
    print(json.dumps({"split_tables": res}))
    return res


def pass_rows(bmg, kernel: str, rows=None):
    """The rows a second pass reads for the batch's cross rows (or
    ``rows``): the in-edges of each listed row's source (A and D: they hold
    its reverse), or of its node (F and E: their reverses are read),
    distinct."""
    import torch

    rows = bmg.cross_rows if rows is None else rows
    by_src = kernel in ("message_rows", "fused_iter_rows")
    node = (bmg.src if by_src else bmg.dst).long()[rows.long()]
    need = torch.zeros(bmg.V.shape[0], dtype=torch.bool, device=node.device)
    need[node] = True
    return torch.nonzero(need[bmg.dst.long()]).squeeze(1)


def pass_adds(bmg, kernel: str) -> int:
    """The adds of a second pass per column: each listed row sums its in-edge
    range and subtracts one row."""
    ptr = bmg.edge_ptr.long()
    node = (bmg.src if kernel == "message_rows" else bmg.dst).long()[bmg.cross_rows.long()]
    return int((ptr[node + 1] - ptr[node] + 1).sum())


def message_rows_bytes(bmg, d: int, itemsize: int) -> int:
    """The bytes A's second pass (``message_rows``) must move over the batch's
    cross rows at width ``d``: the ``H`` rows it sums (the in-edges of the
    listed rows' sources, which hold their reverses) read once, each listed
    row written, and per listed row its entry of the list, its ``src`` and
    ``rev`` and the two ``ptr`` entries of its source."""
    n = bmg.cross_rows.numel()
    return (pass_rows(bmg, "message_rows").numel() + n) * d * itemsize + 4 * 5 * n


def fused_iter_rows_bytes(bmg, d: int) -> int:
    """The bytes D's row pass (``fused_iter_rows``) must move over the
    batch's ``y2_rows`` at width ``d`` in bf16: the ``H`` rows it sums (the
    in-edges of the listed rows' sources) read once, each listed row's
    ``H0`` read and ``y`` written, ``W`` once, and per listed row its entry of
    the list, its ``src`` and ``rev`` and the two ``ptr`` entries of its
    source."""
    n = bmg.y2_rows.numel()
    k = pass_rows(bmg, "fused_iter_rows", bmg.y2_rows).numel()
    return (k + 2 * n) * d * 2 + d * d * 2 + 4 * 5 * n


def fused_iter_rows_ops(bmg, d: int) -> int:
    """The operations of D's row pass over ``y2_rows``: the product of each
    listed row's message with W, 2 d^2 a row (the sums are far fewer)."""
    return 2 * bmg.y2_rows.numel() * d * d


def iter_bwd_rows_bytes(bmg, d: int) -> int:
    """The bytes E's launch before its tile launch (``iter_bwd_rows``) must
    move over the batch's cross rows at width ``d`` in bf16: ``g`` and ``y``
    at the reverses of the in-edges of the listed rows' nodes read once,
    ``G_c`` written (a row per listed row) and the map's entry of each listed
    row, per listed row its entry of the list, its ``dst`` and the two
    ``ptr`` entries of its node, and the ``rev`` of each in-edge."""
    n, k = bmg.cross_rows.numel(), pass_rows(bmg, "iter_bwd_rows").numel()
    return (2 * k + n) * d * 2 + 4 * n + 4 * 4 * n + 4 * k


def bwd_message_rows_bytes(bmg, d: int, itemsize: int, masked: bool = True) -> int:
    """The bytes F's second pass (``bwd_message_rows``) must move over the
    batch's cross rows at width ``d``: ``g`` (and ``y`` with the mask) at the
    reverses of the in-edges of the listed rows' nodes read once, each
    listed row of ``G`` written, per listed row its entry of the list, its
    ``dst`` and the two ``ptr`` entries of its node, and the ``rev`` of each
    in-edge read."""
    n, k = bmg.cross_rows.numel(), pass_rows(bmg, "bwd_message_rows").numel()
    return (k * (1 + int(masked)) + n) * d * itemsize + 4 * 4 * n + 4 * k


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
        unserved = unserved_since(before)
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


def cli_train(out: Path, dtype: str, device: str | None, epochs: int,
              members: int = 2, extra: tuple = (), batch_norm: bool = True) -> list[list[dict]]:
    """Phase 9(a): ``python -m chemprop_tpu_torch.cli train`` in this process
    on mol.csv at full width (batch norm, a scaffold-balanced split, an
    ensemble of ``members``; the mean readout of the reference checkpoint,
    whose bf16 backward is kernel I, where the default norm readout's is an
    indexing); each member's history."""
    from chemprop_tpu_torch.cli.main import main

    argv = ["-q", "train", "-i", str(MOL_CSV), "-o", str(out), "--split",
            "scaffold_balanced", "--ensemble-size", str(members), "--epochs", str(epochs),
            "--aggregation", "mean", "--dtype", dtype, *(["--batch-norm"] if batch_norm else []),
            *extra]
    if main(argv + (["--device", device] if device else [])) != 0:
        fail(f"train --dtype {dtype} on {device or 'cuda'} returned non-zero")
    dirs = [out / f"model_{m}" for m in range(members)] if members > 1 else [out]
    return [json.loads((d / "history.json").read_text()) for d in dirs]


def param_drift(path: Path, ref: Path, taus: dict) -> dict:
    """For each parameter tensor of two ``CPTPU001`` files, its size, the
    largest difference and, for each name of ``taus``, how many elements
    differ by more than that absolute limit."""
    import numpy as np

    from chemprop_tpu_torch.models import serialize

    out = {}

    def walk(a, b, key):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{key}/{k}" if key else k)
            return
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = np.abs(a - b)
        out[key] = {"n": int(err.size), "max": float(err.max()),
                    **{name: int((err > tau).sum()) for name, tau in taus.items()}}

    walk(serialize.read_checkpoint(path)[1]["params"], serialize.read_checkpoint(ref)[1]["params"],
         "")
    return out


def first_epoch_params(card: Path, cpu: Path, exempt: tuple = ()) -> dict:
    """The parameters after ``train``'s first epoch (two Adam steps, rates
    ``CLI_FIRST_LRS``) on the card against the CPU's: each tensor's share of
    elements that moved apart by more than ``CLI_PARAM_TAU``, which must stay
    within ``CLI_PARAM_SHARE``. Adam's first steps move an element by about
    its rate whatever the gradient's size, in the sign of the gradient, so a
    backward that is wrong or zero parts many elements of the tensors behind
    it, where the loss of two steps moves little. The tensors of ``exempt``,
    whose gradient is zero by construction (rounding noise, whose sign
    Adam's step takes), are reported and not held."""
    drift = param_drift(card, cpu, {"off": CLI_PARAM_TAU})
    shares = {k: v["off"] / v["n"] for k, v in drift.items() if k not in exempt}
    worst = max(shares, key=shares.get)
    return {"tau": CLI_PARAM_TAU, "share_limit": CLI_PARAM_SHARE, "worst": worst,
            "worst_share": shares[worst], "shares": shares,
            "max_diff": max(v["max"] for v in drift.values()),
            **({"exempt": {k: drift[k] for k in exempt}} if exempt else {})}


def cli_train_phase(out_dir: Path) -> tuple[dict, dict]:
    """Phase 9(a): ``train`` on the card in f32 and bf16, each run's launches
    counted on their own; the first epoch's loss against the same command on
    the CPU, and a one-epoch run's parameters against the CPU's
    (``first_epoch_params``); bf16's last epoch below its bar; every
    artefact; each ``best.ckpt`` through ``predict`` on the card against its
    ``test_predictions.csv``. The phase's unserved calls are read as a
    difference: ``ops.UNSERVED`` keeps every main path's for the final
    gate."""
    import shutil

    import numpy as np

    from chemprop_tpu_torch.cli.main import main
    from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED

    launches, res = {}, {}
    for dt in ("float32", "bfloat16"):
        out = out_dir / f"train_{dt}"
        shutil.rmtree(out, ignore_errors=True)
        LAUNCHES.clear()
        before = dict(UNSERVED)
        card = cli_train(out, dt, None, CLI_TRAIN_EPOCHS)
        launches[f"train_cli_{dt}"] = dict(LAUNCHES)
        check_path_launches(f"train_cli_{dt}", launches[f"train_cli_{dt}"], exact=False)
        unserved = unserved_since(before)
        if unserved:
            fail(f"train --dtype {dt} left calls unserved: {unserved}")
        # the first member's first epoch does not depend on --epochs (its
        # steps are all in the warm-up) nor on the ensemble's size (the
        # members share the loader, so the second one's epochs do)
        cpu = cli_train(out_dir / f"train_{dt}_cpu", dt, "cpu", 1, members=1)
        cli_train(out_dir / f"train_{dt}_one", dt, None, 1, members=1)
        params = first_epoch_params(out_dir / f"train_{dt}_one/best.ckpt",
                                    out_dir / f"train_{dt}_cpu/best.ckpt")
        r = {"train_loss_first": card[0][0]["train_loss"],
             "train_loss_first_cpu": cpu[0][0]["train_loss"],
             "train_loss_last": [h[-1]["train_loss"] for h in card],
             "val_loss_last": [h[-1]["val_loss"] for h in card],
             "edges_per_s_last": [h[-1]["edges_per_s"] for h in card]}
        # f32: summation order only. bf16: the card's kernels and the CPU's
        # plain versions sum in f32 and round once, so a value may land on the
        # neighbouring bf16 number; phase 3 holds such predictions to atol 1e-3
        # (a loss near 1 moves by about twice that relative to itself), and
        # phase 8's bf16 fits' first epochs came within 7e-4 of the CPU's
        rtol = 1e-4 if dt == "float32" else 1e-3
        r["rtol"] = rtol
        if not np.isclose(r["train_loss_first"], r["train_loss_first_cpu"], rtol=rtol, atol=0):
            fail(f"train --dtype {dt}: the first epoch's loss on cuda disagrees with the CPU's: "
                 f"{r}")
        r["first_epoch_params"] = {k: v for k, v in params.items() if k != "shares"}
        if not params["worst_share"] <= params["share_limit"]:
            fail(f"train --dtype {dt}: after the first epoch {params['worst']} on cuda parts from "
                 f"the CPU's in {params['worst_share']} of its elements: {params}")
        if dt == "bfloat16" and max(r["train_loss_last"]) > CLI_TRAIN_BF16_BAR:
            fail(f"train --dtype bfloat16: last epoch's loss above {CLI_TRAIN_BF16_BAR}: {r}")
        for name in ("config.json", "splits.json", "test_scores.json"):
            if not (out / name).is_file():
                fail(f"train --dtype {dt} wrote no {name}")
        r["predict_vs_test_predictions"] = []
        for m in range(2):
            d = out / f"model_{m}"
            for name in ("best.ckpt", "history.json", "test_predictions.csv",
                         "checkpoints/best.ckpt", "checkpoints/last.ckpt"):
                if not (d / name).is_file():
                    fail(f"train --dtype {dt} wrote no model_{m}/{name}")
            with open(d / "test_predictions.csv", newline="") as f:
                rows = list(csv.reader(f))
            smis, want = [row[0] for row in rows[1:]], np.array([float(row[1]) for row in rows[1:]])
            with open(d / "test.csv", "w", newline="") as f:
                csv.writer(f).writerows([["smiles"]] + [[smi] for smi in smis])
            LAUNCHES.clear()
            argv = ["-q", "predict", "--model-path", str(d / "best.ckpt"), "-i", str(d / "test.csv"),
                    "-o", str(d / "predict.csv"), "--dtype", dt]
            if main(argv) != 0:
                fail(f"predict of train --dtype {dt}'s model_{m}/best.ckpt returned non-zero")
            check_path_launches(f"predict_{dt}", dict(LAUNCHES), exact=False)
            with open(d / "predict.csv", newline="") as f:
                got = np.array([float(row[1]) for row in list(csv.reader(f))[1:]])
            r["predict_vs_test_predictions"].append(float(np.abs(got - want).max()))
            # phase 3's limits on one device: the same model, the same batch
            tol = dict(rtol=1e-5, atol=1e-4) if dt == "float32" else dict(rtol=0, atol=1e-3)
            if not (np.isfinite(got).all() and np.allclose(got, want, **tol)):
                fail(f"predict of train --dtype {dt}'s model_{m}/best.ckpt disagrees with its "
                     f"test_predictions.csv")
        res[dt] = r
    print(json.dumps({"cli_train": res}))
    return launches, res


def post(port: int, path: str, body=None) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_burst(model_path: Path, dtype: str, card: str, out_dir: Path) -> tuple[dict, dict]:
    """Phase 9(b): ``make_server`` on port 0 in a thread over ``model_path``,
    a burst of SERVE_CLIENTS concurrent clients, each with 4-8 SMILES of
    mol.csv and one invalid SMILES; every row against ``predict`` of the same
    checkpoint on the card at phase 3's limits, the invalid rows null with
    their errors, fewer dispatches than requests, 413 over ``--max-batch``,
    and each dispatch's launches."""
    import threading

    import numpy as np

    from chemprop_tpu_torch.cli.main import construct_parser, main
    from chemprop_tpu_torch.cli.serve import make_server
    from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED

    with open(MOL_CSV, newline="") as f:
        smis = [row[0] for row in list(csv.reader(f))[1:]]
    ref = out_dir / f"serve_{dtype}_predict.csv"
    argv = ["-q", "predict", "--model-path", str(model_path), "-i", str(MOL_CSV), "-o", str(ref),
            "--dtype", dtype]
    if main(argv) != 0:
        fail(f"predict of {model_path.name} returned non-zero")
    with open(ref, newline="") as f:
        want = {row[0]: float(row[1]) for row in list(csv.reader(f))[1:]}
    args = construct_parser().parse_args(["serve", "--model-paths", str(model_path), "--port", "0",
                                          "--dtype", dtype])
    server, service = make_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    rng = np.random.default_rng(SERVE_SEED)
    bodies = [[smis[i] for i in rng.choice(len(smis), int(rng.integers(4, 9)), replace=False)]
              for _ in range(SERVE_CLIENTS)]
    for body in bodies:
        body.insert(int(rng.integers(0, len(body) + 1)), "C1CC")  # an unclosed ring
    results, latency = [None] * SERVE_CLIENTS, [0.0] * SERVE_CLIENTS
    barrier = threading.Barrier(SERVE_CLIENTS)

    def client(i):
        barrier.wait()
        t = time.perf_counter()
        results[i] = post(port, "/predict", {"smiles": bodies[i]})
        latency[i] = time.perf_counter() - t

    try:
        _, before = post(port, "/health")
        LAUNCHES.clear()
        unserved_before = dict(UNSERVED)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        run = dict(LAUNCHES)
        _, after = post(port, "/health")
        too_big = post(port, "/predict", {"smiles": smis[:1] * (args.max_batch + 1)})[0]
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join()
    requests = after["requests"] - before["requests"]
    dispatches = after["dispatches"] - before["dispatches"]
    ms = sorted(1e3 * x for x in latency)
    res = {"checkpoint": model_path.name, "dtype": dtype, "clients": SERVE_CLIENTS,
           "requests": requests, "dispatches": dispatches, "launches": run,
           "requests_per_s": SERVE_CLIENTS / wall, "wall_s": wall,
           "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
           "max_ms": ms[-1], "card": card, "status_over_max_batch": too_big}
    errs = []
    for (status, out), body in zip(results, bodies):
        if status != 200 or len(out["preds"]) != len(body):
            fail(f"serve {model_path.name}: a request failed: {status} {out}")
        bad = [i for i, s in enumerate(body) if s == "C1CC"]
        if [i for i, p in enumerate(out["preds"]) if p is None] != bad or sorted(
                map(int, out.get("errors", {}))) != bad:
            fail(f"serve {model_path.name}: the invalid rows are not null with their errors")
        errs += [abs(p[0] - want[s]) for p, s in zip(out["preds"], body) if p is not None]
    res["max_abs_err_vs_predict"] = max(errs)
    print(json.dumps({"serve": res}))
    # phase 3's limits: another batch composition changes only the products'
    # summation order (f32) or the odd bf16 rounding
    tol = (1e-4 + 1e-5 * max(abs(v) for v in want.values()) if dtype == "float32" else 1e-3)
    if max(errs) > tol:
        fail(f"serve {model_path.name}: rows disagree with predict's (max {max(errs)})")
    if requests != SERVE_CLIENTS or not 1 <= dispatches < requests:
        fail(f"serve {model_path.name}: {requests} requests in {dispatches} dispatches")
    if too_big != 413:
        fail(f"serve {model_path.name}: a request over --max-batch got {too_big}")
    unserved = unserved_since(unserved_before)
    if unserved:
        fail(f"serve {model_path.name} left calls unserved: {unserved}")
    # each dispatch launches one forward's kernels (depth 3: two iterations,
    # the M_v and the mean readout)
    per = PATH_KERNELS[f"predict_{dtype}"]
    if {k: v for k, v in run.items() if v} != {k: v * dispatches for k, v in per.items()}:
        fail(f"serve {model_path.name}: {run} launched in {dispatches} dispatches")
    return run, res


def cli_phase(out_dir: Path, card: str) -> tuple[dict, dict]:
    """Phase 9: the ``train`` and ``serve`` entry points on the card."""
    t0 = time.time()
    out_dir.mkdir(parents=True, exist_ok=True)
    launches, res = cli_train_phase(out_dir)
    res["serve"] = {}
    for key, path, dt in (("bfloat16_best_ckpt", out_dir / "train_bfloat16/model_0/best.ckpt",
                           "bfloat16"), ("float32_reference_pt", CKPT, "float32")):
        launches[f"serve_{key}"], res["serve"][key] = serve_burst(path, dt, card, out_dir)
    res["seconds"] = time.time() - t0
    print(json.dumps({"phase": "cli", "seconds": res["seconds"]}))
    return launches, res


def read_rows(path: Path) -> tuple[list[str], list[list[str]]]:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def predict_table(path: Path):
    """(header, names, values ``[n, k]``, labels ``[n, t]`` or None) of an
    output CSV: every numeric cell, the comma-joined ones spread out, a
    multiclass head's class labels apart."""
    import numpy as np

    header, rows = read_rows(path)
    label_cols = [i for i, h in enumerate(header) if f"{h}_prob" in header]
    values = np.array([[float(x) for i, cell in enumerate(r)
                        if i and i not in label_cols for x in cell.split(",")] for r in rows])
    labels = np.array([[int(r[i]) for i in label_cols] for r in rows]) if label_cols else None
    return header, [r[0] for r in rows], values, labels


def run_cli(sub: str, flags: list, out: Path, device: str | None) -> Path:
    """One subcommand of the port's command line in this process, so that its
    launches count; ``device`` None is the default, the card."""
    from chemprop_tpu_torch.cli.main import main

    argv = ["-q", sub, "-o", str(out), *map(str, flags)]
    if main(argv + (["--device", device] if device else [])) != 0:
        fail(f"{sub} {flags} on {device or 'cuda'} returned non-zero")
    return out


def path_launches(forward_path: str, forwards: int, step_path: str | None = None,
                  steps: int = 0) -> dict:
    """The launches of ``forwards`` forwards and ``steps`` training steps."""
    want: dict = {}
    for path, n in ((forward_path, forwards), (step_path, steps)):
        for name, k in PATH_KERNELS.get(path, {}).items():
            want[name] = want.get(name, 0) + k * n
    return want


def batches(n_rows: int) -> int:
    return -(-n_rows // PREDICT_BATCH)


def card_and_cpu(tag: str, sub: str, flags: list, out_dir: Path, forward_path: str,
                 forwards: int, launches: dict):
    """``sub`` on the card, its launches exactly ``forwards`` forwards', then
    on the CPU: the two output paths."""
    from chemprop_tpu_torch.ops import LAUNCHES

    LAUNCHES.clear()
    card = run_cli(sub, flags, out_dir / f"{tag}.cuda.csv", None)
    launches[f"{sub}_{tag}"] = dict(LAUNCHES)
    check_path_launches(forward_path, launches[f"{sub}_{tag}"], exact=True,
                        want=path_launches(forward_path, forwards))
    cpu = run_cli(sub, flags, out_dir / f"{tag}.cpu.csv", "cpu")
    return card, cpu


def hold_to_cpu(tag: str, card: Path, cpu: Path, rtol: float, atol: float,
                fitted: tuple = ()) -> float:
    """Fail unless two output CSVs have one header and one name column, their
    values agree within ``rtol`` / ``atol`` and their class labels agree
    where the CPU's two best classes are further apart than twice the
    limit; the largest difference. The value columns ``fitted`` (a
    calibrator's output) may first differ by one factor each, within
    ``FITTED_SCALE_RTOL`` of 1."""
    import numpy as np

    (ch, cn, cv, cl), (ph, pn, pv, pl) = predict_table(card), predict_table(cpu)
    if ch != ph or cn != pn or cv.shape != pv.shape or not np.isfinite(cv).all():
        fail(f"predict {tag}: the card's columns, names or shape differ from the CPU's")
    for j in fitted:
        scale = float(np.median(pv[:, j] / cv[:, j]))
        print(json.dumps({"fitted_scale_cpu_over_card": {tag: scale}}))
        if not abs(scale - 1) <= FITTED_SCALE_RTOL:
            fail(f"predict {tag}: the card's fitted scale is {scale} of the CPU's")
        cv[:, j] *= scale
    if not np.allclose(cv, pv, rtol=rtol, atol=atol):
        fail(f"predict {tag}: the card's values disagree with the CPU's "
             f"(largest difference {float(np.abs(cv - pv).max())})")
    if cl is not None:
        _, rows = read_rows(cpu)
        probs = [[[float(x) for x in r[i].split(",")] for i, h in enumerate(ph)
                  if h.endswith("_prob")] for r in rows]
        top2 = np.sort(np.array(probs), axis=-1)[..., -2:]
        decided = top2[..., 1] - top2[..., 0] > 2 * atol
        if not np.array_equal(cl[decided], pl[decided]):
            fail(f"predict {tag}: the card's class labels disagree with the CPU's")
    return float(np.abs(cv - pv).max())


def write_rows(path: Path, src: Path, rows: slice) -> Path:
    header, body = read_rows(src)
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows([header] + body[rows])
    return path


def predict_v1(out_dir: Path, launches: dict) -> dict:
    """Phase 10(a): the v1 file through ``predict`` in f32 and bf16 (its
    featurizer mode found by ``predict``)."""
    import numpy as np

    with open(V1_GOLDEN, newline="") as f:
        golden = np.array([float(r["logSolubility"]) for r in csv.DictReader(f)])
    out = {}
    for dt in ("float32", "bfloat16"):
        flags = ["--model-paths", V1_CKPT, "-i", V1_GOLDEN, "--dtype", dt]
        card, cpu = card_and_cpu(f"v1_{dt}", "predict", flags, out_dir, f"predict_{dt}",
                                 batches(len(golden)), launches)
        out[dt] = [predict_table(p) for p in (card, cpu)]
        if out[dt][0][0] != ["name", "logSolubility"] or len(out[dt][0][1]) != len(golden):
            fail(f"predict of the v1 file in {dt}: unexpected CSV {out[dt][0][0]}")
    (_, _, f32, _), (_, _, f32_cpu, _) = out["float32"]
    (_, _, bf16, _), (_, _, bf16_cpu, _) = out["bfloat16"]
    res = {"f32_vs_cpu_f32": float(np.abs(f32 - f32_cpu).max()),
           "f32_vs_golden": float(np.abs(f32[:, 0] - golden).max()),
           "bf16_vs_cpu_bf16": float(np.abs(bf16 - bf16_cpu).max()),
           "bf16_vs_cpu_f32": float(np.abs(bf16 - f32_cpu).max())}
    # phase 3's limits; the golden at the JAX package's 1e-5 widened to 1e-4
    # for the card's summation order
    if not np.allclose(f32, f32_cpu, rtol=1e-5, atol=1e-4):
        fail(f"the v1 file's float32 predictions on cuda disagree with the CPU's: {res}")
    if not np.allclose(f32[:, 0], golden, rtol=0, atol=1e-4):
        fail(f"the v1 file's float32 predictions on cuda leave its golden: {res}")
    if not np.allclose(bf16, bf16_cpu, rtol=0, atol=1e-3):
        fail(f"the v1 file's bfloat16 predictions on cuda disagree with the CPU's: {res}")
    if not np.allclose(bf16, f32_cpu, rtol=0.05, atol=0.1):
        fail(f"the v1 file's bfloat16 predictions leave the float32 envelope: {res}")
    return res


def predict_converted(out_dir: Path, mol_head: Path, launches: dict) -> dict:
    """Phase 10(b): ``convert`` of the v1 and the v2 file; ``predict`` on the
    card of each output gives its source's CSV byte for byte."""
    from chemprop_tpu_torch.ops import LAUNCHES

    res = {}
    for name, src in (("v1", V1_CKPT), ("v2", CKPT)):
        conv = run_cli("convert", ["-i", src], out_dir / f"{name}.tpu.ckpt", None)
        texts = []
        for tag, model in (("source", src), ("converted", conv)):
            LAUNCHES.clear()
            out = run_cli("predict", ["--model-paths", model, "-i", mol_head],
                          out_dir / f"{name}_{tag}.cuda.csv", None)
            launches[f"predict_{name}_{tag}"] = dict(LAUNCHES)
            check_path_launches("predict_float32", dict(LAUNCHES), exact=True,
                                want=path_launches("predict_float32", batches(PREDICT_ROWS)))
            texts.append(out.read_text())
        res[name] = texts[0] == texts[1]
        if not res[name]:
            fail(f"predict of the converted {name} file differs from its source's")
    return res


def predict_uncertainty(out_dir: Path, mol_head: Path, mol_tail: Path, member: Path,
                        launches: dict) -> dict:
    """Phase 10(c): an ensemble of the reference checkpoint and phase 9's
    first f32 member with ``zscaling`` calibration, then the MVE,
    evidential, binary (``isotonic`` calibration) and multiclass Dirichlet
    checkpoints with their methods, each against the CPU at phase 3's
    f32 limits. Tox21's first 100 rows are the binary head's inputs and
    calibration set (none holds a molecule of more than 128 directed edges,
    so every batch has its tile table)."""
    tox_head = write_rows(out_dir / "tox21_head.csv", TOX21_CSV, slice(0, PREDICT_ROWS))
    tox_tail = write_rows(out_dir / "tox21_tail.csv", TOX21_CSV,
                          slice(PREDICT_ROWS, 2 * PREDICT_ROWS))
    data = REPO / "tests/data"
    cases = {
        "ensemble_zscaling": ([CKPT, member], mol_head,
                              ["--uncertainty-method", "ensemble", "--calibration-method",
                               "zscaling", "--cal-path", mol_tail]),
        "mve": ([data / "example_model_v2_regression_mve_mol.pt"], mol_head,
                ["--uncertainty-method", "mve"]),
        "evidential_total": ([data / "example_model_v2_regression_evidential_mol.pt"], mol_head,
                             ["--uncertainty-method", "evidential-total"]),
        "binary_isotonic": ([data / "example_model_v2_classification_mol.pt"], tox_head,
                            ["--uncertainty-method", "classification", "--calibration-method",
                             "isotonic", "--cal-path", tox_tail]),
        "multiclass_dirichlet": ([data / "example_model_v2_multiclass_dirichlet_mol.pt"],
                                 mol_head, ["--uncertainty-method", "multiclass-dirichlet"]),
    }
    # the value column of the ensemble's calibrated variance: zscaling's one
    # factor is a Nelder-Mead fit, which inputs that differ in their last bits
    # may end elsewhere within its tolerance
    fitted = {"ensemble_zscaling": (1,)}
    res = {}
    for tag, (models, inputs, flags) in cases.items():
        calibrated = "--cal-path" in flags
        forwards = len(models) * batches(PREDICT_ROWS) * (2 if calibrated else 1)
        card, cpu = card_and_cpu(tag, "predict", ["--model-paths", *models, "-i", inputs, *flags],
                                 out_dir, "predict_float32", forwards, launches)
        if not any(h.endswith("_unc") for h in read_rows(card)[0]):
            fail(f"predict {tag} wrote no uncertainty column")
        res[tag] = hold_to_cpu(tag, card, cpu, rtol=1e-5, atol=1e-4,
                               fitted=fitted.get(tag, ()))
    return res


def predict_mc_dropout(out_dir: Path, mol_head: Path, launches: dict) -> dict:
    """Phase 10(d): ``--uncertainty-method dropout`` in bf16 on the card
    against the CPU. The two devices' generators give other streams, so the
    masks are drawn on the CPU from one seed and copied, as phase 5b does."""
    import torch

    from chemprop_tpu_torch.nn import utils as nn_utils
    from chemprop_tpu_torch.ops import LAUNCHES

    flags = ["--model-paths", CKPT, "-i", mol_head, "--uncertainty-method", "dropout",
             "--dropout-sampling-size", MC_SAMPLES, "--dtype", "bfloat16"]
    draw, masks = nn_utils.dropout_mask, []
    cpu_gen = torch.Generator().manual_seed(7)

    def record(shape, rate, generator, device):
        masks.append(draw(shape, rate, cpu_gen, torch.device("cpu")))
        return masks[-1]

    try:
        nn_utils.dropout_mask = record
        cpu = run_cli("predict", flags, out_dir / "mc_dropout.cpu.csv", "cpu")
        replay = list(masks)
        nn_utils.dropout_mask = lambda shape, rate, generator, dev: replay.pop(0).to(dev)
        LAUNCHES.clear()
        card = run_cli("predict", flags, out_dir / "mc_dropout.cuda.csv", None)
    finally:
        nn_utils.dropout_mask = draw
    launches["predict_mc_dropout_bfloat16"] = dict(LAUNCHES)
    forwards = MC_SAMPLES * batches(PREDICT_ROWS)
    check_path_launches("predict_bfloat16", dict(LAUNCHES), exact=True,
                        want=path_launches("predict_bfloat16", forwards))
    # two iterations, the node table and the head's hidden layer per forward
    if len(masks) != 4 * forwards or replay:
        fail(f"MC dropout drew {len(masks)} masks on the CPU, {len(replay)} left on the card")
    _, _, values, _ = predict_table(card)
    if not (values[:, 1] > 0).all():
        fail("MC dropout on the card: a row without spread")
    # phase 3's bf16 limit for the mean; the variance of the samples moves by
    # about twice their spread times that
    return {"masks": len(masks), "max_diff": hold_to_cpu("mc_dropout", card, cpu, 0, 1e-3)}


def foundation_train(out_dir: Path, launches: dict) -> dict:
    """Phase 10(f): one epoch of ``train --from-foundation`` the v2 file in f32
    and bf16 on the card against the CPU, as phase 9(a) holds ``train``: the
    epoch's loss, and each parameter tensor's share of elements apart by more
    than ``CLI_PARAM_TAU``; the launches exactly the run's steps and
    forwards (validation each epoch, the test set once)."""
    import shutil

    import numpy as np

    from chemprop_tpu_torch.ops import LAUNCHES

    res = {}
    for dt in ("float32", "bfloat16"):
        card_dir, cpu_dir = out_dir / f"foundation_{dt}", out_dir / f"foundation_{dt}_cpu"
        for d in (card_dir, cpu_dir):
            shutil.rmtree(d, ignore_errors=True)
        extra = ("--from-foundation", str(CKPT))
        LAUNCHES.clear()
        card = cli_train(card_dir, dt, None, 1, members=1, extra=extra)
        launches[f"train_foundation_{dt}"] = dict(LAUNCHES)
        split = json.loads((card_dir / "splits.json").read_text())[0]
        steps = batches(len(split["train"]))
        forwards = batches(len(split["val"])) + batches(len(split["test"]))
        check_path_launches(f"train_cli_{dt}", dict(LAUNCHES), exact=True,
                            want=path_launches(f"predict_{dt}", forwards, f"train_cli_{dt}",
                                               steps))
        cpu = cli_train(cpu_dir, dt, "cpu", 1, members=1, extra=extra)
        params = first_epoch_params(card_dir / "best.ckpt", cpu_dir / "best.ckpt")
        r = {"train_loss": card[0][0]["train_loss"], "train_loss_cpu": cpu[0][0]["train_loss"],
             "steps": steps, "forwards": forwards,
             "first_epoch_params": {k: v for k, v in params.items() if k != "shares"}}
        rtol = 1e-4 if dt == "float32" else 1e-3  # phase 9(a)'s limits
        if not np.isclose(r["train_loss"], r["train_loss_cpu"], rtol=rtol, atol=0):
            fail(f"train --from-foundation --dtype {dt}: the epoch's loss on cuda disagrees "
                 f"with the CPU's: {r}")
        if not params["worst_share"] <= params["share_limit"]:
            fail(f"train --from-foundation --dtype {dt}: {params['worst']} on cuda parts from "
                 f"the CPU's in {params['worst_share']} of its elements")
        res[dt] = r
    return res


def predict_phase(out_dir: Path, card: str, cli_dir: Path) -> tuple[dict, dict]:
    """Phase 10: the prediction side of the command line on the card (a)-(f);
    the phase's unserved calls are read as a difference."""
    import numpy as np

    from chemprop_tpu_torch.ops import UNSERVED

    t0 = time.time()
    out_dir.mkdir(parents=True, exist_ok=True)
    before = dict(UNSERVED)
    launches, res = {}, {}
    mol_head = write_rows(out_dir / "mol_head.csv", MOL_CSV, slice(0, PREDICT_ROWS))
    mol_tail = write_rows(out_dir / "mol_tail.csv", MOL_CSV, slice(PREDICT_ROWS, None))
    res["v1"] = predict_v1(out_dir, launches)
    res["convert"] = predict_converted(out_dir, mol_head, launches)
    res["uncertainty"] = predict_uncertainty(out_dir, mol_head, mol_tail,
                                             cli_dir / "train_float32/model_0", launches)
    res["mc_dropout"] = predict_mc_dropout(out_dir, mol_head, launches)
    card_fp, cpu_fp = card_and_cpu("v2", "fingerprint",
                                   ["--model-paths", CKPT, "-i", mol_head], out_dir,
                                   "predict_float32", batches(PREDICT_ROWS), launches)
    (fh, _, fv, _), (ph, _, pv, _) = predict_table(card_fp), predict_table(cpu_fp)
    res["fingerprint"] = {"shape": list(fv.shape), "max_diff": float(np.abs(fv - pv).max())}
    if fh != ph or fv.shape != (PREDICT_ROWS, 300) or not np.allclose(fv, pv, rtol=1e-5,
                                                                       atol=1e-4):
        fail(f"fingerprint on cuda disagrees with the CPU's: {res['fingerprint']}")
    res["foundation"] = foundation_train(out_dir, launches)
    unserved = unserved_since(before)
    if unserved:
        fail(f"phase 10 left calls unserved: {unserved}")
    res["seconds"] = time.time() - t0
    print(json.dumps({"predict_phase": res}))
    print(json.dumps({"phase": "predict", "seconds": res["seconds"], "card": card}))
    return launches, res


class rehearsal:
    """``with rehearsal() as counts:`` a run on the CPU that counts, in
    ``counts``, the launches the same run makes on the card: a wrapper takes
    its kernel's plain version on a CPU tensor where it launches the kernel
    on a CUDA one, so every call of a plain version that is not inside
    another is one launch of that kernel (``PLAIN_VERSIONS``). ``ops.LAUNCHES``
    is not touched."""

    def __enter__(self):
        import collections
        import importlib

        self.counts, self.saved, depth = collections.Counter(), [], [0]
        for module_name, names in PLAIN_VERSIONS.items():
            module = importlib.import_module(f"chemprop_tpu_torch.ops.{module_name}")
            for attr, kernel in names.items():
                fn = getattr(module, attr)

                def counted(*a, _fn=fn, _kernel=kernel, **k):
                    if depth[0] == 0:
                        self.counts[_kernel] += 1
                    depth[0] += 1
                    try:
                        return _fn(*a, **k)
                    finally:
                        depth[0] -= 1

                self.saved.append((module, attr, fn))
                setattr(module, attr, counted)
        return self.counts

    def __exit__(self, *exc):
        for module, attr, fn in self.saved:
            setattr(module, attr, fn)
        return False


def card_after_rehearsal(tag: str, run, launches: dict):
    """``run(device)`` on the CPU under a rehearsal, then on the card, whose
    launches must be exactly the rehearsal's: the two results."""
    from chemprop_tpu_torch.ops import LAUNCHES

    with rehearsal() as want:
        cpu = run("cpu")
    LAUNCHES.clear()
    card = run(None)
    launches[tag] = dict(LAUNCHES)
    check_path_launches(tag, launches[tag], exact=True, want=dict(want))
    if not launches[tag]:
        fail(f"{tag} launched no kernel on the card")
    return card, cpu


def architecture_runs(out_dir: Path, launches: dict) -> dict:
    """Phase 11(a)(b): ``train`` with ``--atom-messages``, with ``--aggregation
    attentive`` and with both, one epoch in f32 and bf16 on the card against
    the same run on the CPU as phase 9(a) holds ``train`` (the epoch's loss,
    each parameter tensor's share of elements apart), then ``predict`` of
    the card's ``best.ckpt`` on the card against its ``test_predictions.csv``
    and against the same ``predict`` on the CPU at phase 3's limits."""
    import shutil

    import numpy as np

    from chemprop_tpu_torch.models import serialize

    res = {}
    for arch, flags in ARCHITECTURES.items():
        for dt in ("float32", "bfloat16"):
            tag = f"{arch}_{dt}"
            dirs = {"cuda": out_dir / tag, "cpu": out_dir / f"{tag}_cpu"}
            for d in dirs.values():
                shutil.rmtree(d, ignore_errors=True)
            card, cpu = card_after_rehearsal(
                f"train_{tag}",
                lambda dev: cli_train(dirs[dev or "cuda"], dt, dev, 1, members=1, extra=flags,
                                      batch_norm=False),
                launches)
            manifest = serialize.read_checkpoint(dirs["cuda"] / "best.ckpt")[0]["model"]
            want_cls = ("AtomMessagePassing" if "--atom-messages" in flags else
                        "BondMessagePassing", "AttentiveAggregation" if "attentive" in flags
                        else "MeanAggregation")
            if (manifest["message_passing"]["cls"], manifest["agg"]["cls"]) != want_cls:
                fail(f"train {tag} wrote a {manifest['message_passing']['cls']} with a "
                     f"{manifest['agg']['cls']}")
            params = first_epoch_params(dirs["cuda"] / "best.ckpt", dirs["cpu"] / "best.ckpt",
                                        ZERO_GRADIENT if "attentive" in flags else ())
            r = {"train_loss": card[0][0]["train_loss"], "train_loss_cpu": cpu[0][0]["train_loss"],
                 "first_epoch_params": {k: v for k, v in params.items() if k != "shares"}}
            rtol = 1e-4 if dt == "float32" else 1e-3  # phase 9(a)'s limits
            if not np.isclose(r["train_loss"], r["train_loss_cpu"], rtol=rtol, atol=0):
                fail(f"train {tag}: the epoch's loss on cuda disagrees with the CPU's: {r}")
            if not params["worst_share"] <= params["share_limit"]:
                fail(f"train {tag}: {params['worst']} on cuda parts from the CPU's in "
                     f"{params['worst_share']} of its elements")
            # predict the card's model on the card and on the CPU
            with open(dirs["cuda"] / "test_predictions.csv", newline="") as f:
                rows = list(csv.reader(f))[1:]
            test = dirs["cuda"] / "test.csv"
            with open(test, "w", newline="") as f:
                csv.writer(f).writerows([["smiles"]] + [[row[0]] for row in rows])
            want = np.array([float(row[1]) for row in rows])
            got, got_cpu = card_after_rehearsal(
                f"predict_{tag}",
                lambda dev: predict_table(run_cli(
                    "predict", ["--model-path", dirs["cuda"] / "best.ckpt", "-i", test, "--dtype",
                                dt], dirs["cuda"] / f"predict.{dev or 'cuda'}.csv", dev))[2],
                launches)
            tol = dict(rtol=1e-5, atol=1e-4) if dt == "float32" else dict(rtol=0, atol=1e-3)
            r["predict_vs_test_predictions"] = float(np.abs(got[:, 0] - want).max())
            r["predict_vs_cpu"] = float(np.abs(got - got_cpu).max())
            if not (np.isfinite(got).all() and np.allclose(got[:, 0], want, **tol)
                    and np.allclose(got, got_cpu, **tol)):
                fail(f"predict of train {tag}'s best.ckpt on cuda disagrees: {r}")
            res[tag] = r
    return res


def run_hpopt(out: Path, flags: list, device: str | None) -> list[dict]:
    """``hpopt`` in this process (its closing line kept off this script's
    output); its ``all_progress.json``."""
    import contextlib
    import io
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    with contextlib.redirect_stdout(io.StringIO()):
        run_cli("hpopt", ["-i", MOL_CSV, *flags], out, device)
    return json.loads((out / "all_progress.json").read_text())


def trial_rates(n_train: int, cfg: dict, budgets: list[int]) -> float:
    """The sum of the rates of the Adam steps of one trial, run to each epoch
    budget of ``budgets`` in turn (each resumed from the last): ``train``'s
    defaults with the config's values set as ``hpopt`` sets them (in the
    config's order, so that ``final_lr`` is ``final_lr_ratio`` times the
    ``max_lr`` before the config's own), and its schedule over each run's
    epochs."""
    from chemprop_tpu_torch.train.schedulers import noam_lr

    a = {"batch_size": 64, "warmup_epochs": 2, "init_lr": 1e-4, "max_lr": 1e-3, "final_lr": 1e-4}
    for k, v in cfg.items():
        if k == "final_lr_ratio":
            a["final_lr"] = v * a["max_lr"]
        else:
            a[k] = v
    steps = -(-n_train // a["batch_size"])
    total, done = 0.0, 0
    for epochs in budgets:
        sched = (a["warmup_epochs"] * steps, max(1, (epochs - a["warmup_epochs"]) * steps),
                 a["init_lr"], a["max_lr"], a["final_lr"])
        total += sum(noam_lr(k, *sched) for k in range(done, epochs * steps))
        done = epochs * steps
    return total


def hold_trials(tag: str, card: list[dict], cpu: list[dict], n_train: int) -> list[dict]:
    """Fail unless the card's trials are the CPU's (config, rung, epochs),
    every score is finite, and each is within ``2 sqrt(L) BF16_PREDICT_ATOL
    + HPOPT_LOSS_RTOL L`` times the trial's sum of rates over
    ``CLI_FIRST_LRS`` of the CPU's ``L``; each trial's scores and limits."""
    import numpy as np

    strip = [{k: v for k, v in r.items() if k != "score"} for r in card]
    if strip != [{k: v for k, v in r.items() if k != "score"} for r in cpu]:
        fail(f"hpopt {tag}: the card's trials are not the CPU's")
    out = []
    for r, c in zip(card, cpu):
        # FIFO trials run HPOPT_EPOCHS; an ASHA trial each rung's budget up to its own
        budgets = [e.get("epochs", HPOPT_EPOCHS) for e in card if e["trial"] == r["trial"]
                   and e.get("rung", 0) <= r.get("rung", 0)]
        rtol = HPOPT_LOSS_RTOL * trial_rates(n_train, r["config"], budgets) / CLI_FIRST_LRS
        atol = 2 * math.sqrt(abs(c["score"])) * BF16_PREDICT_ATOL
        out.append({"trial": r["trial"], "score": r["score"], "score_cpu": c["score"],
                    "abs_diff": abs(r["score"] - c["score"]), "rtol": rtol, "atol": atol})
    print(json.dumps({f"hpopt_{tag}_scores": out}))
    for r, c, o in zip(card, cpu, out):
        if not math.isfinite(r["score"]):
            fail(f"hpopt {tag}: trial {r['trial']} failed on the card (score {r['score']}); "
                 f"its traceback is in the log above")
        if not np.isclose(r["score"], c["score"], rtol=o["rtol"], atol=o["atol"]):
            fail(f"hpopt {tag}: trial {r['trial']} scores {r['score']} on the card, "
                 f"{c['score']} on the CPU, beyond its limits {o}")
    return out


def hpopt_fifo(out_dir: Path, launches: dict) -> dict:
    """Phase 11(c): ``hpopt`` with FIFO and random draws, three trials of two
    epochs in bf16 over every keyword, on the CPU (the rehearsal, its masks
    recorded) and on the card (the same masks replayed, as phase 10(d)
    does): the same trials, finite scores within ``hold_trials``'s limits."""
    from chemprop_tpu_torch.nn import utils as nn_utils

    flags = ["--num-trials", HPOPT_TRIALS, "--epochs", HPOPT_EPOCHS, "--search-algorithm",
             "random", "--search-parameter-keywords", "all", "--hyperopt-random-state-seed",
             HPOPT_SEED, "--dtype", "bfloat16"]
    draw, masks, replay = nn_utils.dropout_mask, [], []

    def record(shape, rate, generator, device):
        masks.append(draw(shape, rate, generator, device))
        return masks[-1]

    def run(dev):
        if dev == "cpu":
            nn_utils.dropout_mask = record
        else:
            replay.extend(masks)
            nn_utils.dropout_mask = lambda shape, rate, generator, d: replay.pop(0).to(d)
        return run_hpopt(out_dir / f"hpopt_fifo.{dev or 'cuda'}", flags, dev)

    try:
        card, cpu = card_after_rehearsal("hpopt_fifo_bfloat16", run, launches)
    finally:
        nn_utils.dropout_mask = draw
    if replay or not masks:
        fail(f"hpopt: {len(masks)} masks drawn on the CPU, {len(replay)} left on the card")
    cfgs = [r["config"] for r in card]
    if not (any(c["message_hidden_dim"] >= 600 for c in cfgs)
            and any(c["activation"] != "relu" for c in cfgs) and any(c["dropout"] > 0 for c in cfgs)
            and any(c["activation"] == "relu" and c["dropout"] == 0 and c["depth"] >= 3
                    for c in cfgs)):
        fail(f"hpopt with seed {HPOPT_SEED} drew trials without the widths, activations or "
             f"dropout the phase is for: {cfgs}")
    n_train = len(json.loads((out_dir / "hpopt_fifo.cuda/trial_0/splits.json").read_text())[0]
                  ["train"])
    return {"configs": cfgs, "scores": hold_trials("fifo", card, cpu, n_train),
            "masks": len(masks)}


def hpopt_asha(out_dir: Path, launches: dict) -> dict:
    """Phase 11(d): ``hpopt`` with ASHA, three trials of the default model
    over the learning-rate keywords, eta 3, three epochs, bf16: every trial
    one epoch, the best resumed from its ``last.ckpt`` to three, on the card
    and on the CPU."""
    from chemprop_tpu_torch.models import serialize

    flags = ["--num-trials", 3, "--scheduler", "asha", "--asha-eta", 3, "--epochs", 3,
             "--search-algorithm", "random", "--search-parameter-keywords", "learning_rate",
             "--hyperopt-random-state-seed", HPOPT_SEED, "--dtype", "bfloat16"]
    card, cpu = card_after_rehearsal(
        "hpopt_asha_bfloat16",
        lambda dev: run_hpopt(out_dir / f"hpopt_asha.{dev or 'cuda'}", flags, dev), launches)
    rungs = [(r["rung"], r["epochs"]) for r in card]
    if rungs != [(0, 1)] * 3 + [(1, 3)]:
        fail(f"hpopt asha ran the rungs {rungs}, not three trials of one epoch and one of three")
    survivor = out_dir / "hpopt_asha.cuda" / f"trial_{card[-1]['trial']}"
    scores = hold_trials("asha", card, cpu,
                         len(json.loads((survivor / "splits.json").read_text())[0]["train"]))
    history = json.loads((survivor / "history.json").read_text())
    epoch = int(serialize.read_checkpoint(survivor / "checkpoints/last.ckpt")[1]["epoch"])
    if len(history) != 2 or epoch != 3:
        fail(f"hpopt asha: the survivor ran {len(history)} epochs after its resume and its "
             f"last.ckpt names epoch {epoch}, not 2 and 3")
    return {"rungs": rungs, "scores": scores, "survivor": card[-1]["trial"],
            "epochs_after_resume": len(history)}


def hpopt_phase(card: str) -> tuple[dict, dict]:
    """Phase 11: the other architectures of ``train`` and ``hpopt`` on the
    card, each run's launches exactly its CPU rehearsal's; the phase's
    unserved calls are read as a difference. Its runs write into a
    temporary directory, removed after it: the trials' checkpoints come to
    tens of megabytes."""
    import tempfile

    from chemprop_tpu_torch.ops import UNSERVED

    t0 = time.time()
    before = dict(UNSERVED)
    launches, res = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hpopt_") as tmp:
        out_dir = Path(tmp)
        res["architectures"] = architecture_runs(out_dir, launches)
        res["hpopt_fifo"] = hpopt_fifo(out_dir, launches)
        res["hpopt_asha"] = hpopt_asha(out_dir, launches)
    unserved = unserved_since(before)
    if unserved:
        fail(f"phase 11 left calls unserved: {unserved}")
    res["launches"] = launches
    res["seconds"] = time.time() - t0
    print(json.dumps({"hpopt_phase": res}))
    print(json.dumps({"phase": "hpopt", "seconds": res["seconds"], "card": card}))
    return launches, res


# ---------------------------------------------------------------- phase 12
def rehearsed(tag: str, run, launches: dict, unserved: dict):
    """``card_after_rehearsal`` that also holds the card's calls without a
    tile table (``ops.UNSERVED``) to the rehearsal's, exactly: the two
    results."""
    from chemprop_tpu_torch.ops import UNSERVED

    counts = {}

    def counted(dev):
        before = dict(UNSERVED)
        out = run(dev)
        counts[dev or "cuda"] = unserved_since(before)
        return out

    card, cpu = card_after_rehearsal(tag, counted, launches)
    if counts["cuda"] != counts["cpu"]:
        fail(f"{tag}: calls without a tile table on cuda {counts['cuda']}, in the CPU "
             f"rehearsal {counts['cpu']}")
    if counts["cuda"]:
        unserved[tag] = counts["cuda"]
    return card, cpu


def mc_train(out: Path, dtype: str, device: str | None, flags: list) -> list[dict]:
    """One epoch of ``train`` in this process, one member at full width; its
    history."""
    import shutil

    from chemprop_tpu_torch.cli.main import main

    shutil.rmtree(out, ignore_errors=True)
    argv = ["-q", "train", "-o", str(out), "--epochs", "1", "--dtype", dtype, *map(str, flags)]
    if main(argv + (["--device", device] if device else [])) != 0:
        fail(f"train {flags} --dtype {dtype} on {device or 'cuda'} returned non-zero")
    return json.loads((out / "history.json").read_text())


def hold_scaled(tag: str, card, cpu, scale, dt: str) -> float:
    """Fail unless the card's predictions are the CPU's within phase 3's
    limits (f32 rtol 1e-5 / atol 1e-4, bf16 atol 1e-3) in the units of the
    model's unscaling (a target's standard deviation: phase 3 holds lipo's
    predictions, whose scale is about 1); the largest scaled difference."""
    import numpy as np

    card, cpu = (np.asarray(x, dtype=np.float64) / np.asarray(scale) for x in (card, cpu))
    rtol, atol = (1e-5, 1e-4) if dt == "float32" else (0.0, 1e-3)
    gap = float(np.abs(card - cpu).max())
    if not (np.isfinite(card).all() and np.allclose(card, cpu, rtol=rtol, atol=atol)):
        fail(f"{tag}: the card's predictions part from the CPU's by {gap} (scaled units)")
    return gap


def molecule_featurizer_run(out_dir: Path, launches: dict, unserved: dict) -> dict:
    """Phase 12(a): one bf16 ``train`` epoch on mol.csv with
    ``--molecule-featurizers`` ``MOLECULE_FEATURIZERS`` (2248 columns of
    ``X_d``) on the CPU and on the card, then ``predict`` of the card's
    ``best.ckpt`` on both: the epoch's loss within phase 9(a)'s bf16 limit,
    the predictions within phase 3's and against ``test_predictions.csv``."""
    import numpy as np

    from chemprop_tpu_torch.models import load_model

    flags = ["-i", MOL_CSV, "--aggregation", "mean", "--molecule-featurizers",
             *MOLECULE_FEATURIZERS]
    dirs = {"cuda": out_dir / "molfeat", "cpu": out_dir / "molfeat_cpu"}
    card, cpu = rehearsed("train_molecule_featurizers_bfloat16", lambda dev: mc_train(
        dirs[dev or "cuda"], "bfloat16", dev, flags), launches, unserved)
    r = {"train_loss": card[0]["train_loss"], "train_loss_cpu": cpu[0]["train_loss"]}
    if not np.isclose(r["train_loss"], r["train_loss_cpu"], rtol=1e-3, atol=0):
        fail(f"train with molecule featurizers: the epoch's loss on cuda disagrees: {r}")
    model, _ = load_model(dirs["cuda"] / "best.ckpt", "cpu")
    r["ffn_input_dim"] = model.predictor.input_dim
    if model.predictor.input_dim != 300 + MOLECULE_FEATURIZER_WIDTH:
        fail(f"train with molecule featurizers built an FFN of {model.predictor.input_dim} inputs")
    _, rows = read_rows(dirs["cuda"] / "test_predictions.csv")
    test = dirs["cuda"] / "test.csv"
    with open(test, "w", newline="") as f:
        csv.writer(f).writerows([["smiles"]] + [[row[0]] for row in rows])
    want = np.array([float(row[1]) for row in rows])
    got, got_cpu = rehearsed("predict_molecule_featurizers_bfloat16", lambda dev: predict_table(
        run_cli("predict", ["--model-path", dirs["cuda"] / "best.ckpt", "-i", test, "--dtype",
                            "bfloat16", "--molecule-featurizers", *MOLECULE_FEATURIZERS],
                dirs["cuda"] / f"predict.{dev or 'cuda'}.csv", dev))[2], launches, unserved)
    scale = model.predictor.output_transform.scale.numpy().reshape(1, -1)
    r["predict_vs_cpu"] = hold_scaled("predict with molecule featurizers", got, got_cpu, scale,
                                      "bfloat16")
    r["predict_vs_test_predictions"] = hold_scaled(
        "predict with molecule featurizers against its test_predictions.csv", got[:, :1],
        want[:, None], scale, "bfloat16")
    return r


def reference_predictions(out_dir: Path, launches: dict, unserved: dict) -> dict:
    """Phase 12(b): ``predict`` of the reference multicomponent and reaction
    checkpoints on their bundled CSVs in f32 and bf16, on the card against
    the CPU at phase 3's limits in scaled units; rxn+mol's components go
    through the component-order fix (``cli.predict.reorder_components``)."""
    from chemprop_tpu_torch.models import load_model

    res = {}
    for name, (ckpt, rel, flags) in MULTI_REFERENCES.items():
        model, _ = load_model(REPO / "tests/data" / ckpt, "cpu")
        scale = model.predictor.output_transform.scale.numpy().reshape(1, -1)
        for dt in ("float32", "bfloat16"):
            tag = f"predict_{name}_{dt}"
            got, cpu = rehearsed(tag, lambda dev: predict_table(run_cli(
                "predict", ["--model-path", REPO / "tests/data" / ckpt, "-i",
                            REPO / "tests/data/regression" / rel, "--dtype", dt, *flags],
                out_dir / f"{tag}_{dev or 'cuda'}.csv", dev))[2], launches, unserved)
            res[tag] = {"rows": len(got), "vs_cpu": hold_scaled(tag, got, cpu, scale, dt)}
    return res


def multicomponent_training(out_dir: Path, launches: dict, unserved: dict) -> dict:
    """Phase 12(c): one ``train`` epoch of each of ``MULTI_TRAINS`` in f32 and
    bf16 at full width on the card against the same command on the CPU as
    phase 9(a) holds ``train``: the epoch's loss (rtol 1e-4 f32, 1e-3 bf16)
    and each parameter tensor's share of elements apart
    (``first_epoch_params``), a shared block's tensors taking both
    components' gradients."""
    import numpy as np

    from chemprop_tpu_torch.models import serialize

    res = {}
    for name, (flags, want_blocks) in MULTI_TRAINS.items():
        for dt in ("float32", "bfloat16"):
            tag = f"train_{name}_{dt}"
            dirs = {"cuda": out_dir / tag, "cpu": out_dir / f"{tag}_cpu"}
            card, cpu = rehearsed(tag, lambda dev: mc_train(dirs[dev or "cuda"], dt, dev, flags),
                                  launches, unserved)
            manifest = serialize.read_checkpoint(dirs["cuda"] / "best.ckpt")[0]["model"]
            blocks = len(manifest["message_passing"].get("blocks", []))
            if blocks != want_blocks:
                fail(f"{tag} wrote a model of {blocks} blocks, expected {want_blocks}")
            params = first_epoch_params(dirs["cuda"] / "best.ckpt", dirs["cpu"] / "best.ckpt")
            r = {"train_loss": card[0]["train_loss"], "train_loss_cpu": cpu[0]["train_loss"],
                 "edges_per_s": card[0]["edges_per_s"],
                 "first_epoch_params": {k: v for k, v in params.items() if k != "shares"}}
            rtol = 1e-4 if dt == "float32" else 1e-3
            if not np.isclose(r["train_loss"], r["train_loss_cpu"], rtol=rtol, atol=0):
                fail(f"{tag}: the epoch's loss on cuda disagrees with the CPU's: {r}")
            if not params["worst_share"] <= params["share_limit"]:
                fail(f"{tag}: {params['worst']} on cuda parts from the CPU's in "
                     f"{params['worst_share']} of its elements")
            res[tag] = r
    return res


def multicomponent_phase(card: str) -> tuple[dict, dict]:
    """Phase 12: molecule featurizers, the reference multicomponent and
    reaction checkpoints, and multicomponent and reaction training, each run
    first rehearsed on the CPU: launches exactly the rehearsal's (mol+mol's
    dyes of more than 128 directed edges give their component a split table,
    over which A, F, G and H run with their second passes), and no call
    without a table."""
    import tempfile

    t0 = time.time()
    launches, unserved, res = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as tmp:
        out_dir = Path(tmp)
        res["molecule_featurizers"] = molecule_featurizer_run(out_dir, launches, unserved)
        res["reference_predictions"] = reference_predictions(out_dir, launches, unserved)
        res["training"] = multicomponent_training(out_dir, launches, unserved)
    res["launches"] = launches
    res["unserved"] = unserved
    res["seconds"] = time.time() - t0
    print(json.dumps({"multicomponent_phase": res}))
    print(json.dumps({"multicomponent_unserved": unserved}))
    if unserved:
        fail(f"phase 12 left calls without a table: {unserved}")
    print(json.dumps({"phase": "multicomponent", "seconds": res["seconds"], "card": card}))
    return launches, res


# ---------------------------------------------------------------- phase 13
def mab_flags(name: str) -> list:
    """The inputs the JAX package's tests predict a MAB checkpoint on."""
    if name == "atomic_regression_atom_mapped.pt":
        return ["-i", MAB_CORPUS, "--keep-h", "--reorder-atoms"]
    if name == "QM_descriptors.pt":
        return ["-i", MAB_DIR / "regression.csv", "--add-h"]
    if name == "regression_with_extras.pt":
        return ["-i", MAB_DIR / "regression.csv", "--keep-h", "--reorder-atoms",
                "--descriptors-path", MAB_DIR / "descriptors.npz",
                "--atom-features-path", MAB_DIR / "atom_features_descriptors.npz",
                "--bond-features-path", MAB_DIR / "bond_features_descriptors.npz",
                "--atom-descriptors-path", MAB_DIR / "atom_features_descriptors.npz",
                "--bond-descriptors-path", MAB_DIR / "bond_features_descriptors.npz"]
    if name == "regression_constrained.pt":
        return ["-i", MAB_DIR / "constrained_regression.csv", "--keep-h", "--constraints-path",
                MAB_DIR / "constrained_regression_constraints.csv", "--constraints-to-targets",
                "atom_y1", "atom_y2", "bond_y2"]
    return ["-i", MAB_DIR / "regression.csv", "--keep-h"]


def mab_table(path: Path) -> dict:
    """Each column of a MAB predictions CSV, its molecules' values (an atom
    or bond column's lists) end to end."""
    import ast

    import numpy as np

    header, rows = read_rows(path)
    return {h: np.concatenate([np.atleast_1d(np.array(ast.literal_eval(r[i]) if r[i] else np.nan,
                                                      dtype=float)) for r in rows])
            for i, h in enumerate(header) if i}


def mab_scales(model, cols) -> dict:
    """Each output column's unscaling factor (1 for a head without one)."""
    from chemprop_tpu_torch.cli.mab import output_columns_of

    scales = {}
    for head, names in zip(model.predictors, output_columns_of(model, cols)):
        t = None if head is None else head.output_transform
        for j, c in enumerate(names or []):
            scales[c] = 1.0 if t is None else float(t.scale[0, j])
    return scales


def check_mab_launches(tag: str, launches: dict) -> None:
    absent = {k: launches[k] for k in MAB_ABSENT if launches.get(k, 0)}
    if absent:
        fail(f"{tag} launched {absent}: a MAB path must never take loop_readout or iter2")


def mab_predictions(out_dir: Path, launches: dict, unserved: dict) -> dict:
    """Phase 13(a): ``predict`` of the 14 reference MAB checkpoints on the card
    in f32 and bf16 against the CPU at phase 3's limits in each column's
    scaled units (the constraints of ``regression_constrained.pt``, the extra
    inputs of ``regression_with_extras.pt``), the atom-mapped corpus in f32
    also against the reference's own predictions, with no call unserved."""
    import numpy as np

    from chemprop_tpu_torch.models import load_model

    res = {}
    for path in sorted(MAB_MODELS.glob("*.pt")):
        model, cols = load_model(path, "cpu")
        scales = mab_scales(model, cols)
        for dt in ("float32", "bfloat16"):
            tag = f"predict_mab_{path.stem}_{dt}"
            got, cpu = rehearsed(tag, lambda dev: mab_table(run_cli(
                "predict", ["--model-path", path, *mab_flags(path.name), "--dtype", dt],
                out_dir / f"{tag}_{dev or 'cuda'}.csv", dev)), launches, unserved)
            check_mab_launches(tag, launches[tag])
            if sorted(got) != sorted(scales) or sorted(cpu) != sorted(scales):
                fail(f"{tag}: columns {sorted(got)}, expected {sorted(scales)}")
            flat = {k: np.concatenate([t[c] / scales[c] for c in sorted(scales)])
                    for k, t in (("card", got), ("cpu", cpu))}
            res[tag] = {"values": int(flat["card"].size),
                        "vs_cpu": hold_scaled(tag, flat["card"], flat["cpu"], 1.0, dt)}
            if path.name == "atomic_regression_atom_mapped.pt" and dt == "float32":
                if tag in unserved:
                    fail(f"{tag} left calls without a tile table: {unserved[tag]}")
                _, rows = read_rows(MAB_GOLDEN)
                want = mab_table(MAB_GOLDEN)["charges"]
                gap = float(np.abs(got["charges"] - want).max())
                res[tag]["vs_reference"] = gap
                res[tag]["molecules"] = len(rows)
                if len(rows) != 500 or not np.allclose(got["charges"], want,
                                                       rtol=MAB_GOLDEN_RTOL,
                                                       atol=MAB_GOLDEN_ATOL):
                    fail(f"{tag}: the corpus's predictions leave the reference's by {gap}")
    return res


def mab_training(out_dir: Path, launches: dict, unserved: dict) -> dict:
    """Phase 13(b): one ``train`` epoch of each of ``MAB_TRAINS`` in f32 and
    bf16 on the card against the same command on the CPU as phase 9(a) holds
    ``train``: the epoch's loss (rtol 1e-4 f32, 1e-3 bf16) and each parameter
    tensor's share of elements apart (``first_epoch_params``); each step's
    backward is F per iteration, never G or H."""
    import numpy as np

    res = {}
    for name, flags in MAB_TRAINS.items():
        for dt in ("float32", "bfloat16"):
            tag = f"train_mab_{name}_{dt}"
            dirs = {"cuda": out_dir / tag, "cpu": out_dir / f"{tag}_cpu"}
            card, cpu = rehearsed(tag, lambda dev: mc_train(dirs[dev or "cuda"], dt, dev, flags),
                                  launches, unserved)
            check_mab_launches(tag, launches[tag])
            if not launches[tag].get("bwd_message", 0):
                fail(f"{tag} launched no transposed message (F): {launches[tag]}")
            params = first_epoch_params(dirs["cuda"] / "best.ckpt", dirs["cpu"] / "best.ckpt")
            r = {"train_loss": card[0]["train_loss"], "train_loss_cpu": cpu[0]["train_loss"],
                 "val_loss": card[0]["val_loss"], "val_loss_cpu": cpu[0]["val_loss"],
                 "edges_per_s": card[0]["edges_per_s"],
                 "first_epoch_params": {k: v for k, v in params.items() if k != "shares"}}
            rtol = 1e-4 if dt == "float32" else 1e-3
            for key in ("train_loss", "val_loss"):
                if not np.isclose(r[key], r[f"{key}_cpu"], rtol=rtol, atol=0):
                    fail(f"{tag}: the epoch's {key} on cuda disagrees with the CPU's: {r}")
            if not params["worst_share"] <= params["share_limit"]:
                fail(f"{tag}: {params['worst']} on cuda parts from the CPU's in "
                     f"{params['worst_share']} of its elements")
            res[tag] = r
    return res


def mab_phase(card: str) -> tuple[dict, dict]:
    """Phase 13: mol-atom-bond models, each run first rehearsed on the CPU:
    launches and calls without a tile table exactly the rehearsal's, G, H and
    D never."""
    import tempfile

    t0 = time.time()
    launches, unserved, res = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mab_") as tmp:
        out_dir = Path(tmp)
        res["predictions"] = mab_predictions(out_dir, launches, unserved)
        res["training"] = mab_training(out_dir, launches, unserved)
    res["launches"] = launches
    res["unserved"] = unserved
    res["seconds"] = time.time() - t0
    print(json.dumps({"mab_phase": res}))
    print(json.dumps({"mab_unserved": unserved}))
    print(json.dumps({"phase": "mab", "seconds": res["seconds"], "card": card}))
    return launches, res


# ---------------------------------------------------------------- phase 14
def interpret_molecules() -> dict:
    """Phase 14's molecules of mol.csv: the first of 12-16 heavy atoms (exact
    Myerson, 2^n subsets) and the first of more than 20 (sampled)."""
    from chemprop_tpu_torch.chem import make_mol

    _, rows = read_rows(MOL_CSV)
    sizes = [(r[0], make_mol(r[0]).num_atoms) for r in rows]
    return {"exact": next(s for s, n in sizes if EXACT_ATOMS[0] <= n <= EXACT_ATOMS[1]),
            "sampled": next(s for s, n in sizes if n > SAMPLED_ABOVE)}


class recorded_evals:
    """``with recorded_evals() as calls:`` each ``MyersonExplainer._eval_masks``
    call in the block (the explainers' and the MCTS scorer's, the command
    line's too) appended to ``calls`` as ``(mg, masks, outputs, batches)``."""

    def __enter__(self):
        from chemprop_tpu_torch.interpret import MyersonExplainer, subgraph_pad

        self.cls, self.fn, calls = MyersonExplainer, MyersonExplainer._eval_masks, []

        def recorded(explainer, mg, masks, _fn=self.fn):
            out = _fn(explainer, mg, masks)
            B = subgraph_pad(mg, len(masks), explainer.graphs_per_batch).n_graphs
            calls.append((mg, list(masks), out, -(-len(masks) // B)))
            return out

        self.cls._eval_masks = recorded
        return calls

    def __exit__(self, *exc):
        self.cls._eval_masks = self.fn
        return False


def rehearsed_evals(tag: str, run, path: Path, dt: str, launches: dict, unserved: dict):
    """``rehearsed`` for a run of the explainers, ``run(device, calls)``:
    the card's launches and calls without a tile table exactly the CPU
    rehearsal's. Where a bf16 search took another turn on the card than on
    the CPU (scores within bf16's limit order two states apart), the card
    evaluated other subgraphs; its launches are then held to a rehearsal of
    its own batches on the CPU. ``(card, cpu, card calls, cpu calls,
    replayed)``."""
    import torch

    from chemprop_tpu_torch.interpret import MyersonExplainer
    from chemprop_tpu_torch.models import load_model
    from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED

    before = dict(UNSERVED)
    with rehearsal() as want, recorded_evals() as cpu_calls:
        cpu = run("cpu", cpu_calls)
    cpu_unserved = unserved_since(before)
    LAUNCHES.clear()
    before = dict(UNSERVED)
    with recorded_evals() as card_calls:
        card = run(None, card_calls)
    launches[tag] = dict(LAUNCHES)
    card_unserved = unserved_since(before)
    replayed = [c[1] for c in card_calls] != [c[1] for c in cpu_calls]
    if replayed:
        if dt == "float32":
            fail(f"{tag}: the card evaluated other subgraphs than the CPU in float32")
        explainer = MyersonExplainer(load_model(path, "cpu", getattr(torch, dt))[0], device="cpu")
        before = dict(UNSERVED)
        with rehearsal() as want:
            for mg, masks, _, _ in card_calls:
                explainer._eval_masks(mg, masks)
        cpu_unserved = unserved_since(before)
    check_path_launches(tag, launches[tag], exact=True, want=dict(want))
    if card_unserved != cpu_unserved:
        fail(f"{tag}: calls without a tile table on cuda {card_unserved}, in the CPU "
             f"rehearsal {cpu_unserved}")
    if card_unserved:
        unserved[tag] = card_unserved
    first = "message" if dt == "float32" else "fused_iter"
    if not (launches[tag].get(first) and launches[tag].get("sorted_segment_sum")):
        fail(f"{tag} did not launch {first} and sorted_segment_sum: {launches[tag]}")
    return card, cpu, card_calls, cpu_calls, replayed


def explain_run(path: Path, dt: str, molecules: dict, dev: str | None, calls: list) -> dict:
    """Phase 14(a)(b) on one device: exact and sampled Myerson and MCTS with
    default parameters on ``molecules``, and each molecule's prediction alone
    (``predict``'s batch of one); the spans of ``calls`` each one made."""
    import torch

    from chemprop_tpu_torch.chem import make_mol
    from chemprop_tpu_torch.data.collate import batch_mol_graphs
    from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer
    from chemprop_tpu_torch.interpret import MCTSRationaleExplainer, MyersonExplainer
    from chemprop_tpu_torch.models import load_model
    from chemprop_tpu_torch.utils.device import resolve_device

    device = resolve_device(dev)
    model = load_model(path, device, getattr(torch, dt))[0]
    feat = SimpleMoleculeMolGraphFeaturizer()
    res = {}
    for kind, smi in molecules.items():
        mg = feat(make_mol(smi))
        i0 = len(calls)
        phi = MyersonExplainer(model, n_samples=INTERPRET_SAMPLES, device=device).explain(mg)
        i1 = len(calls)
        rationales = MCTSRationaleExplainer(model, device=device).explain(smi)
        with torch.no_grad():
            alone = model(batch_mol_graphs([mg]).to(device))[:1].float().cpu().numpy()[0]
        res[kind] = {"phi": phi, "alone": alone, "rationales": rationales,
                     "myerson": (i0, i1), "mcts": (i1, len(calls))}
    return res


def hold_subgraphs(tag: str, card: list, cpu: list, dt: str) -> float:
    """Fail unless both devices evaluated the same subgraphs, each within
    phase 3's limits for ``dt``; the largest difference (``Δf``)."""
    import numpy as np

    if [c[1] for c in card] != [c[1] for c in cpu]:
        fail(f"{tag}: the card and the CPU evaluated other subgraphs")
    got = np.concatenate([c[2] for c in card])
    want = np.concatenate([c[2] for c in cpu])
    rtol, atol = (1e-5, 1e-4) if dt == "float32" else (0.0, 1e-3)
    gap = float(np.abs(got - want).max())
    if not (np.isfinite(got).all() and np.allclose(got, want, rtol=rtol, atol=atol)):
        fail(f"{tag}: subgraph predictions on the card part from the CPU's by {gap}")
    return gap


def hold_rationales(tag: str, card: list, cpu: list, dt: str) -> dict:
    """MCTS rationales: in f32 the same atom sets in the same order, scores
    within phase 3's f32 limits; in bf16 the scores of the sets both found
    within its bf16 limit, and every set only one device found listed with
    its score and the margin to ``prop_delta``, the filter's decision."""
    import numpy as np

    from chemprop_tpu_torch.interpret import MCTSRationaleExplainer

    prop_delta = MCTSRationaleExplainer(None).prop_delta
    card_sets = {tuple(r["atoms"]): r["score"] for r in card}
    cpu_sets = {tuple(r["atoms"]): r["score"] for r in cpu}
    if dt == "float32" and [tuple(r["atoms"]) for r in card] != [tuple(r["atoms"]) for r in cpu]:
        fail(f"{tag}: the card's rationales {list(card_sets)} are not the CPU's {list(cpu_sets)}")
    common = sorted(set(card_sets) & set(cpu_sets))
    gap = max((abs(card_sets[k] - cpu_sets[k]) for k in common), default=0.0)
    rtol, atol = (1e-5, 1e-4) if dt == "float32" else (0.0, 1e-3)
    if not all(np.isclose(card_sets[k], cpu_sets[k], rtol=rtol, atol=atol) for k in common):
        fail(f"{tag}: rationale scores part by {gap}")
    apart = [{"atoms": list(k), "on": "cuda" if k in card_sets else "cpu",
              "score": card_sets.get(k, cpu_sets.get(k)),
              "margin_to_prop_delta": card_sets.get(k, cpu_sets.get(k)) - prop_delta}
             for k in sorted(set(card_sets) ^ set(cpu_sets))]
    return {"rationales": len(card), "common": len(common), "score_gap": gap, "apart": apart}


def interpret_explainers(launches: dict, unserved: dict) -> dict:
    """Phase 14(a)(b): each reference model in f32 and bf16, the card's run
    against the CPU's (rehearsed): per-subgraph predictions at phase 3's
    limits, attributions within ``2 n Δf``, the efficiency axiom (the
    attributions sum to the molecule's prediction alone: 1e-4 in f32, phase
    3's bf16 limit in bf16, and to the explainer's own prediction of the
    whole molecule to 1e-4 in both), and the rationales."""
    import numpy as np

    molecules = interpret_molecules()
    res = {"molecules": molecules}
    for name, path in INTERPRET_MODELS.items():
        for dt in ("float32", "bfloat16"):
            tag = f"interpret_{name}_{dt}"
            card, cpu, card_calls, cpu_calls, replayed = rehearsed_evals(
                tag, lambda dev, calls: explain_run(path, dt, molecules, dev, calls), path, dt,
                launches, unserved)
            r = {"replayed": replayed}
            for kind in molecules:
                c, p = card[kind], cpu[kind]
                n = c["phi"].shape[0]
                span = slice(*c["myerson"])
                if c["myerson"] != p["myerson"]:
                    fail(f"{tag}_{kind}: the card made other explainer calls than the CPU")
                df = hold_subgraphs(f"{tag}_{kind}", card_calls[span], cpu_calls[span], dt)
                att_gap = float(np.abs(c["phi"] - p["phi"]).max())
                if att_gap > 2 * n * df + 1e-9:
                    fail(f"{tag}_{kind}: attributions part by {att_gap} > 2 n Δf = {2 * n * df}")
                (_, masks, out, n_batches), = card_calls[span]
                whole = out[masks.index((1 << n) - 1)]
                eff_own = float(np.abs(c["phi"].sum(0) - whole).max())
                eff_alone = float(np.abs(c["phi"].sum(0) - c["alone"]).max())
                if eff_own > 1e-4 or eff_alone > (1e-4 if dt == "float32" else 1e-3):
                    fail(f"{tag}_{kind}: the attributions sum {c['phi'].sum(0)} apart from the "
                         f"prediction {c['alone']} (own {whole})")
                mcts = card_calls[slice(*c["mcts"])]
                mcts_gap = (hold_subgraphs(f"{tag}_{kind}_mcts", mcts, cpu_calls[slice(*p["mcts"])],
                                           dt) if not replayed else None)
                r[kind] = {"atoms": n, "subgraphs": len(masks), "batches": n_batches,
                           "delta_f": df, "attribution_gap": att_gap,
                           "efficiency_own": eff_own, "efficiency_alone": eff_alone,
                           "mcts_subgraphs": sum(len(m) for _, m, _, _ in mcts),
                           "mcts_batches": sum(b for *_, b in mcts), "mcts_delta_f": mcts_gap,
                           **hold_rationales(f"{tag}_{kind}", c["rationales"], p["rationales"],
                                             dt)}
            res[tag] = r
    return res


def interpret_cli(out_dir: Path, launches: dict, unserved: dict) -> dict:
    """Phase 14(c): ``predict --callback myerson`` and ``--callback mcts`` of
    the reference regression checkpoint on the first INTERPRET_CLI_ROWS rows
    of mol.csv in f32 and bf16, on the card against the CPU (rehearsed):
    the attributions within ``2 n`` times phase 3's limit, the rationales as
    phase 14(b) holds them."""
    import numpy as np

    rows = write_rows(out_dir / "interpret_rows.csv", MOL_CSV, slice(0, INTERPRET_CLI_ROWS))
    path = INTERPRET_MODELS["regression"]
    res = {}
    for dt in ("float32", "bfloat16"):
        for cb in ("myerson", "mcts"):
            tag = f"interpret_cli_{cb}_{dt}"

            def run(dev, calls):
                out = run_cli("predict", ["--model-path", path, "-i", rows, "--dtype", dt,
                                          "--callback", cb], out_dir / f"{tag}_{dev or 'cuda'}.csv",
                              dev)
                if cb == "mcts":
                    return json.loads((out.parent / f"{out.stem}_mcts_rationales.json")
                                      .read_text())
                with np.load(out.parent / f"{out.stem}_myerson_explanation.npz") as z:
                    return [z[k] for k in sorted(z.files, key=lambda k: int(k[4:]))]

            card, cpu, *_, replayed = rehearsed_evals(tag, run, path, dt, launches, unserved)
            if len(card) != len(cpu) or len(card) != INTERPRET_CLI_ROWS:
                fail(f"{tag}: {len(card)} molecules explained on the card, {len(cpu)} on the CPU")
            if cb == "mcts":
                res[tag] = {"replayed": replayed, "molecules": [
                    hold_rationales(f"{tag}_{i}", c, p, dt) for i, (c, p) in enumerate(zip(card, cpu))]}
                continue
            limit = 1e-4 if dt == "float32" else 1e-3
            gaps = [float(np.abs(c - p).max()) for c, p in zip(card, cpu)]
            for c, p, gap in zip(card, cpu, gaps):
                if c.shape != p.shape or not gap <= 2 * c.shape[0] * limit:
                    fail(f"{tag}: attributions part by {gap} (limit 2 n x {limit})")
            res[tag] = {"atoms": [int(c.shape[0]) for c in card], "attribution_gaps": gaps}
    return res


def interpret_phase(card: str) -> tuple[dict, dict]:
    """Phase 14: interpretation, each run first rehearsed on the CPU:
    launches and calls without a tile table exactly the rehearsal's."""
    import tempfile

    t0 = time.time()
    launches, unserved, res = {}, {}, {}
    res["explainers"] = interpret_explainers(launches, unserved)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_interpret_") as tmp:
        res["cli"] = interpret_cli(Path(tmp), launches, unserved)
    res["launches"] = launches
    res["unserved"] = unserved
    res["seconds"] = time.time() - t0
    counts = {k: {kind: {key: v[key] for key in ("subgraphs", "batches", "mcts_subgraphs",
                                                 "mcts_batches")}
                  for kind, v in r.items() if kind != "replayed"}
              for k, r in res["explainers"].items() if k != "molecules"}
    print(json.dumps({"interpret_phase": res}, default=float))
    print(json.dumps({"interpret_unserved": unserved}))
    print(json.dumps({"phase": "interpret", "seconds": res["seconds"], "subgraphs_and_batches":
                      counts, "card": card}))
    return launches, res


# ---------------------------------------------------------------- phase 15
# phase 15: the exported program against the eager forward on the card: f32
# to 1e-5 (the same kernels and products, another graph of the same
# operations), bf16 to 1e-3, phase 3's limit for bf16 predictions
EXPORT_LIMITS = {"float32": 1e-5, "bfloat16": 1e-3}
EXPORT_ROTATE = 37  # phase 15's second batch: the benchmark batch's graphs rotated
# phase 15(c): a process that imports chemprop_tpu_torch.ops alone loads each
# dtype's .pt2 and runs it on the leaves of the benchmark batch; it prints the
# load seconds, the launches and the unserved calls, and which modules of the
# package it imported
EXPORT_LOADER = """
import json, sys, time
import torch
import chemprop_tpu_torch.ops as ops
root, out = sys.argv[1], {}
leaves = torch.load(f"{root}/leaves.pt")
for dt in sys.argv[2:]:
    t0 = time.perf_counter()
    program = torch.export.load(f"{root}/{dt}.pt2")
    module = program.module()
    load_s = time.perf_counter() - t0
    ops.LAUNCHES.clear()
    before = dict(ops.UNSERVED)
    with torch.no_grad():
        y = module(leaves, None, None)
    torch.cuda.synchronize()
    torch.save(y.cpu(), f"{root}/{dt}.out.pt")
    out[dt] = {"load_s": load_s, "launches": dict(ops.LAUNCHES),
               "unserved": {k: v - before.get(k, 0) for k, v in ops.UNSERVED.items()
                            if v != before.get(k, 0)}}
out["modules"] = sorted(m for m in sys.modules if m.startswith("chemprop_tpu_torch.")
                        and not m.startswith("chemprop_tpu_torch.ops"))
print(json.dumps(out))
"""


def export_one(dt_name: str, data: list, batches: dict, seed: int, reps: int,
               root: Path) -> tuple[dict, dict]:
    """Phase 15 in one dtype: the default model at full width, its weights
    from ``seed``, exported on the card from the benchmark batch; the
    program's launches on the dataset's batch first rehearsed on the CPU
    (exported there from that batch), then one call of it on each of
    ``batches`` on the card against the eager forward, its launches exactly
    the eager forward's and the rehearsal's, nothing unserved; the eager and
    exported calls timed; the program saved to ``root``."""
    import torch

    from chemprop_tpu_torch.data import collate_batch
    from chemprop_tpu_torch.models.export import export_forward, save_exported
    from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED

    dt = getattr(torch, dt_name)
    torch.manual_seed(seed)
    model = default_model(dt).eval()
    small = collate_batch(data)
    program = export_forward(model, small)
    before = dict(UNSERVED)
    with rehearsal() as want:
        program(small.bmg)
    want, want_unserved = dict(want), unserved_since(before)
    model.to("cuda")
    t0 = time.perf_counter()
    program = export_forward(model, batches["first"])
    res = {"export_s": time.perf_counter() - t0, "rehearsal": want}
    launches = {}
    for tag, batch in batches.items():
        LAUNCHES.clear()
        with torch.inference_mode():
            eager = model(batch.bmg)
        eager_launches = dict(LAUNCHES)
        LAUNCHES.clear()
        before = dict(UNSERVED)
        got = program(batch.bmg)
        torch.cuda.synchronize()
        launches[f"export_{dt_name}_{tag}"] = call = dict(LAUNCHES)
        unserved = unserved_since(before)
        check_path_launches(f"predict_{dt_name}", call, exact=True)
        if call != eager_launches or call != want:
            fail(f"the exported {dt_name} program launched {call} on the {tag} batch, the eager "
                 f"forward {eager_launches}, the CPU rehearsal {want}")
        if unserved or want_unserved:
            fail(f"the exported {dt_name} program left calls unserved: {unserved} (rehearsal "
                 f"{want_unserved})")
        err = float((got.float() - eager.float()).abs().max())
        if got.shape != eager.shape or not bool(torch.isfinite(got).all()):
            fail(f"the exported {dt_name} program gave {tuple(got.shape)} or non-finite values")
        if err > EXPORT_LIMITS[dt_name]:
            fail(f"the exported {dt_name} program is {err} from the eager forward on the {tag} "
                 f"batch (limit {EXPORT_LIMITS[dt_name]})")
        res[tag] = {"max_abs_diff": err, "launches": call,
                    "N_pad": batch.bmg.V.shape[0], "E_pad": batch.bmg.E.shape[0]}
        if tag == "first":
            res["eager"] = eager.cpu()
    with torch.inference_mode():
        res["eager_ms"] = time_ms(lambda: model(batches["first"].bmg), reps, inner=1)
    res["exported_ms"] = time_ms(lambda: program(batches["first"].bmg), reps, inner=1)
    save_exported(root / f"{dt_name}.pt2", program)
    return launches, res


def export_phase(ds, card: str, seed: int, reps: int) -> tuple[dict, dict]:
    """Phase 15: ``models.export`` on the card in f32 and bf16
    (:func:`export_one`), then each ``.pt2`` loaded and run in a process that
    imports ``chemprop_tpu_torch.ops`` alone, its output within the same
    limits of the eager forward's and its launches the same."""
    import tempfile

    import torch

    from chemprop_tpu_torch.data import PadSpec, collate_batch
    from chemprop_tpu_torch.models.export import program_inputs

    t0 = time.time()
    data = [ds[i] for i in range(len(ds))]
    tiled = (data * -(-BATCH_SIZE // len(data)))[:BATCH_SIZE]
    first = collate_batch(tiled).to("cuda")
    # the same number of graphs in another order, padded wider: other node and
    # edge counts through the program's dynamic dimensions
    second = collate_batch(tiled[EXPORT_ROTATE:] + tiled[:EXPORT_ROTATE],
                           PadSpec(first.bmg.V.shape[0] + 128, first.bmg.E.shape[0] + 256,
                                   BATCH_SIZE)).to("cuda")
    batches = {"first": first, "second": second}
    launches, res = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        root = Path(tmp)
        for dt_name in ("float32", "bfloat16"):
            dt_launches, res[dt_name] = export_one(dt_name, data, batches, seed, reps, root)
            launches.update(dt_launches)
        torch.save(program_inputs(first.bmg)[0][0], root / "leaves.pt")
        proc = subprocess.run([sys.executable, "-c", EXPORT_LOADER, tmp, "float32", "bfloat16"],
                              cwd=REPO, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"loading the exported programs in a new process failed:\n{proc.stderr}")
        loaded = json.loads(proc.stdout.strip().splitlines()[-1])
        if loaded["modules"]:
            fail(f"loading the exported programs imported {loaded['modules']}")
        for dt_name in ("float32", "bfloat16"):
            got, r = torch.load(root / f"{dt_name}.out.pt"), loaded[dt_name]
            err = float((got.float() - res[dt_name].pop("eager").float()).abs().max())
            if err > EXPORT_LIMITS[dt_name]:
                fail(f"the loaded {dt_name} program is {err} from the eager forward")
            if r["launches"] != res[dt_name]["first"]["launches"] or r["unserved"]:
                fail(f"the loaded {dt_name} program launched {r['launches']}, unserved "
                     f"{r['unserved']}")
            launches[f"export_{dt_name}_loaded"] = r["launches"]
            res[dt_name]["loaded"] = {"max_abs_diff": err, "load_s": r["load_s"],
                                      "launches": r["launches"]}
    res["split"] = export_split(seed, launches)
    split_unserved = {}
    res["split_fit"] = split_fit(launches, split_unserved)
    if split_unserved:
        fail(f"phase 15(e) left calls unserved: {split_unserved}")
    res["seconds"] = time.time() - t0
    print(json.dumps({"export_phase": res}))
    print(json.dumps({"phase": "export", "seconds": res["seconds"], "card": card,
                      "launches_per_call": {dt: res[dt]["first"]["launches"]
                                            for dt in ("float32", "bfloat16")},
                      "max_abs_diff": {dt: {k: res[dt][k]["max_abs_diff"]
                                            for k in ("first", "second", "loaded")}
                                       for dt in ("float32", "bfloat16")}}))
    return launches, res


# phase 15(d): the programs exported from Tox21's split batch, and (e) a
# bf16 fit on Tox21's rows 250-399 (three molecules of more than 128 directed
# edges among them) with every opt-in kernel of the split table's paths
SPLIT_EXPORTS = {"float32": {}, "bfloat16_iter2": dict(iter2=True)}
SPLIT_FIT_ROWS = slice(250, 400)
SPLIT_FIT_OPTIONS = dict(iter2=True, fused_bwd=True)


def export_split(seed: int, launches: dict) -> dict:
    """Phase 15(d): the default model at full width exported from Tox21's
    split batch (:func:`tox21_bmg`) in f32 and in bf16 with ``iter2``: on the
    CPU under a rehearsal, then on the card, where the program launches A's
    tile kernel and its pass (f32) or D and its two passes (bf16), exactly as
    the rehearsal counts them and as the eager forward launches them,
    nothing unserved, and its predictions within ``EXPORT_LIMITS`` of the
    eager forward's."""
    import torch

    from chemprop_tpu_torch.data.collate import TrainingBatch
    from chemprop_tpu_torch.models.export import export_forward
    from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED

    res = {}
    for name, options in SPLIT_EXPORTS.items():
        dt_name = name.split("_")[0]
        torch.manual_seed(seed)
        model = default_model(getattr(torch, dt_name), **options).eval()
        outs, calls = {}, {}
        for dev in ("cpu", "cuda"):
            b = tox21_bmg(dev)
            batch = TrainingBatch(b, None, None, None, torch.ones(b.n_graphs, device=b.E.device),
                                  None, None)
            program = export_forward(model.to(b.E.device), batch)
            before = dict(UNSERVED)
            if dev == "cpu":
                with rehearsal() as want:
                    outs[dev] = program(b)
                calls[dev] = dict(want)
            else:
                LAUNCHES.clear()
                with torch.inference_mode():
                    eager = model(b)
                eager_calls = dict(LAUNCHES)
                LAUNCHES.clear()
                outs[dev] = program(b)
                torch.cuda.synchronize()
                calls[dev] = dict(LAUNCHES)
            unserved = unserved_since(before)
            if unserved:
                fail(f"the {name} program exported from Tox21's split batch left {unserved} "
                     f"unserved on {dev}")
        tag = f"export_split_{name}"
        launches[tag] = calls["cuda"]
        passes = "fused_iter_rows" if options.get("iter2") else "message_rows"
        if calls["cuda"] != calls["cpu"] or calls["cuda"] != eager_calls:
            fail(f"{tag} launched {calls['cuda']}, the CPU rehearsal {calls['cpu']}, the eager "
                 f"forward {eager_calls}")
        if not calls["cuda"].get(passes):
            fail(f"{tag} launched no {passes}: {calls['cuda']}")
        got = outs["cuda"]
        err = float((got.float() - eager.float()).abs().max())
        if not bool(torch.isfinite(got).all()) or err > EXPORT_LIMITS[dt_name]:
            fail(f"{tag}: {err} from the eager forward (limit {EXPORT_LIMITS[dt_name]})")
        res[name] = {"launches": calls["cuda"], "max_abs_diff": err,
                     "cpu_vs_card_max_abs_diff": float(
                         (got.float().cpu() - outs["cpu"].float()).abs().max())}
    print(json.dumps({"export_split": res}))
    return res


def split_fit(launches: dict, unserved: dict) -> dict:
    """Phase 15(e): a bf16 fit of the default model at full width with
    dropout 0.1 and ``SPLIT_FIT_OPTIONS`` (``iter2``, ``fused_bwd``) over
    Tox21's rows ``SPLIT_FIT_ROWS`` in batches of 50, its targets drawn from
    a seed, two epochs and a prediction (where D runs: no dropout); on the
    CPU under a rehearsal, then on the card, whose launches (E and its pass
    in the steps, D and its passes in the prediction) must be the
    rehearsal's, nothing unserved, its losses and predictions finite."""
    import numpy as np
    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.train import Trainer

    rows = read_targets(REPO / "tests/data/classification/mol.csv")[SPLIT_FIT_ROWS]
    rng = np.random.default_rng(29)
    ds = head_dataset([(smi, rng.standard_normal(1), None, None) for smi, *_ in rows])[0]

    def run(dev):
        torch.manual_seed(7)
        trainer = Trainer(default_model(torch.bfloat16, 0.1, **SPLIT_FIT_OPTIONS), max_epochs=2,
                          warmup_epochs=1, seed=12, device=dev)
        trainer.fit(DataLoader(ds, batch_size=50, shuffle=False))
        preds = trainer.predict(DataLoader(ds, batch_size=50))
        return [h["train_loss"] for h in trainer.history], preds

    tag = "train_split_bfloat16_dropout_iter2_fused_bwd"
    (losses, preds), (cpu_losses, _) = rehearsed(tag, run, launches, unserved)
    for kernel in ("fused_iter2", "fused_iter_rows", "iter_bwd", "iter_bwd_rows"):
        if not launches[tag].get(kernel):
            fail(f"{tag} launched no {kernel}: {launches[tag]}")
    if not (np.isfinite(losses).all() and np.isfinite(preds).all()):
        fail(f"{tag}: non-finite losses {losses} or predictions")
    res = {"losses": losses, "cpu_losses": cpu_losses, "launches": launches[tag]}
    print(json.dumps({"split_fit": res}))
    return res


# ---------------------------------------------------------------- phase 16
# phase 16: `train --split kmeans --use-cuikmolmaker-featurization`, one
# epoch at full width, and the same epoch with Python featurization
NATIVE_TRAIN = ["-i", MOL_CSV, "--split", "kmeans", "--data-seed", "3", "--seed", "5",
                "--aggregation", "mean"]
NATIVE_FLAG = "--use-cuikmolmaker-featurization"


def native_cli_phase(card: str) -> tuple[dict, dict]:
    """Phase 16: one f32 ``train`` epoch with the kmeans split and the native
    featurizer on the card, first rehearsed on the CPU (launches and calls
    without a tile table exactly the rehearsal's; the loss within phase
    9(a)'s limit of the CPU's); the same epoch with Python featurization on
    the card, whose splits and losses must be the same bits; ``predict`` of
    its ``best.ckpt`` with the flag and without, the same output."""
    import importlib.util
    import shutil
    import tempfile

    from chemprop_tpu_torch.ops import LAUNCHES

    t0 = time.time()
    launches, unserved, res = {}, {}, {}
    # the card's machine has no scikit-learn: the kmeans split runs without it
    res["sklearn_installed"] = importlib.util.find_spec("sklearn") is not None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as tmp:
        tmp = Path(tmp)

        def native(dev):
            return mc_train(tmp / f"native_{dev or 'cuda'}", "float32", dev,
                            NATIVE_TRAIN + [NATIVE_FLAG])

        card_hist, cpu_hist = rehearsed("train_kmeans_native", native, launches, unserved)
        LAUNCHES.clear()
        py_hist = mc_train(tmp / "python_cuda", "float32", None, NATIVE_TRAIN)
        launches["train_kmeans_python"] = dict(LAUNCHES)
        if launches["train_kmeans_python"] != launches["train_kmeans_native"]:
            fail(f"the Python featurization's epoch launched {launches['train_kmeans_python']}, "
                 f"the native one's {launches['train_kmeans_native']}")
        splits = {run: json.loads((tmp / run / "splits.json").read_text())
                  for run in ("native_cuda", "native_cpu", "python_cuda")}
        if not splits["native_cuda"] == splits["native_cpu"] == splits["python_cuda"]:
            fail("the kmeans splits differ between the runs")
        for key in ("train_loss", "val_loss"):
            if [r[key] for r in card_hist] != [r[key] for r in py_hist]:
                fail(f"{key} with the native featurizer {[r[key] for r in card_hist]}, with "
                     f"Python's {[r[key] for r in py_hist]}")
        loss_diff = abs(card_hist[0]["train_loss"] - cpu_hist[0]["train_loss"])
        if loss_diff > 1e-4 * abs(cpu_hist[0]["train_loss"]):  # phase 9(a)'s f32 limit
            fail(f"the native epoch's loss on the card is {loss_diff} from the CPU's")
        outputs = {}
        for tag, flags in (("with", [NATIVE_FLAG]), ("without", [])):
            LAUNCHES.clear()
            outputs[tag] = read_rows(run_cli(
                "predict", ["-i", MOL_CSV, "--model-paths", tmp / "native_cuda" / "best.ckpt",
                            *flags], tmp / f"predict_{tag}.csv", None))
            launches[f"predict_native_{tag}"] = dict(LAUNCHES)
            check_path_launches("predict_float32", launches[f"predict_native_{tag}"], exact=True,
                                want=path_launches("predict_float32", batches(100)))
        if outputs["with"] != outputs["without"]:
            fail("predict with --use-cuikmolmaker-featurization differs from predict without")
        shutil.rmtree(tmp / "native_cpu", ignore_errors=True)
        res.update(
            train_loss={"native_cuda": card_hist[0]["train_loss"],
                        "python_cuda": py_hist[0]["train_loss"],
                        "native_cpu": cpu_hist[0]["train_loss"]},
            val_loss={"native_cuda": card_hist[0]["val_loss"],
                      "python_cuda": py_hist[0]["val_loss"]},
            split_sizes={k: len(v) for k, v in splits["native_cuda"][0].items()},
            train_loss_cuda_vs_cpu=loss_diff, predict_rows=len(outputs["with"][1]))
    res["launches"], res["unserved"] = launches, unserved
    res["seconds"] = time.time() - t0
    print(json.dumps({"native_cli_phase": res}))
    print(json.dumps({"phase": "native_cli", "seconds": res["seconds"], "card": card,
                      "sklearn_installed": res["sklearn_installed"],
                      "train_loss": res["train_loss"]}))
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


TRACES = {"readings": 0, "traces": 0, "lost": 0, "misses": []}
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")
SPINS = 64  # short kernels launched first in a trace, left out of its reading


def kernel_trace(fn, calls: int = 10, tries: int = 8) -> dict | None:
    """Device microseconds per call of each kernel, copy and memset that
    ``fn`` launches, from a ``torch.profiler`` trace of ``calls`` calls; the
    host's work between the launches, which CUDA events count where it is
    longer than the kernel, is not in it. A trace can lose records (on an
    H100 under torch 2.11, traces of 10 calls held none of a call's
    kernels, or only some of the calls; late in this script's run about
    every other one did). So each trace opens with ``SPINS`` spin kernels
    that its reading leaves out (with them no trace of a whole run of this
    script on an H100 lost a record), and counts only where its device
    records match its launch calls (``LAUNCH_CALLS``) one for one and each
    came a whole number of times per call; else it is taken again, and
    after ``tries`` the reading is None. ``TRACES`` counts the readings
    asked for, the traces and the readings lost, and keeps the last
    misses."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    TRACES["readings"] += 1
    for _ in range(tries):
        TRACES["traces"] += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(SPINS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        device = {e.key: e for e in events
                  if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key}
        held = sum(e.count for e in device.values())
        launched = sum(e.count for e in events if e.device_type != DeviceType.CUDA
                       and e.key.startswith(LAUNCH_CALLS)) - SPINS
        if held and held == launched and all(e.count % calls == 0 for e in device.values()):
            return {key: e.device_time_total / calls for key, e in device.items()}
        TRACES["misses"] = TRACES["misses"][-9:] + [
            {"calls": calls, "launched": launched, "held": held,
             "odd": {k[:48]: e.count for k, e in device.items() if e.count % calls}}]
    TRACES["lost"] += 1
    return None


def device_ms(fn, calls: int = 10) -> float | None:
    """Device milliseconds per call of the kernels ``fn`` launches
    (``kernel_trace``), or None where every trace missed calls."""
    trace = kernel_trace(fn, calls)
    return None if trace is None else sum(trace.values()) / 1e3


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
    # the same kernel at atom message passing's message table, edges to
    # nodes: E rows of [H ; E ; 0] read, N rows written, ids and ptr read;
    # beside it index_add_ into a table of the data's dtype
    d_msg = t["HE"].shape[1]

    def atom_message_times(x):
        b_ms, b_by = bound((n_e + n_v) * d_msg * x.element_size() + 4 * (n_e + n_v + 1),
                           n_e * d_msg, f32_peak)
        acc_m = torch.zeros((n_v, d_msg), dtype=x.dtype, device=x.device)
        ms = time_ms(lambda: sorted_segment_sum(x, bmg.dst, bmg.edge_ptr), reps)
        return dict(
            ms=ms, plain_ms=time_ms(lambda: sorted_segment_sum_plain(
                x, bmg.dst, bmg.edge_ptr, x.dtype), reps),
            library_ms=time_ms(lambda: acc_m.index_add_(0, ids64, x), reps), bound_ms=b_ms,
            bound_by=b_by, share_of_bound=b_ms / ms, shape=[n_e, d_msg],
            dtype=str(x.dtype).removeprefix("torch."))

    out["sorted_segment_sum"]["atom_message"] = atom_message_times(t["HE"])
    out["sorted_segment_sum"]["atom_message"]["float32"] = atom_message_times(t["HE32"])
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


# phase 17: multi-GPU. (a) the giant polymer cut into PARTITION_SHARDS local
# shards; (b) the sharded step at world size 1 over NCCL; (c) the command
# line's --edge-partition on mol.csv's first PARALLEL_CLI_ROWS rows and the
# giant polymer
GIANT_RINGS = 3000  # "C1(CCCCC1)" * 3000: 18,000 atoms, 42,000 directed edges
PARTITION_SHARDS = 4
PARTITION_LR = 1e-3  # the partitioned and the dense step's Adam rate
# f32 against f32: the same function summed in other orders (rtol, atol)
PARTITION_FWD_LIMITS = (1e-4, 1e-5)
SHARDED_STEPS = 3
PARALLEL_CLI_ROWS = 30
PARALLEL_CLI_FLAGS = ["--epochs", "1", "--edge-partition", str(PARTITION_SHARDS),
                      "--aggregation", "mean", "--split-sizes", "0.8", "0.1", "0.1",
                      "--data-seed", "1", "--seed", "3"]


def giant_datum(rings: int = GIANT_RINGS, y: float = 1.5):
    """The giant polymer as a ``Datum``, featurised by the default featurizer."""
    import numpy as np

    from chemprop_tpu_torch.chem import make_mol
    from chemprop_tpu_torch.data.datasets import Datum
    from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer

    mg = SimpleMoleculeMolGraphFeaturizer()(make_mol("C1(CCCCC1)" * rings))
    return Datum(mg, None, None, np.array([y], np.float32), 1.0)


def partitionable_model(seed: int):
    """The default model at full width without batch norm (the partitioned
    path takes none), its weights from ``seed``, on the CPU."""
    import torch

    from chemprop_tpu_torch.models import MPNN
    from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN
    from chemprop_tpu_torch.nn.init import init_parameters

    model = MPNN(BondMessagePassing(), MeanAggregation(), RegressionFFN(output_transform=False))
    init_parameters(model, "lecun", torch.Generator().manual_seed(seed))
    return model


class plain_halo_ops:
    """``with plain_halo_ops():`` the partitioned path's sums and gathers take
    the plain versions of kernels C and I on whatever device."""

    def __enter__(self):
        from chemprop_tpu_torch.ops import edge_partition, gather, segment
        from chemprop_tpu_torch.parallel import partitioned_mp

        def seg(data, ids, ptr, out_dtype=None):
            return segment.sorted_segment_sum_plain(data, ids, ptr, out_dtype or data.dtype)[0]

        self.saved = [(edge_partition, "sorted_segment_sum", edge_partition.sorted_segment_sum),
                      (edge_partition, "row_gather", edge_partition.row_gather),
                      (partitioned_mp, "row_gather", partitioned_mp.row_gather)]
        edge_partition.sorted_segment_sum = seg
        edge_partition.row_gather = partitioned_mp.row_gather = gather.row_gather_plain
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)
        return False


def partitioned_step(model, datum, S: int, device):
    """The partitioned forward and one Adam step of ``model`` (a copy on
    ``device``) on ``datum`` cut into ``S`` local shards: the prediction, the
    loss and the stepped parameters, on the CPU, and the forward's seconds."""
    import copy

    import torch

    from chemprop_tpu_torch.parallel import partitioned_mp as pm
    from chemprop_tpu_torch.train.trainer import TrainState

    model = copy.deepcopy(model).to(device or "cuda")
    dev = next(model.parameters()).device
    g, dims = pm.build_partitioned_graph(datum.mg, S)
    dg = pm.place(g, dims, pm.LocalExchange(S), dev)
    t0 = time.time()
    preds = pm.make_partitioned_apply(model, S, dims)(dg)
    preds = preds.cpu()
    fwd_s = time.time() - t0
    params = dict(model.named_parameters())
    state = TrainState(params, {}, [torch.zeros_like(p) for p in params.values()],
                       [torch.zeros_like(p) for p in params.values()], 0,
                       torch.Generator(device=dev).manual_seed(0))
    y = torch.as_tensor(datum.y, device=dev)[None]
    loss = pm.make_partitioned_train_step(model, S, dims, lr=PARTITION_LR)(
        state, dg, y, torch.ones(1, device=dev))
    return (preds, float(loss), {k: v.detach().cpu() for k, v in params.items()}, fwd_s,
            dims)


def dense_step(model, datum):
    """The same forward and Adam step on the card's single-device path."""
    import copy

    import torch

    from chemprop_tpu_torch.data import collate_batch
    from chemprop_tpu_torch.train.trainer import adam_update

    model = copy.deepcopy(model).to("cuda")
    b = collate_batch([datum]).to("cuda")
    with torch.inference_mode():
        preds = model(b.bmg)[:1].cpu()
    params = list(model.parameters())
    pred = model.train_step_preds(b.bmg, is_training=True)[:1]
    y = torch.as_tensor(datum.y, device="cuda")[None]
    loss = model.criterion(pred, y, torch.isfinite(y), torch.ones(1, device="cuda"))
    grads = torch.autograd.grad(loss, params)
    adam_update(params, list(grads), [torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params], 0, PARTITION_LR)
    return (preds, float(loss.detach()),
            {k: v.detach().cpu() for k, v in model.named_parameters()})


def partition_timings(model, datum, reps: int = 5) -> dict:
    """Host-clock ms per call, between synchronisations, after one call
    each: the partitioned forward and Adam step in ``PARTITION_SHARDS`` local
    shards, and the dense single-device forward of the same molecule."""
    import copy

    import torch

    from chemprop_tpu_torch.data import collate_batch
    from chemprop_tpu_torch.parallel import partitioned_mp as pm
    from chemprop_tpu_torch.train.trainer import TrainState

    model = copy.deepcopy(model).to("cuda")
    g, dims = pm.build_partitioned_graph(datum.mg, PARTITION_SHARDS)
    dg = pm.place(g, dims, pm.LocalExchange(PARTITION_SHARDS), "cuda")
    apply = pm.make_partitioned_apply(model, PARTITION_SHARDS, dims)
    params = dict(model.named_parameters())
    state = TrainState(params, {}, [torch.zeros_like(p) for p in params.values()],
                       [torch.zeros_like(p) for p in params.values()], 0,
                       torch.Generator(device="cuda").manual_seed(0))
    step = pm.make_partitioned_train_step(model, PARTITION_SHARDS, dims, lr=PARTITION_LR)
    y, w = torch.as_tensor(datum.y, device="cuda")[None], torch.ones(1, device="cuda")
    b = collate_batch([datum]).to("cuda")

    def dense():
        with torch.inference_mode():
            model(b.bmg)

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    return {"partitioned_forward_ms": ms(lambda: apply(dg)),
            "partitioned_step_ms": ms(lambda: step(state, dg, y, w)),
            "dense_forward_ms": ms(dense), "reps": reps}


def hold_step(tag: str, got, want) -> dict:
    """Fail unless two forwards, losses and stepped parameters agree: the
    forward within ``PARTITION_FWD_LIMITS``, the loss within rtol 1e-4, the
    parameters as phase 4(b) holds one f32 step (every element within twice
    the rate, all but a thousandth within rtol 1e-4 / atol 1e-6)."""
    rtol, atol = PARTITION_FWD_LIMITS
    fwd_gap = float((got[0] - want[0]).abs().max())
    n_off = n_all = 0
    worst = 0.0
    for name, w in want[2].items():
        err = (got[2][name] - w).abs()
        worst = max(worst, float(err.max()))
        n_off += int((err > 1e-6 + 1e-4 * w.abs()).sum())
        n_all += err.numel()
    res = {"forward_max_abs_diff": fwd_gap, "forward_limits_rtol_atol": [rtol, atol],
           "loss": got[1], "loss_other": want[1], "loss_rtol": 1e-4,
           "max_abs_param_diff": worst, "limit_abs_param_diff": 2 * PARTITION_LR,
           "params_outside_rtol_1e-4": n_off, "params": n_all, "limit_share_outside": 1e-3}
    if not torch_allclose(got[0], want[0], rtol, atol):
        fail(f"{tag}: the forward parts by {fwd_gap}")
    if abs(got[1] - want[1]) > 1e-4 * abs(want[1]):
        fail(f"{tag}: loss {got[1]} against {want[1]}")
    if worst > 2 * PARTITION_LR * (1 + 1e-3) or n_off > 1e-3 * n_all:
        fail(f"{tag}: the stepped parameters part ({worst}, {n_off} of {n_all})")
    return res


def torch_allclose(a, b, rtol: float, atol: float) -> bool:
    import torch

    return bool(torch.isfinite(a).all()) and bool(torch.allclose(a, b, rtol=rtol, atol=atol))


def edge_partition_run(launches: dict, unserved: dict, seed: int) -> dict:
    """Phase 17(a): the giant polymer in ``PARTITION_SHARDS`` local shards,
    the partitioned forward and one Adam step of the default model in f32 on
    the card, rehearsed on the CPU (C and I exactly the rehearsal's
    launches, nothing else), against the rehearsal, against the same run on
    the card with the plain versions of C and I, and against the card's dense
    single-device forward and step."""
    from chemprop_tpu_torch.ops import LAUNCHES

    datum = giant_datum()
    model = partitionable_model(seed)
    runs = {}

    def run(dev):
        runs[dev or "cuda"] = partitioned_step(model, datum, PARTITION_SHARDS, dev)
        return runs[dev or "cuda"]

    rehearsed("edge_partition_float32", run, launches, unserved)
    got = launches["edge_partition_float32"]
    if set(got) != {"sorted_segment_sum", "row_gather"}:
        fail(f"the partitioned path launched {got}: C and I alone")
    with plain_halo_ops():
        LAUNCHES.clear()
        plain = partitioned_step(model, datum, PARTITION_SHARDS, None)
        if LAUNCHES:
            fail(f"the plain run launched {dict(LAUNCHES)}")
    dense = dense_step(model, datum)
    card, dims = runs["cuda"], runs["cuda"][4]
    res = {"atoms": int(datum.mg.V.shape[0]), "directed_edges": int(datum.mg.E.shape[0]),
           "shards": PARTITION_SHARDS, "dims": dims._asdict(), "launches": got,
           "partitioned_forward_s": card[3],
           "vs_cpu_rehearsal": hold_step("edge partition: card against the CPU", card,
                                         runs["cpu"]),
           "vs_plain_on_card": hold_step("edge partition: kernels against plain versions",
                                         card, plain),
           "vs_dense_on_card": hold_step("edge partition: partitioned against dense", card,
                                         dense),
           "timings": partition_timings(model, datum)}
    return res


def sharded_world_1(batch, launches: dict) -> dict:
    """Phase 17(b): ``Trainer(mesh=...)`` over a process group of one on
    NCCL, ``SHARDED_STEPS`` steps of the default model with batch norm on
    the benchmark batch in f32 and bf16, against the plain ``Trainer``: the
    same loss and parameter bits, the same launches, and nothing unserved
    that the plain steps leave served."""
    import torch
    import torch.distributed as dist

    from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED
    from chemprop_tpu_torch.parallel import distributed, make_mesh
    from chemprop_tpu_torch.train import Trainer

    res = {}
    mesh = make_mesh()
    try:
        if dist.get_backend() != "nccl" or mesh.size != 1:
            fail(f"the group is {dist.get_backend()} of {mesh.size}")
        for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            out = {}
            for tag, m in (("plain", None), ("sharded", mesh)):
                torch.manual_seed(0)
                trainer = Trainer(default_model(dt), max_epochs=50, warmup_epochs=2, seed=12,
                                  mesh=m)
                trainer.init_state(batch, 4)
                before = dict(UNSERVED)
                LAUNCHES.clear()
                losses = [trainer.train_step(batch) for _ in range(SHARDED_STEPS)]
                torch.cuda.synchronize()
                out[tag] = (torch.stack(losses).cpu(), dict(LAUNCHES), unserved_since(before),
                            {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()})
            (lp, kp, up, sp), (ls, ks, us, ss) = out["plain"], out["sharded"]
            launches[f"sharded_world1_{name}"] = ks
            same_bits = torch.equal(lp, ls) and all(torch.equal(sp[k], ss[k]) for k in sp)
            res[name] = {"losses": ls.tolist(), "bit_equal_to_plain": same_bits,
                         "launches": ks, "plain_launches": kp, "unserved": us,
                         "plain_unserved": up}
            if not same_bits:
                fail(f"sharded {name} steps at world size 1 differ from the plain trainer's")
            if ks != kp:
                fail(f"sharded {name} steps launched {ks}, the plain steps {kp}")
            if any(n > up.get(k, 0) for k, n in us.items()):
                fail(f"sharded {name} steps left {us} unserved, the plain steps {up}")
    finally:
        distributed.shutdown()
    return res


def parallel_cli(out_dir: Path, launches: dict) -> dict:
    """Phase 17(c): ``train``, ``predict`` and ``fingerprint`` with
    ``--edge-partition`` on mol.csv's first rows and the giant polymer, on the
    card and on the CPU: the train loss within rtol 1e-4 and the test
    predictions within 1e-3 (a few Adam steps apart in summation order);
    ``predict`` and ``fingerprint`` of the card's ``best.ckpt`` at phase 3's
    limits. Each card run must launch C and I."""
    import numpy as np

    rows = list(csv.reader(open(MOL_CSV)))
    data = out_dir / "giant.csv"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(data, "w", newline="") as f:
        w = csv.writer(f)
        w.writerows(rows[: 1 + PARALLEL_CLI_ROWS])
        w.writerow(["C1(CCCCC1)" * GIANT_RINGS, "1.5"])
    res = {}
    hist = {}
    for dev in (None, "cpu"):
        from chemprop_tpu_torch.ops import LAUNCHES

        LAUNCHES.clear()
        hist[dev] = mc_train(out_dir / f"train_{dev or 'cuda'}", "float32", dev,
                             ["-i", data, *PARALLEL_CLI_FLAGS])
        if dev is None:
            launches["cli_train_edge_partition"] = dict(LAUNCHES)
    lc, lp = hist[None][0]["train_loss"], hist["cpu"][0]["train_loss"]
    res["train_loss"] = {"cuda": lc, "cpu": lp, "rtol": 1e-4}
    if abs(lc - lp) > 1e-4 * abs(lp):
        fail(f"train --edge-partition: loss {lc} on the card, {lp} on the CPU")
    tables = {d: predict_table(out_dir / f"train_{d}" / "test_predictions.csv")
              for d in ("cuda", "cpu")}
    gap = float(np.abs(tables["cuda"][2] - tables["cpu"][2]).max())
    res["test_predictions_max_abs_diff"] = gap
    if not np.allclose(tables["cuda"][2], tables["cpu"][2], rtol=1e-3, atol=1e-3):
        fail(f"train --edge-partition: test predictions part by {gap}")
    ckpt = out_dir / "train_cuda" / "best.ckpt"
    for sub, extra in (("predict", []), ("fingerprint", ["--ffn-block-index", "0"])):
        outs = {}
        for dev in (None, "cpu"):
            from chemprop_tpu_torch.ops import LAUNCHES

            LAUNCHES.clear()
            outs[dev] = run_cli(sub, ["-i", data, "--model-paths", ckpt, "--edge-partition",
                                      PARTITION_SHARDS, *extra],
                                out_dir / f"{sub}_{dev or 'cuda'}.csv", dev)
            if dev is None:
                launches[f"cli_{sub}_edge_partition"] = dict(LAUNCHES)
        res[sub] = {"max_abs_diff": hold_to_cpu(f"{sub} --edge-partition", outs[None],
                                                outs["cpu"], 1e-5, 1e-4)}
    for tag in ("cli_train_edge_partition", "cli_predict_edge_partition",
                "cli_fingerprint_edge_partition"):
        if not (launches[tag].get("sorted_segment_sum") and launches[tag].get("row_gather")):
            fail(f"{tag} launched {launches[tag]}: C and I must run")
        res[tag] = launches[tag]
    return res


def parallel_phase(batch, card: str, seed: int) -> tuple[dict, dict]:
    """Phase 17: (a) the edge partition in one process, (b) the sharded step
    at world size 1 over NCCL, (c) the command line; each part fatal. Its
    seconds and numbers on their own lines with the card's name and power
    limit."""
    import tempfile

    t0 = time.time()
    launches, unserved, res = {}, {}, {}
    res["edge_partition"] = edge_partition_run(launches, unserved, seed)
    print(json.dumps({"edge_partition": res["edge_partition"], "card": card}))
    res["sharded_world_1"] = sharded_world_1(batch, launches)
    print(json.dumps({"sharded_world_1": res["sharded_world_1"], "card": card}))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        res["cli"] = parallel_cli(Path(tmp), launches)
    res["unserved"] = unserved
    res["seconds"] = time.time() - t0
    print(json.dumps({"phase": "parallel", "seconds": res["seconds"], "cli": res["cli"],
                      "card": card}))
    return launches, res


# ---------------------------------------------------------------- phase 18
V1_MULTI_NOISE = 0.05  # the second encoder: the first one's tensors plus this noise
V1_MULTI_SEED = 25


def two_molecule_v1(out: Path, dataset_type: str = "regression", shared: bool = False,
                    seed: int = V1_MULTI_SEED) -> Path:
    """A chemprop v1 file of two molecules, built from the reference v1 file
    (no golden one exists; the tests and phase 18 build it by this recipe):
    ``number_of_molecules=2``; a second encoder ``encoder.encoder.1``, the
    first one's tensors plus seeded normal noise of scale ``V1_MULTI_NOISE``
    (with ``shared``: ``mpn_shared`` and the first one's tensors repeated,
    as v1 saves a shared encoder); the readout's first layer widened to 600
    inputs by seeded columns of its own weights' spread. ``"classification"``
    makes it a binary head without the output unscaling."""
    import argparse as _argparse

    import numpy as np
    import torch

    from chemprop_tpu_torch.models.load import load_checkpoint

    d = load_checkpoint(V1_CKPT)
    rng = np.random.default_rng(seed)
    sd = dict(d["state_dict"])
    for k, v in list(sd.items()):
        if k.startswith("encoder.encoder.0."):
            noise = 0 if shared or k.endswith("cached_zero_vector") else torch.from_numpy(
                rng.normal(0.0, V1_MULTI_NOISE, tuple(v.shape)).astype(np.float32))
            sd[k.replace(".0.", ".1.", 1)] = v + noise
    W = sd["readout.1.weight"]
    more = rng.normal(0.0, float(W.std()), tuple(W.shape)).astype(np.float32)
    sd["readout.1.weight"] = torch.cat([W, torch.from_numpy(more)], dim=1)
    d["state_dict"] = sd
    d["args"] = _argparse.Namespace(**{
        **vars(d["args"]), "number_of_molecules": 2, "mpn_shared": shared,
        "smiles_columns": ["smiles", "solvent"], "dataset_type": dataset_type})
    if dataset_type != "regression":
        d["data_scaler"] = None
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(d, out)
    return out


V1_MULTI_FLAGS = ["-i", _MM, "-s", "smiles", "solvent"]
# phase 18(a): the kernels each dtype's runs launch; mol+mol's dyes give
# their component a split table, over which A takes its second pass
V1_MULTI_PATHS = {"float32": {"message", "message_rows", "sorted_segment_sum"},
                  "bfloat16": {"fused_iter", "sorted_segment_sum"}}
SPD_EPOCHS, SPD_K = 3, 4  # phase 18(c): epochs of each fit, steps_per_dispatch
# phase 18(a): bf16 on the card and on the CPU are two roundings of one f32
# computation (the card's products accumulate in another order), so they may
# part by twice what bf16 rounding moves either from the f32 output. The
# synthetic file's noised encoder and random readout columns make its bf16
# output move more than the reference checkpoints' do: on the H100 (700 W)
# its bf16 predictions on the card parted from the CPU's by 0.0030 in units
# of the unscaling, against phase 3's 1e-3, while the CPU's own bf16 lay
# 0.0038 from its f32 (and the card's f32 5.7e-07 from the CPU's)
V1_MULTI_BF16 = 2.0


def v1_multi_runs(out_dir: Path, launches: dict, unserved: dict) -> dict:
    """Phase 18(a): the two-molecule v1 file (``two_molecule_v1``) through
    ``predict`` and ``fingerprint`` on every row of mol+mol.csv in f32 and
    bf16, its featurizer mode found by the command line; on the card after a
    CPU rehearsal (launches and calls without a tile table exactly the
    rehearsal's: A (B in bf16) and C for each component, mol+mol's dyes of
    more than 128 directed edges leaving some f32 A calls without a table).
    The card's output is held to the CPU's in units of the unscaling's
    standard deviation (predictions) or of the CPU's RMS (fingerprints): f32
    at phase 3's limits; bf16 within phase 3's 1e-3, or twice as far as
    bf16 rounding moves the CPU's own output from its f32 output where that
    is further (``V1_MULTI_BF16``), and within phase 3's bf16 envelope of
    the f32 output."""
    import numpy as np

    from chemprop_tpu_torch.models import load_model

    src = two_molecule_v1(out_dir / "two_molecules_v1.pt")
    model, _ = load_model(src, "cpu")
    if type(model).__name__ != "MulticomponentMPNN" or model.predictor.input_dim != 600:
        fail(f"the two-molecule v1 file loaded as {type(model).__name__}")
    scale = model.predictor.output_transform.scale.numpy().reshape(1, -1)
    n_rows = len(read_rows(_MM)[1])
    res = {}
    for sub, width in (("predict", 1), ("fingerprint", 300)):
        f32_cpu = None
        for dt in ("float32", "bfloat16"):
            tag = f"{sub}_v1_two_molecules_{dt}"
            got, cpu = rehearsed(tag, lambda dev: predict_table(run_cli(
                sub, ["--model-path", src, *V1_MULTI_FLAGS, "--dtype", dt],
                out_dir / f"{tag}_{dev or 'cuda'}.csv", dev))[2], launches, unserved)
            if got.shape != (n_rows, width) or not np.isfinite(got).all():
                fail(f"{tag} wrote {got.shape}, expected {(n_rows, width)} finite values")
            if set(launches[tag]) != V1_MULTI_PATHS[dt]:
                fail(f"{tag} launched {launches[tag]}, expected {sorted(V1_MULTI_PATHS[dt])}")
            unit = scale if sub == "predict" else float(np.sqrt((cpu ** 2).mean()))
            r = res[tag] = {"shape": list(got.shape), "launches": launches[tag],
                            "vs_cpu_scaled": float(np.abs(got - cpu).max() / np.min(unit))}
            if dt == "float32":
                f32_cpu = cpu
                hold_scaled(tag, got, cpu, unit, dt)
                continue
            rounding = float(np.abs(cpu - f32_cpu).max() / np.min(unit))
            r["cpu_bf16_vs_f32_scaled"], r["limit"] = rounding, max(1e-3, V1_MULTI_BF16 * rounding)
            if not r["vs_cpu_scaled"] <= r["limit"]:
                fail(f"{tag}: the card's output parts from the CPU's beyond its limit: {r}")
            if not np.allclose(got / unit, f32_cpu / unit, rtol=0.05, atol=0.1):
                fail(f"{tag}: the card's bf16 output leaves the f32 envelope: {r}")
    return res


def subcommand_cli(out_dir: Path, launches: dict, unserved: dict) -> dict:
    """Phase 18(b): ``python -m chemprop_tpu_torch.cli --version`` in a new
    process, and one f32 ``train`` epoch on mol.csv through the parser that
    ``construct_parser`` builds from the ``*Subcommand`` classes, rehearsed,
    its loss within phase 9(a)'s f32 limit of the CPU's."""
    import numpy as np

    from chemprop_tpu_torch import __version__
    from chemprop_tpu_torch.cli.main import construct_parser
    from chemprop_tpu_torch.cli.train import TrainSubcommand

    proc = subprocess.run([sys.executable, "-m", "chemprop_tpu_torch.cli", "--version"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 or proc.stdout.strip() != __version__:
        fail(f"--version gave {proc.returncode}: {proc.stdout!r} {proc.stderr[-2000:]!r}")
    args = construct_parser().parse_args(["train", "-i", str(MOL_CSV)])
    if args.func != TrainSubcommand.func:
        fail("the parser's train does not run TrainSubcommand.func")
    tag = "train_subcommand_float32"
    card, cpu = rehearsed(tag, lambda dev: mc_train(
        out_dir / f"{tag}_{dev or 'cuda'}", "float32", dev, ["-i", MOL_CSV]), launches, unserved)
    r = {"version": proc.stdout.strip(), "train_loss": card[0]["train_loss"],
         "train_loss_cpu": cpu[0]["train_loss"], "launches": launches[tag]}
    if not np.isclose(r["train_loss"], r["train_loss_cpu"], rtol=1e-4, atol=0):
        fail(f"{tag}: the epoch's loss on cuda disagrees with the CPU's: {r}")
    return r


def steps_per_dispatch_fits(ds, launches: dict) -> dict:
    """Phase 18(c): two bf16 fits of the default model, ``SPD_EPOCHS`` epochs
    of shuffled batches of 32 from one seed, one with
    ``steps_per_dispatch=SPD_K``: the same loss history and parameters bit
    for bit, each fit launching exactly its steps' kernels and leaving
    nothing unserved."""
    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED
    from chemprop_tpu_torch.train import Trainer

    runs = []
    for K in (None, SPD_K):
        trainer = Trainer(default_model(torch.bfloat16), max_epochs=SPD_EPOCHS, warmup_epochs=1,
                          seed=25, steps_per_dispatch=K)
        loader = DataLoader(ds, batch_size=32, shuffle=True, seed=3)
        before, tag = dict(UNSERVED), f"train_bfloat16_steps_per_dispatch_{K}"
        LAUNCHES.clear()
        trainer.fit(loader)
        torch.cuda.synchronize()
        launches[tag] = dict(LAUNCHES)
        check_path_launches("train_bfloat16", launches[tag], exact=True, want=path_launches(
            "predict_bfloat16", 0, "train_bfloat16", SPD_EPOCHS * len(loader)))
        if unserved_since(before):
            fail(f"{tag} left calls unserved: {unserved_since(before)}")
        runs.append(trainer)
    (a, b), res = runs, {}
    res["losses"] = [[h["train_loss"] for h in t.history] for t in runs]
    res["equal_history"] = all(
        {k: v for k, v in x.items() if k not in ("time_s", "edges_per_s")}
        == {k: v for k, v in y.items() if k not in ("time_s", "edges_per_s")}
        for x, y in zip(a.history, b.history, strict=True))
    res["equal_parameters"] = all(torch.equal(v, b.state.params[k])
                                  for k, v in a.state.params.items())
    if not (res["equal_history"] and res["equal_parameters"]):
        fail(f"a bf16 fit with steps_per_dispatch={SPD_K} differs from one without it: {res}")
    return res


def v1_multi_phase(ds, card: str) -> tuple[dict, dict]:
    """Phase 18: (a) v1 files of two molecules, (b) the command line's
    ``Subcommand``-built parser, (c) ``Trainer.steps_per_dispatch``; each
    part fatal. Its seconds on their own line with the card's name and power
    limit."""
    t0 = time.time()
    launches, unserved, res = {}, {}, {}
    out_dir = REPO / "chiprun_out" / "chip_smoke_v1_multi"
    out_dir.mkdir(parents=True, exist_ok=True)
    parts = (("v1_two_molecules", lambda: v1_multi_runs(out_dir, launches, unserved)),
             ("cli", lambda: subcommand_cli(out_dir, launches, unserved)),
             ("steps_per_dispatch", lambda: steps_per_dispatch_fits(ds, launches)))
    res["part_seconds"] = {}
    for name, run in parts:
        t = time.time()
        res[name] = run()
        res["part_seconds"][name] = time.time() - t
    res["unserved"] = unserved
    res["seconds"] = time.time() - t0
    print(json.dumps({"v1_multi_phase": res}))
    print(json.dumps({"v1_multi_unserved": unserved}))
    print(json.dumps({"phase": "v1_multi", "seconds": res["seconds"], "card": card}))
    return launches, res


# phase 19: the fit's epochs and batch size, and the loader's shuffle seed
PIPELINE_EPOCHS = 3
PIPELINE_BATCH = 32
PIPELINE_SEED = 19


class counted_syncs:
    """``with counted_syncs() as counts:`` the block's synchronising CUDA calls
    (``torch.cuda.set_sync_debug_mode("warn")``'s warnings) in
    ``counts["syncs"]``, by the Python line that made each in
    ``counts["where"]``, and in ``counts["readbacks"]`` the tile tables that
    ``check_tiles`` found on the card without their host check (each would be
    read back)."""

    def __enter__(self):
        import importlib
        import warnings

        import torch

        # the module, which the package's ``message`` function shadows
        message = importlib.import_module("chemprop_tpu_torch.ops.message")
        self.counts = {"syncs": 0, "readbacks": 0}
        self._warnings = warnings.catch_warnings(record=True)
        self._records = self._warnings.__enter__()
        warnings.simplefilter("always")
        self._check = check = message.check_tiles

        def counted(tiles, n_edges, device):
            if tiles.device.type == "cuda" and getattr(tiles, "checked_for_rows", None) != n_edges:
                self.counts["readbacks"] += 1
            return check(tiles, n_edges, device)

        message.check_tiles = counted
        torch.cuda.set_sync_debug_mode("warn")
        return self.counts

    def __exit__(self, *exc):
        import importlib

        import torch

        torch.cuda.set_sync_debug_mode(0)
        importlib.import_module("chemprop_tpu_torch.ops.message").check_tiles = self._check
        syncs = [w for w in self._records if "synchronizing CUDA operation" in str(w.message)]
        self.counts["syncs"] = len(syncs)
        where: dict = {}
        for w in syncs:
            path = Path(w.filename)
            line = f"{path.relative_to(REPO) if path.is_relative_to(REPO) else path}:{w.lineno}"
            where[line] = where.get(line, 0) + 1
        self.counts["where"] = where
        self._warnings.__exit__(*exc)
        return False


def pipeline_trainer(device, mesh=None):
    import torch

    from chemprop_tpu_torch.train import Trainer

    return Trainer(default_model(torch.bfloat16), max_epochs=PIPELINE_EPOCHS, warmup_epochs=1,
                   seed=26, device=device, mesh=mesh)


def pipeline_loader(ds, prefetch: int):
    from chemprop_tpu_torch.data import DataLoader

    return DataLoader(ds, batch_size=PIPELINE_BATCH, shuffle=True, seed=PIPELINE_SEED,
                      prefetch=prefetch)


def plain_epochs(trainer, loader, epochs: int) -> list[dict]:
    """``fit``'s epochs as a loop of ``train_step`` over the host batches: each
    epoch's mean loss (one fetch per epoch), seconds and real edges per
    second."""
    import torch

    out = []
    for epoch in range(epochs):
        t0, losses, edges = time.time(), [], 0
        for host in loader:
            edges += sum(int(g.edge_mask.sum()) for g in host.graphs)
            losses.append(trainer.train_step(host))
        loss = float(torch.stack(losses).mean())
        dt = time.time() - t0
        out.append({"epoch": epoch, "train_loss": loss, "time_s": dt, "edges_per_s": edges / dt})
    return out


def device_busy_ms(prof) -> float | None:
    """The union of a trace's device intervals (kernels and copies, which the
    copy stream overlaps), in ms; None where the trace holds none."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    return (busy + hi - lo) / 1e3


def pipeline_sharded_fit(fit, ds, launches: dict, tag: str) -> dict:
    """Phase 19(e): the same fit with ``mesh`` at world size 1 over NCCL (each
    rank's ``Shard`` moved ahead by the device prefetch): the same losses and
    parameters bit for bit, and the same launches."""
    import torch

    from chemprop_tpu_torch.ops import LAUNCHES
    from chemprop_tpu_torch.parallel import distributed, make_mesh

    mesh = make_mesh()
    try:
        trainer = pipeline_trainer(None, mesh)
        loader = pipeline_loader(ds, 2)
        trainer.init_state(None, len(loader))
        LAUNCHES.clear()
        trainer.fit(loader)
        torch.cuda.synchronize()
        launches[f"{tag}_sharded_world1"] = dict(LAUNCHES)
    finally:
        distributed.shutdown()
    res = {"losses": [h["train_loss"] for h in trainer.history],
           "equal_to_the_fit": [h["train_loss"] for h in trainer.history]
           == [h["train_loss"] for h in fit.history] and all(
               torch.equal(v, fit.state.params[k]) for k, v in trainer.state.params.items()),
           "launches": launches[f"{tag}_sharded_world1"]}
    if not res["equal_to_the_fit"]:
        fail(f"the sharded fit at world size 1 differs from the plain fit: {res}")
    if res["launches"] != launches[tag]:
        fail(f"the sharded fit launched {res['launches']}, the plain fit {launches[tag]}")
    return res


def input_pipeline_phase(card: str):
    """Phase 19: the fit through the loader's thread, the forked cache and the
    device prefetch, rehearsed, against a plain loop of ``train_step`` bit
    for bit, with their synchronisations counted; each part fatal. Returns
    the launches, the results and a function that traces one more epoch of
    the fit (run after every untraced timing) for the idle share."""
    import numpy as np
    import torch

    from chemprop_tpu_torch.ops import LAUNCHES

    t0 = time.time()
    launches, unserved, res = {}, {}, {}
    if not torch.cuda.is_initialized():
        fail("phase 19 forks its featurisation workers after CUDA is up, and CUDA is not")
    serial, forked = lipo_dataset(0), lipo_dataset(2)
    res["forked_cache_equal"] = all(
        all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(g, h, strict=True))
        for g, h in zip(serial._cache, forked._cache, strict=True))
    if not res["forked_cache_equal"]:
        fail("the cache of two forked workers differs from the serial one")

    fits, syncs, tag = {}, {}, "train_bfloat16_input_pipeline"

    def run(dev):
        trainer = pipeline_trainer(dev)
        loader = pipeline_loader(forked, 2)
        trainer.init_state(None, len(loader))
        if dev is None:
            torch.cuda.synchronize()
            with counted_syncs() as counts:
                trainer.fit(loader)
            syncs["prefetch"] = counts
        else:
            trainer.fit(loader)
        fits[dev or "cuda"] = trainer
        return trainer

    rehearsed(tag, run, launches, unserved)
    steps = PIPELINE_EPOCHS * len(pipeline_loader(serial, 0))
    check_path_launches("train_bfloat16", launches[tag], exact=True,
                        want=path_launches("predict_bfloat16", 0, "train_bfloat16", steps))
    fit = fits["cuda"]

    plain = pipeline_trainer(None)
    loader = pipeline_loader(serial, 0)
    plain.init_state(None, len(loader))
    torch.cuda.synchronize()
    LAUNCHES.clear()
    with counted_syncs() as counts:
        epochs = plain_epochs(plain, loader, PIPELINE_EPOCHS)
    syncs["plain_loop"] = counts
    launches["train_bfloat16_plain_loop"] = dict(LAUNCHES)
    if launches["train_bfloat16_plain_loop"] != launches[tag]:
        fail(f"the plain loop launched {launches['train_bfloat16_plain_loop']}, the pipeline's "
             f"fit {launches[tag]}")

    res["losses"] = [h["train_loss"] for h in fit.history]
    res["equal_losses"] = res["losses"] == [e["train_loss"] for e in epochs]
    res["equal_parameters"] = all(torch.equal(v, plain.state.params[k])
                                  for k, v in fit.state.params.items())
    res["equal_batch_stats"] = all(torch.equal(v, plain.state.batch_stats[k])
                                   for k, v in fit.state.batch_stats.items())
    res["sharded_world_1"] = pipeline_sharded_fit(fit, forked, launches, tag)
    # the fit without the loader's thread: the device prefetch alone
    inline = pipeline_trainer(None)
    inline.init_state(None, len(loader))
    inline.fit(pipeline_loader(forked, 0))
    res["equal_without_the_loader_thread"] = [h["train_loss"] for h in inline.history] == \
        res["losses"] and all(torch.equal(v, inline.state.params[k])
                              for k, v in fit.state.params.items())
    for how in syncs.values():
        how["per_epoch"] = how["syncs"] / PIPELINE_EPOCHS
    res["syncs"] = syncs
    keys = ("epoch", "train_loss", "time_s", "edges_per_s")
    res["epochs"] = {"prefetch": [{k: h[k] for k in keys} for h in fit.history],
                     "device_prefetch_alone": [{k: h[k] for k in keys} for h in inline.history],
                     "plain_loop": epochs}
    res["unserved"] = unserved
    res["seconds"] = time.time() - t0
    print(json.dumps({"input_pipeline_epochs": res["epochs"]}))
    print(json.dumps({"input_pipeline_syncs": syncs}))
    print(json.dumps({"input_pipeline": {k: v for k, v in res.items() if k != "epochs"}}))
    if not (res["equal_losses"] and res["equal_parameters"] and res["equal_batch_stats"]
            and res["equal_without_the_loader_thread"]):
        fail("the pipeline's fit differs from the plain loop of train_step")
    # the only wait for the device an epoch needs is its loss fetch
    if syncs["prefetch"]["per_epoch"] != syncs["plain_loop"]["per_epoch"] or \
            syncs["prefetch"]["per_epoch"] > 1:
        fail(f"synchronisations per epoch: {syncs}")
    if syncs["prefetch"]["readbacks"] or syncs["plain_loop"]["readbacks"]:
        fail(f"check_tiles read tile tables back from the card: {syncs}")
    print(json.dumps({"phase": "input_pipeline", "seconds": res["seconds"], "card": card}))

    def traced_epoch() -> dict:
        """One more epoch of the fit under ``torch.profiler``: the union of
        its device intervals against its own wall time and against the
        untraced epochs' (all but the first)."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        untraced = statistics.median(h["time_s"] for h in fit.history[1:])
        fit.start_epoch, fit.max_epochs = PIPELINE_EPOCHS, PIPELINE_EPOCHS + 1
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fit.fit(pipeline_loader(forked, 2))
            torch.cuda.synchronize()
        busy = device_busy_ms(prof)
        traced = fit.history[-1]["time_s"]
        if busy is None:
            return {"device_busy_ms": "not measured: the trace holds no device events",
                    "traced_epoch_s": traced, "untraced_epoch_s": untraced}
        return {"device_busy_ms": busy, "traced_epoch_s": traced, "untraced_epoch_s": untraced,
                "idle_share_traced": 1 - busy / 1e3 / traced,
                "idle_share": 1 - busy / 1e3 / untraced}

    return launches, res, traced_epoch


# phase 20: the mixed dataset (mol.csv's rows with giants at these rows), its
# fit's epochs, batch size and shuffle seed, and the mol-atom-bond checkpoint
# and batch size of part (b)
ISOLATION_GIANT = "C1(CCCCC1)" * 40  # 480 directed edges: over one molecule's 385
ISOLATION_ROWS = (10, 40, 70, 95)
ISOLATION_EPOCHS = 3
ISOLATION_BATCH = 32
ISOLATION_SEED = 23
ISOLATION_MAB = MAB_MODELS / "regression.pt"
ISOLATION_MAB_BATCH = 4
# the examples run with --quick on the card; empty while (c) stays within
# ISOLATION_EXAMPLES_S
EXAMPLES_QUICK: tuple = ()
ISOLATION_EXAMPLES_S = 300


def mixed_dataset():
    """mol.csv's 100 rows with ``ISOLATION_GIANT`` at ``ISOLATION_ROWS`` (104
    rows), targets normalised, featurised once; and the giants' rows."""
    import numpy as np

    from chemprop_tpu_torch.data import MoleculeDatapoint, MoleculeDataset

    with open(MOL_CSV, newline="") as f:
        rows = [(s, float(y)) for s, y in list(csv.reader(f))[1:]]
    for i in ISOLATION_ROWS:
        rows.insert(i, (ISOLATION_GIANT, 0.0))
    ds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=np.array([y])) for s, y in rows])
    ds.normalize_targets()
    ds.cache = True
    if [i for i, (s, _) in enumerate(rows) if s == ISOLATION_GIANT] != list(ISOLATION_ROWS):
        fail("the mixed dataset's giants are not at ISOLATION_ROWS")
    return ds


class per_batch:
    """``with per_batch(loader, fn) as rec:`` each index batch ``loader``
    collates, and the ``ops.UNSERVED`` calls of each call of ``fn`` (a
    trainer's ``train_step`` or a model's ``forward``, patched on the
    instance), in order, in ``rec["batches"]`` and ``rec["unserved"]``."""

    def __init__(self, loader, owner, attr: str):
        self.loader, self.owner, self.attr = loader, owner, attr

    def __enter__(self):
        from chemprop_tpu_torch.ops import UNSERVED

        rec = self.rec = {"batches": [], "unserved": []}
        make, fn = self.loader._make_batch, getattr(self.owner, self.attr)

        def made(idxs):
            rec["batches"].append(list(idxs))
            return make(idxs)

        def counted(*a, **k):
            before = dict(UNSERVED)
            out = fn(*a, **k)
            rec["unserved"].append(unserved_since(before))
            return out

        self.loader._make_batch = made
        setattr(self.owner, self.attr, counted)
        return rec

    def __exit__(self, *exc):
        del self.loader._make_batch
        delattr(self.owner, self.attr)
        return False


def isolated_share(tag: str, rec: dict, giants: set) -> dict:
    """The calls without a tile table in the batches of giants and in the
    others; fatal where a batch has any (the giants' batches take their
    split tables), or where a batch mixes both kinds (the loader isolated
    nothing)."""
    if len(rec["batches"]) != len(rec["unserved"]):
        fail(f"{tag}: {len(rec['batches'])} batches collated, {len(rec['unserved'])} calls")
    out = {"isolated_batches": 0, "isolated": {}, "other": {}}
    for idxs, calls in zip(rec["batches"], rec["unserved"]):
        kinds = {i in giants for i in idxs}
        if kinds == {True, False}:
            fail(f"{tag}: batch {idxs} mixes giants and small molecules")
        key = "isolated" if kinds == {True} else "other"
        out["isolated_batches"] += key == "isolated"
        for k, v in calls.items():
            out[key][k] = out[key].get(k, 0) + v
    if out["other"] or out["isolated"]:
        fail(f"{tag}: batches left calls without a tile table: {out}")
    return out


def summed_calls(calls: list) -> dict:
    """The ``ops.UNSERVED`` calls of a record's batches, added up."""
    out: dict = {}
    for c in calls:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def isolation_trainer(device, dtype=None, state: dict | None = None):
    """The default model's trainer (phase 4's model, batch norm, mean readout)
    at ``ISOLATION_EPOCHS``; with ``state`` its parameters and statistics
    loaded (another dtype's trained ones) and kept."""
    import torch

    from chemprop_tpu_torch.train import Trainer

    trainer = Trainer(default_model(dtype or torch.bfloat16), max_epochs=ISOLATION_EPOCHS,
                      warmup_epochs=1, seed=27, device=device)
    if state is not None:
        trainer.model.load_state_dict(state)
        trainer.init_state(None, 1, keep_parameters=True)
    return trainer


def isolation_fit(ds, device, isolate: bool = True) -> tuple:
    """The bf16 fit in shuffled batches, each step's calls without a tile
    table recorded: the trainer and the record."""
    from chemprop_tpu_torch.data import DataLoader

    trainer = isolation_trainer(device)
    loader = DataLoader(ds, batch_size=ISOLATION_BATCH, shuffle=True, seed=ISOLATION_SEED)
    loader._isolate_oversized = isolate
    trainer.init_state(None, len(loader))
    with per_batch(loader, trainer, "train_step") as rec:
        trainer.fit(loader)
    return trainer, rec


def isolation_predict(ds, state: dict, dtype, device, batch_size: int,
                      isolate: bool = True) -> tuple:
    """A fixed-order ``predict`` of the fit's weights in ``dtype``: the
    predictions and the record of each forward."""
    from chemprop_tpu_torch.data import DataLoader

    trainer = isolation_trainer(device, dtype, state)
    loader = DataLoader(ds, batch_size=batch_size)
    loader._isolate_oversized = isolate
    with per_batch(loader, trainer.model, "forward") as rec:
        preds = trainer.predict(loader)
    return preds, rec


def isolation_mixed(ds, launches: dict, unserved: dict) -> dict:
    """Phase 20(a): the fit and the fixed-order predictions of the mixed
    dataset, rehearsed, against a batch size of 1 and without isolation."""
    import numpy as np
    import torch

    giants = set(ISOLATION_ROWS)
    res, fits = {}, {}

    def fit(dev):
        fits[dev or "cuda"] = isolation_fit(ds, dev)
        return [h["train_loss"] for h in fits[dev or "cuda"][0].history]

    tag = "train_bfloat16_isolation"
    losses, _ = rehearsed(tag, fit, launches, unserved)
    trainer, rec = fits["cuda"]
    res["fit"] = {"losses": losses, "steps": len(rec["batches"]),
                  "steps_per_epoch_by_len": -(-len(ds) // ISOLATION_BATCH),
                  "unserved": isolated_share(tag, rec, giants)}
    again, _ = isolation_fit(ds, None)
    res["fit"]["repeat_equal"] = [h["train_loss"] for h in again.history] == losses
    if not res["fit"]["repeat_equal"]:
        fail(f"two bf16 fits of the mixed dataset from one seed differ: {losses}, "
             f"{[h['train_loss'] for h in again.history]}")
    _, off = isolation_fit(ds, None, isolate=False)
    res["fit"]["unserved_without_isolation"] = summed_calls(off["unserved"])
    if res["fit"]["unserved_without_isolation"]:
        fail(f"the fit without isolation left calls without a table: {res['fit']}")
    state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    limits = {"float32": (1e-5, 1e-4), "bfloat16": (0.0, 1e-3)}  # phase 3's
    for dt_name, (rtol, atol) in limits.items():
        dt = getattr(torch, dt_name)
        tag = f"predict_{dt_name}_isolation"
        got, _ = rehearsed(tag, lambda dev: isolation_predict(ds, state, dt, dev, ISOLATION_BATCH),
                           launches, unserved)
        preds, rec = got
        one, _ = isolation_predict(ds, state, dt, None, 1)
        _, flat = isolation_predict(ds, state, dt, None, ISOLATION_BATCH, isolate=False)
        gap = float(np.abs(preds - one).max())
        res[tag] = {"vs_batch_size_1": gap, "limit": [rtol, atol],
                    "unserved": isolated_share(tag, rec, giants),
                    "unserved_without_isolation": summed_calls(flat["unserved"]),
                    "batches": len(rec["batches"]),
                    "batches_without_isolation": len(flat["batches"])}
        if res[tag]["unserved_without_isolation"]:
            fail(f"{tag} without isolation left calls without a table: {res[tag]}")
        if preds.shape != (len(ds), 1) or not np.isfinite(preds).all():
            fail(f"{tag}: predictions of shape {preds.shape}, or not finite")
        if not np.allclose(preds, one, rtol=rtol, atol=atol):
            fail(f"{tag}: the predictions in dataset order leave the batch-size-1 ones by {gap}")
    return res


def isolation_mab(launches: dict, unserved: dict) -> dict:
    """Phase 20(b): ``MABTrainer.predict`` of ``ISOLATION_MAB`` in f32 over
    regression.csv's molecules with the giant in the middle, in batches of
    ``ISOLATION_MAB_BATCH`` (rehearsed), against batch size 1: each table,
    molecule, atom and bond rows, in dataset order within phase 3's f32
    limits in units of the table's largest value."""
    import numpy as np

    from chemprop_tpu_torch.data import DataLoader, MolAtomBondDatapoint, MolAtomBondDataset
    from chemprop_tpu_torch.models import load_model
    from chemprop_tpu_torch.train import MABTrainer

    _, rows = read_rows(MAB_DIR / "regression.csv")
    smis = [r[0] for r in rows]
    smis.insert(len(smis) // 2, ISOLATION_GIANT)
    ds = MolAtomBondDataset([MolAtomBondDatapoint.from_smi(s, keep_h=True) for s in smis])
    ds.cache = True

    def predict(dev, batch_size):
        model, _ = load_model(ISOLATION_MAB, dev)
        trainer = MABTrainer(model, device=dev)
        trainer.init_state(None, 1, keep_parameters=True)
        loader = DataLoader(ds, batch_size=batch_size)
        return trainer.predict(loader), loader.emitted_order().tolist()

    tag = "predict_mab_isolation"
    (got, order), _ = rehearsed(tag, lambda dev: predict(dev, ISOLATION_MAB_BATCH), launches,
                                unserved)
    check_mab_launches(tag, launches[tag])
    one, _ = predict(None, 1)
    giant = smis.index(ISOLATION_GIANT)
    if order[-1] != giant or sorted(order) != list(range(len(smis))):
        fail(f"{tag}: the loader emitted {order}, the giant (row {giant}) not last")
    res = {"molecules": len(smis), "emitted_order": order}
    for kind, a, b in zip(("mol", "atom", "bond"), got, one):
        if a is None or b is None or a.shape != b.shape:
            fail(f"{tag}: the {kind} tables differ in shape")
        scale = max(1.0, float(np.abs(b).max()))
        gap = float(np.abs(a - b).max())
        res[kind] = {"rows": int(a.shape[0]), "vs_batch_size_1": gap, "scale": scale}
        if not np.allclose(a, b, rtol=1e-5, atol=1e-4 * scale):
            fail(f"{tag}: the {kind} table in dataset order leaves batch size 1's by {gap}")
    return res


class kept_state:
    """``with kept_state() as changed:`` what an in-process example changes of
    the process's state, put back on exit and named in ``changed``: the root
    logger's handlers and level, torch's default dtype, threads, TF32 flags
    and random state, numpy's random state, the working directory and
    ``sys.argv``."""

    def _read(self):
        import logging
        import os

        import numpy as np
        import torch

        root = logging.getLogger()
        return {"log_handlers": list(root.handlers), "log_level": root.level,
                "default_dtype": torch.get_default_dtype(), "threads": torch.get_num_threads(),
                "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
                "tf32_cudnn": torch.backends.cudnn.allow_tf32,
                "torch_rng": torch.random.get_rng_state(),
                "cuda_rng": torch.cuda.get_rng_state_all() if torch.cuda.is_available() else [],
                "numpy_rng": np.random.get_state(), "cwd": os.getcwd(), "argv": list(sys.argv)}

    def __enter__(self):
        self.saved, self.changed = self._read(), []
        return self.changed

    def __exit__(self, *exc):
        import logging
        import os

        import numpy as np
        import torch

        now = self._read()
        for k, v in self.saved.items():
            same = (all(torch.equal(a, b) for a, b in zip(v, now[k])) if k == "cuda_rng"
                    else torch.equal(v, now[k]) if k == "torch_rng"
                    else all(np.array_equal(a, b) for a, b in zip(v, now[k])) if k == "numpy_rng"
                    else v == now[k])
            if not same:
                self.changed.append(k)
        root = logging.getLogger()
        root.handlers[:] = self.saved["log_handlers"]
        root.setLevel(self.saved["log_level"])
        torch.set_default_dtype(self.saved["default_dtype"])
        torch.set_num_threads(self.saved["threads"])
        torch.backends.cuda.matmul.allow_tf32 = self.saved["tf32_matmul"]
        torch.backends.cudnn.allow_tf32 = self.saved["tf32_cudnn"]
        torch.random.set_rng_state(self.saved["torch_rng"])
        if self.saved["cuda_rng"]:
            torch.cuda.set_rng_state_all(self.saved["cuda_rng"])
        np.random.set_state(self.saved["numpy_rng"])
        os.chdir(self.saved["cwd"])
        sys.argv[:] = self.saved["argv"]
        return False


def run_examples(device: str = "cuda", quick: tuple = EXAMPLES_QUICK) -> dict:
    """Phase 20(c): every script of examples_torch/ in this process on the
    card, in name order, at its full size (those in ``quick`` with
    ``--quick``): its seconds, ``ops.LAUNCHES`` and the calls ``ops.UNSERVED``
    counted around it, and the process state it changed and that was put
    back (``kept_state``). Fatal where a script raises or, on the card,
    launches no hand-written kernel. ``device="cpu"`` runs them on the CPU,
    where nothing is launched (a dry run of the phase)."""
    import importlib.util
    import traceback

    import torch

    from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED

    folder = REPO / "examples_torch"
    if str(folder) not in sys.path:
        sys.path.insert(0, str(folder))
    res = {}
    for path in sorted(folder.glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(f"examples_torch_{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        argv = ["--device", device, *(["--quick"] if path.name in quick else [])]
        sync = torch.cuda.synchronize if device == "cuda" else lambda: None
        before = dict(UNSERVED)
        sync()
        LAUNCHES.clear()
        t0 = time.time()
        with kept_state() as changed:
            try:
                spec.loader.exec_module(module)
                module.main(argv)
                sync()
            except BaseException as e:  # noqa: BLE001 (a SystemExit of the CLI too)
                traceback.print_exc()
                fail(f"examples_torch/{path.name} {argv} raised {type(e).__name__}: {e}")
        res[path.name] = {"seconds": time.time() - t0, "argv": argv,
                          "launches": dict(LAUNCHES), "unserved": unserved_since(before),
                          "state_put_back": changed}
        print(json.dumps({"example": path.name, **res[path.name]}))
        if device == "cuda" and not any(LAUNCHES.values()):
            fail(f"examples_torch/{path.name} launched no hand-written kernel on the card")
    return res


def isolation_phase(card: str) -> tuple[dict, dict]:
    """Phase 20: the loader's isolation of oversized molecules and the
    examples, each part fatal; its seconds on their own line with the card's
    name and power limit."""
    t0 = time.time()
    launches, unserved, res = {}, {}, {"part_seconds": {}}
    ds = mixed_dataset()
    parts = (("mixed", lambda: isolation_mixed(ds, launches, unserved)),
             ("mab", lambda: isolation_mab(launches, unserved)),
             ("examples", run_examples))
    for name, run in parts:
        t = time.time()
        res[name] = run()
        res["part_seconds"][name] = time.time() - t
    for name, ex in res["examples"].items():
        launches[f"example_{name}"] = ex["launches"]
    res["unserved"] = unserved
    res["seconds"] = time.time() - t0
    print(json.dumps({"isolation_phase": {k: v for k, v in res.items() if k != "examples"}}))
    print(json.dumps({"isolation_unserved": unserved}))
    if unserved:
        fail(f"phase 20 left calls without a table: {unserved}")
    print(json.dumps({"isolation_launches": {k: v for k, v in launches.items()
                                             if not k.startswith("example_")}}))
    print(json.dumps({"phase": "isolation", "seconds": res["seconds"],
                      "examples_seconds": res["part_seconds"]["examples"], "card": card}))
    if res["part_seconds"]["examples"] > ISOLATION_EXAMPLES_S and not EXAMPLES_QUICK:
        print(json.dumps({"examples_over_budget": {
            "seconds": res["part_seconds"]["examples"], "limit": ISOLATION_EXAMPLES_S,
            "slowest": sorted(res["examples"], key=lambda k: -res["examples"][k]["seconds"])[:4]}}))
    return launches, res


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
    t_run = t0 = time.time()
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
        "atom-message": sorted_segment_sum_info(shapes["E_pad"], shapes["N_pad"],
                                                atom_message_width(d, bmg.E.shape[1]),
                                                torch.bfloat16, torch.bfloat16),
    }
    print(json.dumps({"sorted_segment_sum_launch": seg_launch}))
    tensors, errs = check_kernels(bmg, d, args.seed)
    split_res = check_split_tables(d, args.seed, errs, args.reps, kind)

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
    cli_launches, cli_res = cli_phase(out_dir / "chip_smoke_cli", card)
    launches.update(cli_launches)
    predict_launches, predict_res = predict_phase(out_dir / "chip_smoke_predict", card,
                                                  out_dir / "chip_smoke_cli")
    launches.update(predict_launches)
    hpopt_launches, hpopt_res = hpopt_phase(card)
    launches.update(hpopt_launches)
    # the timings take A's and F's forms without a table on purpose: the main
    # paths' unserved calls are read before them, the benchmark steps' after;
    # phases 12 to 20 hold theirs to their rehearsals' inside them
    unserved = dict(UNSERVED)
    multi_launches, multi_res = multicomponent_phase(card)
    launches.update(multi_launches)
    mab_launches, mab_res = mab_phase(card)
    launches.update(mab_launches)
    interpret_launches, interpret_res = interpret_phase(card)
    launches.update(interpret_launches)
    export_launches, export_res = export_phase(ds, card, args.seed, args.reps)
    launches.update(export_launches)
    native_launches, native_res = native_cli_phase(card)
    launches.update(native_launches)
    parallel_launches, parallel_res = parallel_phase(batch, card, args.seed)
    launches.update(parallel_launches)
    v1_multi_launches, v1_multi_res = v1_multi_phase(ds, card)
    launches.update(v1_multi_launches)
    pipeline_launches, pipeline_res, pipeline_traced_epoch = input_pipeline_phase(card)
    launches.update(pipeline_launches)
    isolation_launches, isolation_res = isolation_phase(card)
    launches.update(isolation_launches)
    print(json.dumps({"run_seconds_after_phase_20": time.time() - t_run}))

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
    atom = times["sorted_segment_sum"]["atom_message"]
    for entry, x in ((atom, tensors["HE"]), (atom["float32"], tensors["HE32"])):
        entry["device_ms"] = device_ms(lambda: sorted_segment_sum(x, bmg.dst, bmg.edge_ptr))
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
    # phase 19's idle share: the last trace, after every untraced timing
    pipeline_res["idle"] = pipeline_traced_epoch()
    print(json.dumps({"input_pipeline_idle": pipeline_res["idle"]}))
    print(json.dumps({"unserved": unserved}))
    print(json.dumps({"device_traces": TRACES}))
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
    # the second passes over split tables, launched where a path's batches
    # hold one (phases 8, 12, 17 and 20), timed on Tox21 in phase 2
    for name, meta in SPLIT_PASSES.items():
        by_path = {p: launches[p][name] for p in launches if launches[p].get(name)}
        if not by_path:
            fail(f"no path launched {name}: the split tables' batches did not reach it")
        checks = {tag: err for tag, err in errs.items() if tag.split("[")[0] == name}
        kernels.append(dict(
            name=name, route="cuda", **meta, launches=sum(by_path.values()),
            launches_by_path=by_path, max_abs_err=errs[meta["timed"]],
            max_abs_err_by_check=checks, **split_res["times"][name]))
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
              "heads": heads_res, "cli": cli_res, "predict": predict_res, "hpopt": hpopt_res,
              "multicomponent": multi_res, "mab": mab_res, "interpret": interpret_res,
              "export": export_res, "native_cli": native_res, "parallel": parallel_res,
              "v1_multi": v1_multi_res, "input_pipeline": pipeline_res,
              "isolation": isolation_res, "device_traces": TRACES,
              "forward": rates,
              "train_step": step_rates,
              "kernels": kernels}
    record["run_seconds"] = time.time() - t_run
    print(json.dumps({"run_seconds": record["run_seconds"], "card": card}))
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
