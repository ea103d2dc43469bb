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
   hidden width 300 padded to 384;
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
5. on the benchmark batch: each dtype's launches in one forward and in one
   training step, counted on their own; timing with CUDA events of each
   kernel, its plain version and the one PyTorch call that computes the same
   function, where there is one; and the forward's and the training step's
   molecules per second.

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
        source="chemprop_tpu_torch/csrc/message.cu",
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
        source="chemprop_tpu_torch/csrc/message_bwd.cu",
        replaces="chemprop_tpu/ops/fused_message.py:1055",
        tpu_kernel="_bwd_msg_premul_kernel via _bwd_msg_premul_impl",
        timed="bwd_message_premul[fold_h0=True,G]",
    ),
    "row_gather": dict(
        source="chemprop_tpu_torch/csrc/gather.cu",
        replaces="chemprop_tpu/ops/window_gather.py:40",
        tpu_kernel="_kernel via _window_gather_impl",
        timed="row_gather[bfloat16]",
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
        bwd_message, bwd_message_nodes, bwd_message_premul, fused_iter, message, row_gather,
        sorted_segment_sum, sorted_segment_sum_counts,
    )
    from chemprop_tpu_torch.ops.gather import row_gather_plain
    from chemprop_tpu_torch.ops.message import (
        bwd_message_nodes_plain, bwd_message_plain, bwd_message_premul_plain,
        fused_iter_plain, message_plain,
    )
    from chemprop_tpu_torch.ops.segment import sorted_segment_sum_plain

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
    for relu_stream, bias in ((True, None), (False, None), (False, b)):
        tag = f"fused_iter[relu_stream={relu_stream},bias={bias is not None}]"
        x = H0 if relu_stream else H
        # the bf16 message may round one ulp apart, which W carries into y;
        # y's own rounding adds one ulp
        check(tag, fused_iter(x, H0, W, bias, *graph, relu_stream=relu_stream),
              fused_iter_plain(x, H0, W, bias, *graph, relu_stream=relu_stream),
              2 * BF16_ULP, 0.02, errs)
    # f32 sums in another order differ by up to a few eps times the sum of
    # |x| over the segment (the padding segments hold thousands of rows, and
    # the plain version's index_add_ order itself varies from run to run),
    # so f32 outputs are held to 1e-5 of that; a bf16 output rounds once more
    def abs_sums(data, ids, ptr):
        return sorted_segment_sum_plain(data.abs(), ids, ptr, torch.float32)[0]

    for data, out_dtype in ((H32, torch.float32), (H, torch.bfloat16)):
        got = sorted_segment_sum(data, bmg.dst, bmg.edge_ptr, out_dtype)
        want, _ = sorted_segment_sum_plain(data, bmg.dst, bmg.edge_ptr, out_dtype)
        tag = f"sorted_segment_sum[edge->node,{data.dtype}->{out_dtype}]"
        if out_dtype == torch.bfloat16:
            check(tag, got, want, BF16_ULP, 1e-4, errs)
        else:
            check(tag, got, want, 1e-5, 1e-6, errs, abs_sums(data, bmg.dst, bmg.edge_ptr))
    for data in (Hv.float(), Hv):
        got, counts = sorted_segment_sum_counts(data, bmg.batch, bmg.node_ptr)
        want, want_counts = sorted_segment_sum_plain(
            data, bmg.batch, bmg.node_ptr, torch.float32, True
        )
        check(f"sorted_segment_sum[node->graph+counts,{data.dtype}]", got, want, 1e-5, 1e-6,
              errs, abs_sums(data, bmg.batch, bmg.node_ptr))
        if not torch.equal(counts, want_counts):
            fail("sorted_segment_sum: counts disagree")

    # the backward kernels, at the shapes the training step gives them
    pad_rows = bmg.dst == n_v - 1
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
    # so its limit scales with the sum of |gz| over its terms
    for fold in (True, False):
        tag = f"bwd_message_premul[fold_h0={fold}"
        G, z = bwd_message_premul(gb, yb, H0, W, *graph, fold_h0=fold)
        want_G, want_z = bwd_message_premul_plain(gb, yb, H0, W, *graph, fold_h0=fold)
        gz_abs = ((gb.float() @ W.float().t()) * (yb > 0)).abs()
        terms = torch.zeros((n_v, d), device=dev).index_add_(0, bmg.dst.long(), gz_abs[bmg.rev.long()])
        check(f"{tag},G]", G, want_G, 2 * BF16_ULP, 1e-4, errs, terms[bmg.dst.long()])
        check(f"{tag},z]", z, want_z, 2 * BF16_ULP, 1e-4, errs)
        zeros_on_padding(f"{tag}]", G, z)
    # I: a copy, so exact; the last row of the table is not zero here, and the
    # rows that name it must come out zero all the same
    got = row_gather(Mg, bmg.batch)
    check("row_gather[bfloat16]", got, row_gather_plain(Mg, bmg.batch), 0.0, 0.0, errs)
    if got[bmg.batch == bmg.n_graphs].any():
        fail("row_gather: a row of the sacrificial id is not zero")
    torch.cuda.synchronize()
    tensors = dict(H32=H32, H=H, H0=H0, W=W, Hv=Hv, g32=g32, y32=y32, acc32=acc32, gb=gb, yb=yb,
                   g_nodes=g_nodes, Mg=Mg)
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


def default_model(dtype):
    """The default model at full width: the one the reference checkpoint
    holds, with batch norm, as the reference's overfit run trains it."""
    from chemprop_tpu_torch.models import MPNN
    from chemprop_tpu_torch.nn import BondMessagePassing, MeanAggregation, RegressionFFN

    return MPNN(
        BondMessagePassing(compute_dtype=dtype),  # d_h 300, depth 3, ReLU, no bias
        MeanAggregation(),
        RegressionFFN(output_transform=False),
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
    ``Trainer.predict`` on cuda, in float32 and in bfloat16."""
    import torch

    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.ops import LAUNCHES
    from chemprop_tpu_torch.train import Trainer

    launches, res = {}, {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        loader = DataLoader(ds, batch_size=32, shuffle=False)
        LAUNCHES.clear()
        t0 = time.time()
        trainer = Trainer(default_model(dt), max_epochs=50, warmup_epochs=2, seed=12)
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
    print(json.dumps({"train_step_cuda_vs_cpu": res}))
    # f32 on both sides; only summation orders differ
    if abs(losses[None] - losses["cpu"]) > 1e-5 * abs(losses["cpu"]):
        fail("the float32 training step's loss on cuda disagrees with the CPU's")
    # Adam's first step moves a weight by the rate times its gradient's sign,
    # whatever the gradient's size: where a gradient is at the level of f32
    # rounding, summation order decides the sign, and such an element differs
    # by twice the rate. Every element is within that; all but a thousandth
    # within rtol 1e-4 / atol 1e-6
    if worst > 2 * lr * (1 + 1e-3) or n_off > 1e-3 * n_all:
        fail("the float32 training step's parameters on cuda disagree with the CPU's")
    return res


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


def timings(bmg, t: dict, d: int, reps: int, card: str) -> dict:
    """Phase 4: kernel, plain and library times with the least time the card
    could take (bytes over the memory rate or operations over the peak)."""
    import torch

    from chemprop_tpu_torch.ops import (
        bwd_message, bwd_message_nodes, bwd_message_premul, fused_iter, message, row_gather,
        sorted_segment_sum,
    )
    from chemprop_tpu_torch.ops.gather import row_gather_plain
    from chemprop_tpu_torch.ops.message import (
        bwd_message_nodes_plain, bwd_message_plain, bwd_message_premul_plain,
        fused_iter_plain, message_plain,
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
    )
    # fused iteration, bf16: H and H0 read, y written, W read once; the
    # message adds and the product of the real rows' messages with W
    b_ms, b_by = bound(3 * n_e * d * 2 + d * d * 2 + ids_bytes, 2 * n_real * d * d, bf16_peak)
    out["fused_iter"] = dict(
        ms=time_ms(lambda: fused_iter(t["H"], t["H0"], t["W"], None, *graph), reps),
        plain_ms=time_ms(lambda: fused_iter_plain(t["H"], t["H0"], t["W"], None, *graph), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="bfloat16",
    )
    # segment sum, the M_v readout in bf16: E rows read, N rows written
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
    )
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
    # H with fold_h0, as at depth 3: G_in, y and H0 read, G and z written, W
    # read once; the product of the real rows with W^T on the tensor cores.
    # Without fold_h0 (from depth 4) H0 is not read
    b_ms, b_by = bound(5 * n_e * d * 2 + d * d * 2 + f_ids, 2 * n_real * d * d, bf16_peak)
    b_nofold, _ = bound(4 * n_e * d * 2 + d * d * 2 + f_ids, 2 * n_real * d * d, bf16_peak)
    premul = lambda fn, fold: fn(t["gb"], t["yb"], t["H0"], t["W"], *graph, fold_h0=fold)  # noqa: E731
    out["bwd_message_premul"] = dict(
        ms=time_ms(lambda: premul(bwd_message_premul, True), reps),
        plain_ms=time_ms(lambda: premul(bwd_message_premul_plain, True), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="bfloat16",
        without_fold_h0=dict(ms=time_ms(lambda: premul(bwd_message_premul, False), reps),
                             bound_ms=b_nofold),
    )
    # I, bf16: the graph table and the ids read, the node table written
    n_g = t["Mg"].shape[0]
    batch64 = bmg.batch.long()
    b_ms, b_by = bound((n_g + n_v) * d * 2 + 4 * n_v, 0, f32_peak)
    out["row_gather"] = dict(
        ms=time_ms(lambda: row_gather(t["Mg"], bmg.batch), reps),
        plain_ms=time_ms(lambda: row_gather_plain(t["Mg"], bmg.batch), reps),
        library_ms=time_ms(lambda: torch.index_select(t["Mg"], 0, batch64), reps),
        bound_ms=b_ms, bound_by=b_by, shape=[n_v, d], dtype="bfloat16",
    )
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
    """Each dtype's launches in one training step on the benchmark batch
    (counted on their own, and held to the expected counts), then the step's
    time and molecules per second (the batch lies on the card already)."""
    import torch

    from chemprop_tpu_torch.ops import LAUNCHES
    from chemprop_tpu_torch.train import Trainer

    rates = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        trainer = Trainer(default_model(dt), seed=0)
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
    from chemprop_tpu_torch.ops import build_all

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    t0 = time.time()
    logs = build_all()
    build_s = time.time() - t0
    print(json.dumps({"phase": "build", "seconds": build_s}))
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "error" in line:
                print(f"[{name}] {line.strip()}")

    d = 384  # hidden width 300, lane-padded as in the JAX package
    ds = lipo_dataset()
    batch = benchmark_batch(ds, "cuda")
    bmg = batch.bmg
    shapes = {"molecules": BATCH_SIZE, "E_pad": bmg.E.shape[0], "E_real": int(bmg.edge_mask.sum()),
              "N_pad": bmg.V.shape[0], "N_real": int(bmg.node_mask.sum()), "d": d}
    print(json.dumps({"benchmark_batch": shapes}))
    tensors, errs = check_kernels(bmg, d, args.seed)

    out_dir = REPO / "chiprun_out"
    (out_dir / "chip_smoke_preds").mkdir(parents=True, exist_ok=True)
    launches, path_res = main_path(out_dir / "chip_smoke_preds")
    train_launches, train_res = train_path(ds)
    launches.update(train_launches)
    step_res = step_against_cpu(ds)
    repeat_res = repeated_fits(ds)

    times = timings(bmg, tensors, d, args.reps, kind)
    rates = forward_rate(bmg, args.reps)
    print(json.dumps({"forward": rates}))
    step_rates = train_rate(batch, args.reps)
    print(json.dumps({"train_step": step_rates}))

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
    record = {"card": card, "kind": kind, "build_s": build_s, "benchmark_batch": shapes,
              "main_path": path_res, "train_path": train_res, "train_step_cuda_vs_cpu": step_res,
              "repeated_bfloat16_fits": repeat_res, "forward": rates, "train_step": step_rates,
              "kernels": kernels}
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
