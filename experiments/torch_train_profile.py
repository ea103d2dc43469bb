#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's training step goes, on one GPU.

    python3 experiments/torch_train_profile.py [--steps 10] [--runs 3]
        [--dropout 0.1] [--options fused_bwd,grad_w]

Builds the benchmark batch (2048 molecules of
tests/data/regression/mol/mol.csv, tiled, with their normalised targets, as
``chip_smoke.py`` does) and the default model at full width (hidden width 300
padded to 384, depth 3, mean readout, batch norm, regression head) in float32
and in bfloat16, and runs ``Trainer.train_step`` on it; ``--dropout`` above 0
gives the step of the per-iteration path, ``--options`` turns opt-in kernels
on. Each of ``--runs``
runs times ``--steps`` steps on the host clock (around work that ends in
``torch.cuda.synchronize()``); then, for each run, as many steps are traced
with ``torch.profiler`` and the device time of the traced kernels is summed:
the device's idle share is one minus that sum over the untraced wall time.
All the untraced timings, of both dtypes, are taken before the first trace:
once the profiler has run in a process its tracing hooks stay in and slow
every later launch, traced or not, which would count as idle time. The share
moves from run to run (the eager step's host work is close to its device
time, and the host's cores are shared), so every run is reported and the
summary takes the median.

It prints one JSON line per dtype: wall and device ms per step, the idle
share of each run and their median, and the kernels by device time, with the
port's own kernels grouped under their wrappers' names. The full table goes
to chiprun_out/train_profile.json (with ``--dropout`` or ``--options``:
train_profile_<rate>_<options>.json)."""

from __future__ import annotations

import argparse
import csv
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chemprop_tpu_torch.data import (  # noqa: E402
    MoleculeDatapoint,
    MoleculeDataset,
    collate_batch,
)
from chemprop_tpu_torch.models import MPNN  # noqa: E402
from chemprop_tpu_torch.nn import (  # noqa: E402
    BondMessagePassing,
    MeanAggregation,
    RegressionFFN,
)
from chemprop_tpu_torch.ops import KernelOptions  # noqa: E402
from chemprop_tpu_torch.train import Trainer  # noqa: E402

MOL_CSV = REPO / "tests/data/regression/mol/mol.csv"
# the port's device functions, by the wrapper that launches them
OWN_KERNELS = {
    "plain_message_kernel": "A message",
    "fused_iter_kernel": "B fused_iter",
    "seg_kernel": "C sorted_segment_sum",
    "bwd_premul_kernel": "H bwd_message_premul (one launch over the tiles)",
    "bwd_message_kernel": "F/G node pass (bwd_message*; H's without a tile table)",
    "row_gather_kernel": "I row_gather",
    "fused_iter2_kernel": "D fused_iter2",
    "iter_bwd_dh_kernel": "E iter_bwd (G, dH, gz)",
    "iter_bwd_dw_kernel": "E iter_bwd (dW partials)",
    "grad_weight_kernel": "J grad_weight (partials)",
    "xtg_reduce_kernel": "E/J ordered reduction of the partials",
}


def kernel_group(name: str) -> str:
    for key, group in OWN_KERNELS.items():
        if key in name:
            return group
    return name[:90]


def benchmark_batch(molecules: int):
    with open(MOL_CSV, newline="") as f:
        rows = list(csv.reader(f))[1:]
    ds = MoleculeDataset([MoleculeDatapoint.from_smi(s, y=np.array([float(y)])) for s, y in rows])
    ds.normalize_targets()
    data = [ds[i] for i in range(len(ds))]
    data = (data * -(-molecules // len(data)))[:molecules]
    return collate_batch(data).to("cuda")


def wall_ms_per_step(trainer: Trainer, batch, steps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def traced_run(trainer: Trainer, batch, steps: int, wall_ms: float) -> dict:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
    groups: dict[str, list[float]] = {}
    for evt in prof.key_averages():
        # device-side events only: the kernels (and copies), not the aten ops
        # that launched them, which would count each kernel twice
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        acc = groups.setdefault(kernel_group(evt.key), [0.0, 0.0])
        acc[0] += evt.self_device_time_total / 1e3 / steps
        acc[1] += evt.count / steps
    rows = [{"name": k, "device_ms_per_step": v[0], "calls_per_step": v[1]}
            for k, v in groups.items()]
    rows.sort(key=lambda r: -r["device_ms_per_step"])
    device_ms = sum(r["device_ms_per_step"] for r in rows)
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "idle_share": 1 - device_ms / wall_ms, "kernels": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--runs", type=int, default=3, help="profiled runs per dtype (>= 3)")
    ap.add_argument("--molecules", type=int, default=2048)
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="dropout rate: above 0 the step takes the per-iteration ops")
    ap.add_argument("--options", default="",
                    help="comma-separated opt-in kernels: iter2, fused_bwd, grad_w")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    batch = benchmark_batch(args.molecules)
    options = KernelOptions(**{name: True for name in args.options.split(",") if name})
    report = {"card": card, "molecules": args.molecules, "steps": args.steps,
              "dropout": args.dropout, "options": args.options}
    trainers, walls = {}, {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model = MPNN(
            BondMessagePassing(compute_dtype=dt, dropout=args.dropout, kernel_options=options),
            MeanAggregation(),
            RegressionFFN(output_transform=False, dropout=args.dropout),
            batch_norm=True,
        )
        trainer = Trainer(model, seed=0)
        trainer.init_state(batch, 1)
        for _ in range(3):
            trainer.train_step(batch)
        trainers[name] = trainer
        walls[name] = [wall_ms_per_step(trainer, batch, args.steps) for _ in range(args.runs)]
    for name, trainer in trainers.items():
        runs = [traced_run(trainer, batch, args.steps, w) for w in walls[name]]
        mid = sorted(runs, key=lambda r: r["idle_share"])[len(runs) // 2]
        summary = {
            "dtype": name,
            "card": card,
            "wall_ms_per_step": statistics.median(r["wall_ms_per_step"] for r in runs),
            "device_ms_per_step": statistics.median(r["device_ms_per_step"] for r in runs),
            "idle_share_by_run": [r["idle_share"] for r in runs],
            "idle_share_median": mid["idle_share"],
            "top": mid["kernels"][:8],
        }
        print(json.dumps(summary))
        report[name] = dict(summary, runs=runs)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    tag = f"_{args.dropout}_{args.options.replace(',', '+')}" if args.dropout or args.options else ""
    (out / f"train_profile{tag}.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
