#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's forward goes, on one GPU.

    python3 experiments/torch_forward_profile.py [--steps 10]

Builds the serving path's benchmark batch (2048 molecules of
tests/data/regression/mol/mol.csv, tiled, as ``bench.py`` and
``chip_smoke.py`` do), loads the reference checkpoint
tests/data/example_model_v2_regression_mol.pt in float32 and in bfloat16, and
times ``--steps`` forwards of each on the host clock (around work that ends
in ``torch.cuda.synchronize()``), then traces as many with ``torch.profiler``.
It prints one JSON line per dtype: the wall time per forward, the device
time summed over the traced kernels, the device's idle share of the untraced
wall time, and the kernels by device time. The full table goes to
chiprun_out/forward_profile.json."""

from __future__ import annotations

import argparse
import csv
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chemprop_tpu_torch.chem import make_mol  # noqa: E402
from chemprop_tpu_torch.data import batch_mol_graphs  # noqa: E402
from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer  # noqa: E402
from chemprop_tpu_torch.models import load_model  # noqa: E402

CKPT = REPO / "tests/data/example_model_v2_regression_mol.pt"
MOL_CSV = REPO / "tests/data/regression/mol/mol.csv"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--molecules", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2

    with open(MOL_CSV, newline="") as f:
        smis = [row[0] for row in list(csv.reader(f))[1:]]
    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(make_mol(s)) for s in smis]
    mgs = (mgs * -(-args.molecules // len(mgs)))[: args.molecules]
    bmg = batch_mol_graphs(mgs).to("cuda")

    report = {"card": torch.cuda.get_device_name(0), "molecules": args.molecules}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model, _ = load_model(CKPT, "cuda", dt)
        for _ in range(3):
            model(bmg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            model(bmg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.steps):
                model(bmg)
            torch.cuda.synchronize()
        rows = []
        for evt in prof.key_averages():
            # device-side events only: the kernels (and copies), not the aten
            # ops that launched them, which would count each kernel twice
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = evt.self_device_time_total
            if dev_us > 0:
                rows.append({"name": evt.key[:90], "device_ms_per_step": dev_us / 1e3 / args.steps,
                             "calls_per_step": evt.count / args.steps})
        rows.sort(key=lambda r: -r["device_ms_per_step"])
        device_ms = sum(r["device_ms_per_step"] for r in rows)
        summary = {
            "dtype": name,
            "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms,
            "idle_share": 1 - device_ms / wall_ms if wall_ms > 0 else None,
            "top": rows[:8],
        }
        print(json.dumps(summary))
        report[name] = dict(summary, kernels=rows)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "forward_profile.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
