#!/usr/bin/env python3
"""The first epoch of ``chip_smoke.py``'s phase 9(a) on the card against the
CPU, with and without a planted fault in the backward: how far each check
of that epoch moves when the backward is wrong.

    python3 experiments/torch_cli_train_check.py [--dtypes float32,bfloat16]
        [--plants none,g_zero,h_z_zero,f_zero]

For each dtype it runs ``train`` (``chip_smoke.cli_train``: mol.csv at full
width, batch norm, the mean readout, a scaffold-balanced split, one epoch of
two Adam steps) once on the CPU, then on the card once for each plant that
touches that dtype's backward:

- ``none``: the port as it is;
- ``g_zero``: kernel G's outputs (G and the cotangent of H0) replaced by
  zeros, so the bf16 backward of message passing gives W_h and W_i nothing
  from the last iteration;
- ``h_z_zero``: kernel H's cotangent of H0 replaced by zeros, so only W_i's
  gradient loses the earlier iterations' share;
- ``f_zero``: kernel F's G replaced by zeros in the f32 backward.

The kernels still launch; only their outputs are replaced. Each line gives
the first epoch's train loss on both sides and its relative difference, and,
for each parameter tensor of the two ``best.ckpt`` files, its share of
elements that differ by more than each of four limits (1e-6, and a
hundredth, a tenth and half of the two steps' summed rate
``chip_smoke.CLI_FIRST_LRS``). ``chip_smoke``'s
``CLI_PARAM_TAU`` and ``CLI_PARAM_SHARE`` come from these readings. Every
line carries the card's name and power limit; the record goes to
chiprun_out/torch_cli_train_check.json."""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PLANTS = {"none": None, "g_zero": "bfloat16", "h_z_zero": "bfloat16", "f_zero": "float32"}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no card"


@contextlib.contextmanager
def planted(plant: str):
    """``ops.message`` with one kernel's outputs replaced by zeros."""
    import importlib

    import torch

    # the module, which ``chemprop_tpu_torch.ops.message`` (the function) hides
    message = importlib.import_module("chemprop_tpu_torch.ops.message")
    name = {"none": None, "g_zero": "bwd_message_nodes", "h_z_zero": "bwd_message_premul",
            "f_zero": "bwd_message"}[plant]
    if name is None:
        yield
        return
    real = getattr(message, name)

    def fake(*a, **kw):
        G, other = real(*a, **kw)
        if plant == "g_zero":
            return torch.zeros_like(G), torch.zeros_like(other)
        if plant == "h_z_zero":
            return G, torch.zeros_like(other)
        return torch.zeros_like(G), other

    setattr(message, name, fake)
    try:
        yield
    finally:
        setattr(message, name, real)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dtypes", default="float32,bfloat16")
    p.add_argument("--plants", default=",".join(PLANTS))
    args = p.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    lrs = chip_smoke.CLI_FIRST_LRS
    taus = {"1e-6": 1e-6, "lrs/100": lrs / 100, "lrs/10": lrs / 10, "lrs/2": lrs / 2}
    out = REPO / "chiprun_out/torch_cli_train_check"
    shutil.rmtree(out, ignore_errors=True)
    name, record = card(), []
    for dt in args.dtypes.split(","):
        cpu = chip_smoke.cli_train(out / f"{dt}_cpu", dt, "cpu", 1, members=1)
        for plant in args.plants.split(","):
            if PLANTS[plant] not in (None, dt):
                continue
            with planted(plant):
                got = chip_smoke.cli_train(out / f"{dt}_{plant}", dt, None, 1, members=1)
            drift = chip_smoke.param_drift(out / f"{dt}_{plant}/best.ckpt",
                                           out / f"{dt}_cpu/best.ckpt", taus)
            a, b = got[0][0]["train_loss"], cpu[0][0]["train_loss"]
            line = {"dtype": dt, "plant": plant, "card": name,
                    "train_loss": a, "train_loss_cpu": b, "rel": abs(a - b) / abs(b),
                    "max_diff": max(v["max"] for v in drift.values()),
                    "shares": {k: {t: v[t] / v["n"] for t in taus} for k, v in drift.items()}}
            line["worst_share"] = {t: max(s[t] for s in line["shares"].values()) for t in taus}
            print(json.dumps(line))
            record.append(line)
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out/torch_cli_train_check.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
