#!/usr/bin/env python3
"""The fits of ``chip_smoke.py``'s phase 8(b) on the CPU and on the card, side
by side: the BCE (classification/mol.csv), CE (mol_multiclass.csv) and MVE
(regression/mol/mol.csv) heads on the default model at full width (hidden
width 300 padded to 384, depth 3, batch norm), ``HEAD_FIT_EPOCHS`` epochs in
shuffled batches of 50, each fit by ``chip_smoke.head_fit`` with its seeds.

    python3 experiments/torch_head_fits.py [--heads bce,ce,mve]
        [--dtypes bfloat16,float32] [--devices cpu,cuda] [--steps 8]
        [--epochs N]

For each head, dtype and device it prints the fit's train loss of every
epoch and its batches without a tile table, and the losses of the first
``--steps`` training steps of the same model on the same batches (one
``Trainer.train_step`` each, after ``init_state`` from the same seed), so that
where the devices part shows. The CPU runs the plain versions of the
kernels, the card the kernels. ``chip_smoke.HEAD_FIT_BARS`` are set from the
CPU's bfloat16 fits. ``--epochs`` shortens every fit (a quick check of the
script itself). Every line carries the card's name and power limit where
there is a card; the record goes to chiprun_out/torch_head_fits.json."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no card"


def first_steps(name: str, dtype, device, steps: int) -> list[float]:
    """The losses of the first ``steps`` training steps of ``head_fit``'s
    model and trainer on its first epoch's batches."""
    import chip_smoke
    from chemprop_tpu_torch.data import DataLoader
    from chemprop_tpu_torch.train import Trainer

    train, _, head, kwargs, _ = chip_smoke.head_fit_data(name)
    trainer = Trainer(chip_smoke.head_model(dtype, head, **kwargs),
                      max_epochs=chip_smoke.HEAD_FIT_EPOCHS, warmup_epochs=2, seed=12,
                      device=device)
    loader = DataLoader(train, batch_size=50, shuffle=True, seed=3)
    batches = list(loader)[:steps]
    trainer.init_state(batches[0], len(loader))
    return [float(trainer.train_step(b)) for b in batches]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--heads", default="bce,ce,mve")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--devices", default="cpu,cuda")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke

    if args.epochs is not None:
        chip_smoke.HEAD_FIT_EPOCHS = args.epochs
    label = card()
    record = {"card": label, "epochs": chip_smoke.HEAD_FIT_EPOCHS,
              "bars": chip_smoke.HEAD_FIT_BARS, "fits": []}
    for name in args.heads.split(","):
        for dt in args.dtypes.split(","):
            for device in args.devices.split(","):
                dtype = getattr(torch, dt)
                dev = None if device == "cuda" else device
                t0 = time.time()
                history, untiled, batches = chip_smoke.head_fit(name, dtype, dev)
                fit_s = time.time() - t0
                row = {"head": name, "dtype": dt, "device": device, "fit_s": fit_s,
                       "train_loss": [h["train_loss"] for h in history],
                       "untiled_batches": untiled, "batches": batches,
                       "first_steps": first_steps(name, dtype, dev, args.steps)}
                record["fits"].append(row)
                print(json.dumps({**row, "card": label}), flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_head_fits.json").write_text(json.dumps(record, indent=1))
    print(label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
