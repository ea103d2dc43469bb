#!/usr/bin/env python3
"""The host cost of the port's forward kernel wrappers on one GPU: the
microseconds a call takes to check its inputs and enqueue its kernel (the
dispatcher, where the launch is a ``torch.library`` op, and the ctypes
call), with the device busy with earlier calls, so that no call waits.

    python3 experiments/torch_dispatch.py [--calls 50] [--runs 7] [--tree DIR]

The inputs are those of the benchmark batch (2048 molecules of
tests/data/regression/mol/mol.csv, tiled, as ``chip_smoke.py`` builds it) at
the default model's width (300 padded to 384): A (``message`` over the tile
table, f32), B (``fused_iter``, bf16), D (``fused_iter2``, bf16), C at the
M_v readout (bf16) and at the mean readout with counts (bf16 -> f32), and I
(``row_gather`` of the graph table by ``batch``, the mean readout's bf16
backward). For each, ``--runs`` runs of ``--calls`` calls are timed on the
host clock, call by call (``experiments/torch_fused_iter.py:host_us``), and
the median of the runs' medians is printed, with the launches counted and
the card's name and power limit. ``--tree DIR`` imports ``chemprop_tpu_torch``
from another checkout (for example a ``git archive`` of the parent commit):
run it on both, in turns, in one call to compare them on one card."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tree", type=Path, default=None,
                    help="import chemprop_tpu_torch from this checkout instead")
    args = ap.parse_args()
    tree = (args.tree or REPO).resolve()
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(tree))
    from chip_smoke import benchmark_batch, lipo_dataset  # the smoke run's own
    from experiments.torch_fused_iter import host_us

    import torch

    if not torch.cuda.is_available():
        print("torch_dispatch: no CUDA device", file=sys.stderr)
        return 2
    import chemprop_tpu_torch
    from chemprop_tpu_torch.ops import (
        LAUNCHES, fused_iter, fused_iter2, message, row_gather, sorted_segment_sum,
        sorted_segment_sum_counts,
    )

    if Path(chemprop_tpu_torch.__file__).resolve().parent.parent != tree:
        print(f"torch_dispatch: imported {chemprop_tpu_torch.__file__}, not {tree}",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    bmg = benchmark_batch(lipo_dataset(), "cuda").bmg
    graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    d, n_e, n_v = 384, bmg.E.shape[0], bmg.V.shape[0]

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    H32, Hb, H0 = randn(n_e, d, dtype=torch.float32), randn(n_e, d), randn(n_e, d)
    W = randn(d, d, scale=d**-0.5)
    Hv, g_graphs = randn(n_v, d), randn(bmg.node_ptr.numel() - 1, d)
    calls = {
        "message": lambda: message(H32, *graph, bmg.tile_ptr),
        "fused_iter": lambda: fused_iter(Hb, H0, W, None, *graph),
        "fused_iter2": lambda: fused_iter2(H0, W, None, *graph, bmg.tile_ptr),
        "sorted_segment_sum": lambda: sorted_segment_sum(Hb, bmg.dst, bmg.edge_ptr),
        "sorted_segment_sum_counts": lambda: sorted_segment_sum_counts(Hv, bmg.batch,
                                                                       bmg.node_ptr),
        "row_gather": lambda: row_gather(g_graphs, bmg.batch),
    }
    with torch.inference_mode():
        for name, fn in calls.items():
            fn()  # builds and loads the kernel
            LAUNCHES.clear()
            runs = [host_us(fn, args.calls) for _ in range(args.runs)]
            launched = sum(LAUNCHES.values())
            print(json.dumps({"wrapper": name, "host_us_per_call": statistics.median(runs),
                              "host_us_by_run": runs, "launches": launched,
                              "calls": args.runs * args.calls, "tree": str(tree),
                              "card": card}))
            if launched != args.runs * args.calls:
                print(f"torch_dispatch: {name} launched {launched} kernels in "
                      f"{args.runs * args.calls} calls", file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
