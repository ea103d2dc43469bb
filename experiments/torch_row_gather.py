#!/usr/bin/env python3
"""Kernel I (``row_gather``, ``csrc/gather.cu``) as the main path launches it,
on one GPU: the mean readout's bf16 graph cotangent, ``[n_graphs + 1, 384]``,
gathered to the node table by ``batch``, on the benchmark batch (2048
molecules of tests/data/regression/mol/mol.csv, tiled, as ``chip_smoke.py``
builds it).

    python3 experiments/torch_row_gather.py [--reps 21] [--seed 0]

Four calls, each timed between CUDA events (median of ``--reps`` runs of 5
calls, ``chip_smoke.time_ms``) and by its device time from a
``torch.profiler`` trace (``chip_smoke.device_ms``): ``row_gather`` through
its ``torch.library`` op (what ``MeanAggregation``'s backward calls), the
raw library call underneath (``ops/build.py:call`` into a preallocated
output: no op dispatch, no checks), ``row_gather_plain`` (an index and a
masked fill) and ``torch.index_select`` alone. Beside them the least time
the card could take: the table rows read once, the ids read, the output
written, over the memory rate, counted over every row (padding included) and
over the real rows alone. The outputs of the op and of the raw call are held
to the plain version bit for bit. It prints one JSON line per call and a
summary line with the card's name and power limit."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("torch_row_gather: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import benchmark_batch, device_ms, lipo_dataset, peaks, time_ms
    from chemprop_tpu_torch.ops import LAUNCHES
    from chemprop_tpu_torch.ops.build import call, library
    from chemprop_tpu_torch.ops.gather import row_gather, row_gather_plain

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    bmg = benchmark_batch(lipo_dataset(), "cuda").bmg
    d = 384
    n_g, n_v = bmg.n_graphs + 1, bmg.V.shape[0]  # the sacrificial graph's row last
    n_v_real = int(bmg.node_mask.sum())
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    Mg = torch.randn((n_g, d), generator=gen, device="cuda").to(torch.bfloat16)
    ids, ids64 = bmg.batch, bmg.batch.long()
    out = torch.empty((n_v, d), dtype=Mg.dtype, device="cuda")
    lib = library("gather")

    def raw():
        call(lib, "row_gather", Mg, ids, out, n_v, n_g, d * 2)
        return out

    want = row_gather_plain(Mg, ids)
    LAUNCHES.clear()
    checks = {"op": torch.equal(row_gather(Mg, ids), want), "raw": torch.equal(raw(), want)}
    if not all(checks.values()) or LAUNCHES["row_gather"] != 1:
        print(f"torch_row_gather: outputs {checks}, op launches {dict(LAUNCHES)}",
              file=sys.stderr)
        return 1
    mem_rate = peaks(card)[0]
    padded_bytes = (n_g + n_v) * d * 2 + 4 * n_v
    real_bytes = (bmg.n_graphs + n_v_real) * d * 2 + 4 * n_v_real
    bounds = {"bound_ms_padded": padded_bytes / mem_rate * 1e3,
              "bound_ms_real": real_bytes / mem_rate * 1e3, "bound_by": "bytes"}
    calls = {"row_gather_op": lambda: row_gather(Mg, ids), "library_call": raw,
             "row_gather_plain": lambda: row_gather_plain(Mg, ids),
             "index_select": lambda: torch.index_select(Mg, 0, ids64)}
    res = {}
    for name, fn in calls.items():
        res[name] = {"ms": time_ms(fn, args.reps)}
    for name, fn in calls.items():  # traced after every untraced timing
        res[name]["device_ms"] = device_ms(fn)
        res[name]["share_of_real_bound"] = bounds["bound_ms_real"] / res[name]["device_ms"]
        print(json.dumps({"call": name, **res[name], "card": card}))
    summary = {"shape": {"table": [n_g, d], "out": [n_v, d], "real_out_rows": n_v_real},
               **bounds, "times": res,
               "device_vs_index_select": res["row_gather_op"]["device_ms"]
               / res["index_select"]["device_ms"], "card": card}
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "torch_row_gather.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({"row_gather": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
