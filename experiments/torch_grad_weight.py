#!/usr/bin/env python3
"""Kernel J of the PyTorch/CUDA port (``grad_weight``: ``X^T G`` in float32
from bfloat16 tables) on one GPU: its build, what its machine code holds, its
agreement with the plain version and its time beside ``torch.mm``.

    python3 experiments/torch_grad_weight.py [--rows 123392] [--reps 21]

``--rows`` is the edge count of the benchmark batch (2048 molecules of
tests/data/regression/mol/mol.csv, as ``chip_smoke.py`` builds it). The
shapes are the training step's two with ``grad_w`` on, W_h's
[rows x 384]^T [rows x 384] and W_i's [rows x 128]^T [rows x 384], then the
ragged and short cases and the other tile widths. Each is held against
``grad_weight_plain`` (limit 1e-5 of the sum of |terms|, plus 1e-3) and
against a second run of its own, bit for bit. The two path shapes are timed
(medians of ``--reps`` runs of 5 calls between CUDA events) beside
``torch.mm(X.t(), G, out_dtype=float32)`` and the bound: the larger of the
bytes (both tables read once, the output written once) over the memory rate
and the operations over the bf16 tensor peak, both of an H100 SXM. Prints
one JSON line per shape and a summary; the record goes to
chiprun_out/torch_grad_weight.json."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from chip_smoke import time_ms  # noqa: E402  (the same timing as the smoke run's)

MEM_RATE, BF16_PEAK = 3.35e12, 989e12  # H100 SXM, NVIDIA's data sheet


def shapes(rows: int) -> list[tuple[int, int, int]]:
    """(n, dx, dg): the two path shapes first, then the edge cases."""
    return [(rows, 384, 384), (rows, 128, 384), (rows - 37, 384, 384), (1000, 384, 384),
            (37, 128, 384), (4133, 256, 256), (4133, 384, 256), (5000, 384, 128), (0, 128, 128)]


def host_us(fn, calls: int = 20) -> float:
    """Median host microseconds to enqueue one call, the device busy with
    earlier ones (so that no call waits for it)."""
    import time

    import torch

    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound_ms(n: int, dx: int, dg: int) -> tuple[float, str]:
    tb = (n * (dx + dg) * 2 + dx * dg * 4) / MEM_RATE * 1e3
    to = 2 * n * dx * dg / BF16_PEAK * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check(n: int, dx: int, dg: int, seed: int):
    """J against its plain version and against its own second run; returns
    the result and the inputs."""
    import torch

    from chemprop_tpu_torch.ops.grad_weight import grad_weight, grad_weight_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((n, dx), generator=g, device="cuda").to(torch.bfloat16)
    G = torch.randn((n, dg), generator=g, device="cuda").to(torch.bfloat16)
    got = grad_weight(X, G, use_kernel=True)
    want = grad_weight_plain(X, G)
    limit = 1e-3 + 1e-5 * (X.float().abs().t() @ G.float().abs())
    err = (got - want).abs()
    res = {"n": n, "dx": dx, "dg": dg, "max_abs_err": float(err.max()),
           "max_err_over_limit": float((err / limit).max()),
           "bit_equal_rerun": bool(torch.equal(got, grad_weight(X, G, use_kernel=True)))}
    res["ok"] = bool((err <= limit).all()) and res["bit_equal_rerun"]
    return res, X, G


def profile(X, G) -> dict:
    """Device microseconds per call of each kernel that J and ``torch.mm``
    launch, from ``torch.profiler`` (``torch_fused_iter.profile``)."""
    import torch
    from experiments.torch_fused_iter import profile as traced

    from chemprop_tpu_torch.ops.grad_weight import grad_weight

    return traced({"grad_weight": lambda: grad_weight(X, G, use_kernel=True),
                   "torch.mm": lambda: torch.mm(X.t(), G, out_dtype=torch.float32)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=123392)
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace 10 calls of J and of torch.mm at each path shape "
                         "and print the device time of each kernel")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_grad_weight: no CUDA device", file=sys.stderr)
        return 2
    from chemprop_tpu_torch.ops.build import build_all, sass_contains
    from chemprop_tpu_torch.ops.grad_weight import grad_weight, grad_weight_plain

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    log, seconds = build_all()["grad_weight"]
    print(json.dumps({"build": "grad_weight", "seconds": seconds}))
    for line in log.splitlines():
        if "grad_weight" in line or "Used" in line or "error" in line or "arn" in line:
            print(line.strip())
    print(json.dumps({"sass": sass_contains("grad_weight", ("HGMMA", "UTMALDG"))}))

    record = {"card": card, "kind": torch.cuda.get_device_name(0), "build_s": seconds,
              "shapes": []}
    ok = True
    for i, (n, dx, dg) in enumerate(shapes(args.rows)):
        res, X, G = check(n, dx, dg, args.seed + i)
        ok &= res["ok"]
        if i < 2:  # the path shapes
            res["ms"] = time_ms(lambda: grad_weight(X, G, use_kernel=True), args.reps)
            res["library_ms"] = time_ms(
                lambda: torch.mm(X.t(), G, out_dtype=torch.float32), args.reps)
            res["plain_ms"] = time_ms(lambda: grad_weight_plain(X, G), args.reps)
            res["bound_ms"], res["bound_by"] = bound_ms(n, dx, dg)
            res["share_of_bound"] = res["bound_ms"] / res["ms"]
            res["host_us"] = host_us(lambda: grad_weight(X, G, use_kernel=True))
            res["library_host_us"] = host_us(
                lambda: torch.mm(X.t(), G, out_dtype=torch.float32))
            if args.profile:
                res["kernels_us"] = profile(X, G)
        print(json.dumps(res))
        record["shapes"].append(res)
        del X, G
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_grad_weight.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
