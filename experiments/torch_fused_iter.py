#!/usr/bin/env python3
"""Kernel B of the PyTorch/CUDA port (``fused_iter``: one bfloat16 depth
iteration ``relu(H0 + bf16(M(H)) @ W [+ b])``) on one GPU: its build, what its
machine code holds, its agreement with the plain version and its time beside
the unfused route of the same function.

    python3 experiments/torch_fused_iter.py [--reps 21] [--profile] [--tree DIR]

The graph is the benchmark batch (2048 molecules of
tests/data/regression/mol/mol.csv, tiled, as ``chip_smoke.py`` builds it:
[123,392 x d] edge tables), at d = 384 (the default model's hidden width 300,
padded) and d = 128. At each width the four ``relu_stream`` x bias forms are
held against ``fused_iter_plain`` (rtol two bf16 ulps, atol 0.02), the
padding rows against ``relu(H0 [+ b])`` and a second call against the first,
bit for bit. The plain form is timed (medians of ``--reps`` runs of 5 calls
between CUDA events) beside the composed route (kernel A's bf16 message,
then ``torch.mm`` by W, then ``torch.relu(H0 + z)``) and the bound: the
larger of the bytes (H and H0 read, y written, W and the ids read once) over
the memory rate and the products of the real rows over the bf16 tensor peak,
both of an H100 SXM. ``--profile`` traces 10 calls of each and prints the
device microseconds of every kernel they launch.

``--tree DIR`` imports ``chemprop_tpu_torch`` from another checkout (for
example a ``git archive`` of the parent commit), so that two versions of the
kernel are timed on the same card in one run; everything else comes from
this checkout. Prints one JSON line per width and a summary; the record goes
to chiprun_out/torch_fused_iter[_<tag>].json."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
MEM_RATE, BF16_PEAK = 3.35e12, 989e12  # H100 SXM, NVIDIA's data sheet
BF16_ULP = 2.0**-7


def bound_ms(n_e: int, n_real: int, n_v: int, d: int) -> tuple[float, str]:
    tb = (3 * n_e * d * 2 + d * d * 2 + 4 * (3 * n_e + n_v + 1)) / MEM_RATE * 1e3
    to = 2 * n_real * d * d / BF16_PEAK * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def host_us(fn, calls: int = 20) -> float:
    """Median host microseconds to enqueue one call, the device busy with
    earlier ones (so that no call waits for it)."""
    import statistics
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


def profile(fns: dict, calls: int = 10) -> dict:
    """Device microseconds per call of each kernel each function launches
    (``chip_smoke.kernel_trace``: a trace that misses calls is taken
    again); exits where every trace of a function missed calls."""
    from chip_smoke import TRACES, kernel_trace

    out = {}
    for name, fn in fns.items():
        trace = kernel_trace(fn, calls)
        if trace is None:
            raise SystemExit(f"profile: every trace of {name} missed calls: "
                             f"{TRACES['misses'][-3:]}")
        out[name] = {}
        for key, us in trace.items():  # kernels whose names share 60 characters add up
            out[name][key[:60]] = out[name].get(key[:60], 0.0) + us
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--tree", type=Path, default=None,
                    help="import chemprop_tpu_torch from this checkout instead")
    args = ap.parse_args()
    tree = (args.tree or REPO).resolve()
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(tree))
    from chip_smoke import benchmark_batch, lipo_dataset, time_ms  # the smoke run's own

    import torch

    if not torch.cuda.is_available():
        print("torch_fused_iter: no CUDA device", file=sys.stderr)
        return 2
    import chemprop_tpu_torch
    from chemprop_tpu_torch.ops import build
    from chemprop_tpu_torch.ops import fused_iter, message
    from chemprop_tpu_torch.ops.message import fused_iter_plain

    if Path(chemprop_tpu_torch.__file__).resolve().parent.parent != tree:
        print(f"torch_fused_iter: imported {chemprop_tpu_torch.__file__}, not {tree}",
              file=sys.stderr)
        return 2
    tag = "" if args.tree is None else "_" + tree.name
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    source = "fused_iter" if "fused_iter" in build.SOURCES else "message"
    log = build._finish(source, build._start(source))
    for line in log.splitlines():
        if "fused_iter" in line or "Used" in line or "error" in line or "arn" in line:
            print(f"[{source}] {line.strip()}")
    record = {"card": card, "kind": torch.cuda.get_device_name(0), "tree": str(tree),
              "source": f"chemprop_tpu_torch/csrc/{source}.cu", "widths": []}
    if hasattr(build, "sass_contains"):
        record["sass"] = build.sass_contains(source, ("HGMMA", "HMMA"))
        print(json.dumps({"sass": record["sass"]}))

    ds = lipo_dataset()
    bmg = benchmark_batch(ds, "cuda").bmg
    graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
    n_e, n_v = bmg.E.shape[0], bmg.V.shape[0]
    n_real = int(bmg.edge_mask.sum())
    pad = ~bmg.edge_mask
    ok = True
    for d in (384, 128):
        g = torch.Generator(device="cuda").manual_seed(args.seed + d)
        H = torch.randn((n_e, d), generator=g, device="cuda").to(torch.bfloat16)
        H0 = torch.randn((n_e, d), generator=g, device="cuda").to(torch.bfloat16)
        W = (torch.randn((d, d), generator=g, device="cuda") * d**-0.5).to(torch.bfloat16)
        b = torch.randn(d, generator=g, device="cuda").to(torch.bfloat16)
        res = {"d": d, "rows": n_e, "real_rows": n_real, "checks": {}}
        if hasattr(sys.modules["chemprop_tpu_torch.ops.message"], "fused_iter_info"):
            from chemprop_tpu_torch.ops.message import fused_iter_info

            res["launch"] = fused_iter_info(d, n_e)
        for relu_stream in (True, False):
            for bias in (None, b):
                x = H0 if relu_stream else H
                got = fused_iter(x, H0, W, bias, *graph, relu_stream=relu_stream)
                want = fused_iter_plain(x, H0, W, bias, *graph, relu_stream=relu_stream)
                err = (got.float() - want.float()).abs()
                limit = 0.02 + 2 * BF16_ULP * want.float().abs()
                pad_want = torch.relu(H0.float() + (0 if bias is None else bias.float()))
                pad_want = pad_want.to(torch.bfloat16)
                c = {"max_abs_err": float(err.max()), "max_err_over_limit":
                     float((err / limit).max()),
                     "padding_rows_exact": bool(torch.equal(got[pad], pad_want[pad])),
                     "bit_equal_rerun": bool(torch.equal(got, fused_iter(
                         x, H0, W, bias, *graph, relu_stream=relu_stream)))}
                c["ok"] = bool((err <= limit).all()) and c["padding_rows_exact"] and c[
                    "bit_equal_rerun"]
                ok &= c["ok"]
                res["checks"][f"relu_stream={relu_stream},bias={bias is not None}"] = c

        def composed():
            z = torch.mm(message(H, *graph), W)
            return torch.relu(H0 + z)

        res["ms"] = time_ms(lambda: fused_iter(H, H0, W, None, *graph), args.reps)
        res["composed_ms"] = time_ms(composed, args.reps)
        res["plain_ms"] = time_ms(lambda: fused_iter_plain(H, H0, W, None, *graph), args.reps)
        res["bound_ms"], res["bound_by"] = bound_ms(n_e, n_real, n_v, d)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        res["host_us"] = host_us(lambda: fused_iter(H, H0, W, None, *graph))
        res["composed_host_us"] = host_us(composed)
        if args.profile:
            res["kernels_us"] = profile({"fused_iter": lambda: fused_iter(H, H0, W, None, *graph),
                                         "composed": composed})
        print(json.dumps(res))
        record["widths"].append(res)
        del H, H0, W
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"torch_fused_iter{tag}.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"ok": ok, "tree": str(tree)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
