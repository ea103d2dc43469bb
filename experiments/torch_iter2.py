#!/usr/bin/env python3
"""Kernel D of the PyTorch/CUDA port (``fused_iter2``: the first two
bfloat16 depth iterations in one launch over the batch's tile table) on one
GPU: its build, what its machine code holds, its agreement with two
``fused_iter`` (kernel B) launches and with the plain version, and its time
beside those two launches.

    python3 experiments/torch_iter2.py [--reps 21] [--profile] [--tree DIR]

The graph is the benchmark batch (2048 molecules of
tests/data/regression/mol/mol.csv, tiled, as ``chip_smoke.py`` builds it:
[123,392 x d] edge tables and its tile table of 1272 tiles), at d = 384 (the
default model's hidden width 300, padded) and d = 128. At each width, with and
without a bias, y1 and y2 must equal two B launches bit for bit on every row
and a second call bit for bit, and lie within ``chip_smoke.py``'s limits of
the plain version (two bf16 ulps + 0.02 for y1, + 0.05 for y2); with H0's
padding rows zero, the padding rows of y1 and y2 must be zero. Timed (medians
of ``--reps`` runs of 5 calls between CUDA events): the kernel, the two B
launches it stands for and the plain version, beside the bound: the larger of
the bytes the function must move (``chip_smoke.fused_iter2_bytes``: H0 read,
y1 and y2 written over every row, W once, the ids of the real rows and the
tile table) over the memory rate and the two products' operations over the
bf16 tensor peak, both of an H100 SXM. It prints the launch shape (route,
CTAs per cluster, stages, shared memory, clusters). ``--profile`` traces 10
calls of each and prints the device microseconds of every kernel they launch,
per call.

``--tree DIR`` imports ``chemprop_tpu_torch`` from another checkout (for
example a ``git archive`` of the parent commit), so that two versions of the
kernel are timed on the same card in one run; everything else comes from this
checkout. Every line carries the card's name and power limit. The record goes
to chiprun_out/torch_iter2[_<tree>][_profile].json."""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
MEM_RATE, BF16_PEAK = 3.35e12, 989e12  # H100 SXM, NVIDIA's data sheet
BF16_ULP = 2.0**-7


def bound_ms(nbytes: int, n_real: int, d: int) -> tuple[float, str]:
    """The bytes of ``chip_smoke.fused_iter2_bytes`` over the memory rate, or
    the two products over the real rows (``4 n d^2`` operations) over the
    bf16 tensor peak, whichever takes longer."""
    tb, to = nbytes / MEM_RATE * 1e3, 4 * n_real * d * d / BF16_PEAK * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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
    # the smoke run's own helpers, from this checkout whatever --tree says
    from chip_smoke import benchmark_batch, fused_iter2_bytes, lipo_dataset, time_ms
    from experiments.torch_fused_iter import host_us, profile

    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("torch_iter2: no CUDA device", file=sys.stderr)
        return 2
    import chemprop_tpu_torch
    from chemprop_tpu_torch.ops import build, fused_iter, fused_iter2

    message_ops = importlib.import_module("chemprop_tpu_torch.ops.message")

    if Path(chemprop_tpu_torch.__file__).resolve().parent.parent != tree:
        print(f"torch_iter2: imported {chemprop_tpu_torch.__file__}, not {tree}",
              file=sys.stderr)
        return 2
    tag = ("" if args.tree is None else "_" + tree.name) + ("_profile" if args.profile else "")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    source = "iter2" if "iter2" in build.SOURCES else "message"
    for name in (source, "fused_iter"):
        log = build._finish(name, build._start(name))
        for line in log.splitlines():
            if any(k in line for k in ("Used", "spill", "error", "arn", "Performance")):
                print(f"[{name}] {line.strip()}")
    record = {"card": card, "kind": torch.cuda.get_device_name(0), "tree": str(tree),
              "source": f"chemprop_tpu_torch/csrc/{source}.cu", "widths": []}
    record["sass"] = build.sass_contains(source, ("HGMMA", "UTMALDG"))
    print(json.dumps({"card": card, "sass": record["sass"]}))

    bmg = benchmark_batch(lipo_dataset(), "cuda").bmg
    graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
    n_e = bmg.E.shape[0]
    n_real = int(bmg.edge_mask.sum())
    pad = ~bmg.edge_mask
    tiles = bmg.tile_ptr
    ok = tiles is not None
    for d in (384, 128):
        gen = torch.Generator(device="cuda").manual_seed(args.seed + d)
        H0 = torch.randn((n_e, d), generator=gen, device="cuda").to(torch.bfloat16)
        W = (torch.randn((d, d), generator=gen, device="cuda") * d**-0.5).to(torch.bfloat16)
        bias = torch.randn(d, generator=gen, device="cuda").to(torch.bfloat16)
        res = {"card": card, "d": d, "rows": n_e, "real_rows": n_real,
               "tiles": tiles.numel() - 1}
        if hasattr(message_ops, "fused_iter2_info"):
            res["launch"] = message_ops.fused_iter2_info(d, tiles.numel() - 1)
            print(json.dumps({"d": d, "launch": res["launch"]}))

        def kernel(b=None, h0=H0):
            return fused_iter2(h0, W, b, *graph, tiles)

        def two_launches(b=None, h0=H0):
            y1 = fused_iter(h0, h0, W, b, *graph, relu_stream=True)
            return y1, fused_iter(y1, h0, W, b, *graph)

        c = {}
        for b in (None, bias):
            key = "bias" if b is not None else "no_bias"
            got, want = kernel(b), two_launches(b)
            c[f"{key}_equal_to_two_launches"] = all(torch.equal(g, w) for g, w in zip(got, want))
            again = kernel(b)
            c[f"{key}_bit_equal_rerun"] = all(torch.equal(g, a) for g, a in zip(got, again))
            p1, p2 = message_ops.fused_iter2_plain(H0, W, b, *graph)
            for name, g, p, atol in (("y1", got[0], p1, 0.02), ("y2", got[1], p2, 0.05)):
                err = (g.float() - p.float()).abs()
                limit = atol + 2 * BF16_ULP * p.float().abs()
                c[f"{key}_{name}_max_abs_err"] = float(err.max())
                c[f"{key}_{name}_within_limit"] = bool((err <= limit).all())
        H0z = H0.masked_fill(pad[:, None], 0)
        y1z, y2z = kernel(None, H0z)
        c["padding_rows_zero"] = not (y1z[pad].any() or y2z[pad].any())
        c["ok"] = all(v for v in c.values() if isinstance(v, bool))
        ok &= c["ok"]
        res["checks"] = c
        print(json.dumps({"d": d, "checks": c}))

        res["ms"] = time_ms(kernel, args.reps)
        res["two_fused_iter_ms"] = time_ms(two_launches, args.reps)
        res["plain_ms"] = time_ms(lambda: message_ops.fused_iter2_plain(H0, W, None, *graph),
                                  args.reps)
        res["bytes"] = fused_iter2_bytes(bmg, d)
        res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], n_real, d)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        res["host_us"] = host_us(kernel)
        if args.profile:
            res["kernels_us"] = profile({"kernel": kernel, "two_fused_iter": two_launches})
        print(json.dumps(res))
        record["widths"].append(res)
        del H0, W, bias, H0z, y1z, y2z
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"torch_iter2{tag}.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"ok": ok, "tree": str(tree), "card": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
