#!/usr/bin/env python3
"""Kernel E of the PyTorch/CUDA port (``iter_bwd``: the whole backward of one
bfloat16 depth iteration, ``gz = g [y > 0]``, ``G = (S - R)^T gz`` never
written, ``dH = G W^T`` and ``dW = H^T G``) on one GPU: its build, what its
machine code holds, its agreement with the plain version and its time beside
the composed route of the same function.

    python3 experiments/torch_iter_bwd.py [--reps 21] [--profile] [--tree DIR]

The graph is the benchmark batch (2048 molecules of
tests/data/regression/mol/mol.csv, tiled, as ``chip_smoke.py`` builds it:
[123,392 x d] edge tables and its tile table), at d = 384 (the default
model's hidden width 300, padded) and d = 128. At each width the kernel with
the batch's tile table and without one is held against ``iter_bwd_plain``
under ``chip_smoke.py``'s limits (gz exactly, dH two bf16 ulps + 1e-4 of
``|G| |W|^T``, dW rtol 1e-4 / atol 1e-3 of ``|H|^T |G|``); the two forms' gz
must be equal bit for bit, a second call equal to the first, and padding rows
zero. Timed (medians of ``--reps`` runs of 5 calls between CUDA events): the
kernel with tiles and without, the plain version, and the composed route
(``bwd_message``, then ``G @ W^T`` and ``H^T G`` as library products), beside
the bound: the larger of the bytes the function must move
(``chip_smoke.iter_bwd_bytes``: g, y and H over the real rows, dH and gz over
every row, W, dW and the ids of the real rows) over the memory rate and the
products' operations over the bf16 tensor peak, both of an H100 SXM. It
prints the launch shape (blocks per cluster, shared memory, clusters).
``--profile`` traces 10 calls of each and prints the device microseconds of
every kernel they launch, per call. ``--trace`` also builds the kernel with
``-DIB_TRACE`` and prints, from the first cluster's global-timer stamps over
its first 64 halves of tiles (256 ns ticks on an H100), the median
nanoseconds of each step of a half (the mask, G's box, the wait for the
cluster's half buffer, the copy and the pushes and their spread over the
cluster, the products, the products' wait for G) and of a whole half.

``--tree DIR`` imports ``chemprop_tpu_torch`` from another checkout (for
example a ``git archive`` of the parent commit, whose wrapper takes no tile
table: it then runs its one form), so that two versions of the kernel are
timed on the same card in one run; everything else comes from this
checkout. Every line carries the card's name and power limit. The record
goes to chiprun_out/torch_iter_bwd[_<tree>][_profile].json."""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
MEM_RATE, BF16_PEAK = 3.35e12, 989e12  # H100 SXM, NVIDIA's data sheet
BF16_ULP = 2.0**-7


def bound_ms(nbytes: int, n_real: int, d: int) -> tuple[float, str]:
    """The bytes of ``chip_smoke.iter_bwd_bytes`` over the memory rate, or
    the two products over the real rows (``4 n d^2`` operations) over the
    bf16 tensor peak, whichever takes longer."""
    tb, to = nbytes / MEM_RATE * 1e3, 4 * n_real * d * d / BF16_PEAK * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def trace_steps(bmg, d: int, tensors) -> dict:
    """The traced build's median nanoseconds per step of a half (see the
    module's docstring), from the timer stamps of the first cluster."""
    import ctypes
    import statistics

    import numpy as np
    import torch

    from chemprop_tpu_torch.ops import build

    out = build.BUILD_DIR / "iter_bwd_trace.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DIB_TRACE", "-o", str(out),
                    str(build.CSRC / "iter_bwd.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in build.SIGNATURES["iter_bwd"].items():
        getattr(lib, fn).argtypes = argtypes
    lib.iter_bwd_trace.argtypes = [ctypes.c_void_p]
    g, y, H, W = tensors
    n, tiles = g.shape[0], bmg.tile_ptr
    clusters = lib.iter_bwd_clusters(d, tiles.numel() - 1)
    dH, gz = torch.empty_like(g), torch.empty_like(g)
    dW = torch.empty((d, d), dtype=torch.float32, device="cuda")
    partial = torch.empty((clusters, d, d), dtype=torch.float32, device="cuda")
    args = [t.data_ptr() for t in (g, y, H, W, bmg.dst, bmg.rev, bmg.edge_ptr, tiles)]
    args += [None, None, None]  # a tile table: no cross rows
    args += [t.data_ptr() for t in (dH, gz, partial, dW)]
    stream = torch.cuda.current_stream().cuda_stream
    stamps = np.zeros((8, 64, 9), np.int64)
    for _ in range(3):  # the last call's stamps
        err = lib.iter_bwd_tiles(*args, n, d, bmg.edge_ptr.numel() - 2, tiles.numel() - 1,
                                 clusters, 0, stream)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"traced iter_bwd_tiles: CUDA error {err}")
    lib.iter_bwd_trace(stamps.ctypes.data)
    ranks = d // 64
    used = int((stamps[:ranks, :, 8] > 0).all(0).sum())
    s = stamps[:ranks, :used].astype(np.float64)  # [rank, half, event], ns
    first = s[0]
    tile_start = first[:, 0] > 0  # the first half of each tile
    waited = s[:, 1:, 7] - s[:, :-1, 8] > 256  # the consumers waited for G
    steps = {
        "mask": (first[:, 1] - first[:, 0])[tile_start],
        "node_tasks": first[:, 3] - first[:, 2],
        "form_G_box": first[:, 4] - first[:, 2],
        "wait_for_G_buffer": first[:, 5] - first[:, 4],
        "copy_and_issue_pushes": first[:, 6] - first[:, 5],
        "products": first[:, 8] - first[:, 7],
        "products_waiting_for_G": first[1:, 7] - first[:-1, 8],
        "half": first[1:, 8] - first[:-1, 8],
        # across the cluster: the spread of the pushes' issue, and G whole
        # after the last push, where the consumers waited for it
        "push_issue_spread": s[:, :, 6].max(0) - s[:, :, 6].min(0),
        "last_push_to_G_full": (s[:, 1:, 7] - s[:, 1:, 6].max(0))[waited],
    }
    return {"halves_traced": used, "unit": "ns",
            **{k: statistics.median(v.tolist()) for k, v in steps.items() if len(v)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--tree", type=Path, default=None,
                    help="import chemprop_tpu_torch from this checkout instead")
    args = ap.parse_args()
    tree = (args.tree or REPO).resolve()
    sys.path.insert(0, str(REPO))
    # the smoke run's own helpers, from this checkout whatever --tree says
    from chip_smoke import benchmark_batch, iter_bwd_bytes, lipo_dataset, time_ms
    from experiments.torch_fused_iter import host_us, profile

    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("torch_iter_bwd: no CUDA device", file=sys.stderr)
        return 2
    import chemprop_tpu_torch
    from chemprop_tpu_torch.ops import build, bwd_message, grad_weight, iter_bwd
    from chemprop_tpu_torch.ops.message import bwd_message_plain, iter_bwd_plain

    if Path(chemprop_tpu_torch.__file__).resolve().parent.parent != tree:
        print(f"torch_iter_bwd: imported {chemprop_tpu_torch.__file__}, not {tree}",
              file=sys.stderr)
        return 2
    tag = ("" if args.tree is None else "_" + tree.name) + ("_profile" if args.profile else "")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    tiled = "tiles" in inspect.signature(iter_bwd).parameters
    source = "iter_bwd" if tiled else "message_bwd"
    log = build._finish(source, build._start(source))
    for line in log.splitlines():
        if any(k in line for k in ("Used", "spill", "error", "arn", "Performance")):
            print(f"[{source}] {line.strip()}")
    record = {"card": card, "kind": torch.cuda.get_device_name(0), "tree": str(tree),
              "source": f"chemprop_tpu_torch/csrc/{source}.cu", "tile_form": tiled, "widths": []}
    record["sass"] = build.sass_contains(source, ("HGMMA", "UTMALDG", "UBLKCP"))
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
        g = torch.randn((n_e, d), generator=gen, device="cuda").to(torch.bfloat16)
        y = torch.randn((n_e, d), generator=gen, device="cuda").clamp_min(0).to(torch.bfloat16)
        # an iteration's input, a ReLU output; its padding rows are not zero
        H = torch.randn((n_e, d), generator=gen, device="cuda").clamp_min(0).to(torch.bfloat16)
        W = (torch.randn((d, d), generator=gen, device="cuda") * d**-0.5).to(torch.bfloat16)
        res = {"card": card, "d": d, "rows": n_e, "real_rows": n_real,
               "tiles": tiles.numel() - 1}
        if tiled:
            from chemprop_tpu_torch.ops.message import iter_bwd_info

            res["launch"] = iter_bwd_info(d, tiles.numel() - 1)

        def kernel(with_tiles=True):
            kw = {"tiles": tiles} if tiled and with_tiles else {}
            return iter_bwd(g, y, H, W, *graph, **kw)

        def composed():
            G, gz = bwd_message(g, y, *graph)
            return G @ W.t(), gz, grad_weight(H, G)

        got = kernel()
        want_dH, want_gz, want_dW = iter_bwd_plain(g, y, H, W, *graph)
        G_abs = bwd_message_plain(g, y, *graph)[0].float().abs()
        c = {}
        for name, a, w, rtol, atol, scale in (
            ("dH", got[0], want_dH, 2 * BF16_ULP, 1e-4, G_abs @ W.float().abs().t()),
            ("dW", got[2], want_dW, 1e-4, 1e-3,
             H.float().masked_fill(pad[:, None], 0).t() @ G_abs),
        ):
            err = (a.float() - w.float()).abs()
            limit = atol + rtol * scale
            c[f"{name}_max_abs_err"] = float(err.max())
            c[f"{name}_max_err_over_limit"] = float((err / limit).max())
            c[f"{name}_ok"] = bool((err <= limit).all())
        c["gz_equal"] = bool(torch.equal(got[1], want_gz))
        c["padding_rows_zero"] = not (got[0][pad].any() or got[1][pad].any())
        c["finite"] = bool(got[0].isfinite().all() and got[2].isfinite().all())
        again = kernel()
        c["bit_equal_rerun"] = all(torch.equal(a, b) for a, b in zip(got, again))
        if tiled:
            other = kernel(with_tiles=False)
            c["gz_equal_without_tiles"] = bool(torch.equal(got[1], other[1]))
        c["ok"] = all(v for v in c.values() if isinstance(v, bool))
        ok &= c["ok"]
        res["checks"] = c
        print(json.dumps({"d": d, "checks": c}))

        res["ms"] = time_ms(kernel, args.reps)
        if tiled:
            res["without_tiles_ms"] = time_ms(lambda: kernel(False), args.reps)
        res["composed_ms"] = time_ms(composed, args.reps)
        res["plain_ms"] = time_ms(lambda: iter_bwd_plain(g, y, H, W, *graph), args.reps)
        res["bytes"] = iter_bwd_bytes(bmg, d)
        res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], n_real, d)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        res["host_us"] = host_us(kernel)
        if args.trace and tiled:
            res["trace_ns"] = trace_steps(bmg, d, (g, y, H, W))
        if args.profile:
            fns = {"kernel": kernel, "composed": composed}
            if tiled:
                fns["without_tiles"] = lambda: kernel(False)
            res["kernels_us"] = profile(fns)
        print(json.dumps(res))
        record["widths"].append(res)
        del g, y, H, W
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"torch_iter_bwd{tag}.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"ok": ok, "tree": str(tree), "card": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
