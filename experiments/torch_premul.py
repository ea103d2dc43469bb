#!/usr/bin/env python3
"""Kernel H of the PyTorch/CUDA port (``bwd_message_premul``: an earlier
iteration's backward ``dh = G_in W^T``, ``gz = dh [y > 0]``,
``G = (S - R)^T gz`` and ``z = gz (+ dh [H0 > 0])``) on one GPU: its build,
what its machine code holds, its agreement with the plain version and its
time beside the unfused route of the same function.

    python3 experiments/torch_premul.py [--reps 21] [--profile] [--tree DIR]

The graph is the benchmark batch (2048 molecules of
tests/data/regression/mol/mol.csv, tiled, as ``chip_smoke.py`` builds it:
[123,392 x d] edge tables and its tile table), at d = 384 (the default
model's hidden width 300, padded) and d = 128. At each width, with and
without ``fold_h0``, the kernel with the batch's tile table and without one
is held against ``bwd_message_premul_plain`` under ``chip_smoke.py``'s limits;
the two forms must agree bit for bit on every row, a second call with the
first, and padding rows must be zero. Timed (medians of ``--reps`` runs of 5
calls between CUDA events): the kernel with tiles, without tiles and without
``fold_h0``, the plain version, and the unfused route (``torch.mm(G_in,
W.t())``, then ``bwd_message(dh, y)`` for ``G`` and ``gz``, then
``z = gz + dh [H0 > 0]`` in PyTorch), beside the bound: the larger of the
bytes (G_in, y and H0 read, G and z written, W and the ids read once) over
the memory rate and the products of the real rows over the bf16 tensor peak,
both of an H100 SXM. ``--profile`` traces 10 calls of each and prints the
device microseconds of every kernel they launch, per call.

``--tree DIR`` imports ``chemprop_tpu_torch`` from another checkout (for
example a ``git archive`` of the parent commit, whose wrapper takes no tile
table: it then runs its one form), so that two versions of the kernel are
timed on the same card in one run; everything else comes from this
checkout. Every line carries the card's name and power limit. The record
goes to chiprun_out/torch_premul[_<tag>].json."""

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


def bound_ms(n_e: int, n_real: int, n_v: int, d: int, fold: bool) -> tuple[float, str]:
    tables = 5 if fold else 4
    tb = (tables * n_e * d * 2 + d * d * 2 + 4 * (n_e + n_v + 1)) / MEM_RATE * 1e3
    to = 2 * n_real * d * d / BF16_PEAK * 1e3
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
    sys.path.insert(0, str(tree))
    from chip_smoke import benchmark_batch, lipo_dataset, time_ms  # the smoke run's own
    from experiments.torch_fused_iter import host_us, profile

    import torch

    if not torch.cuda.is_available():
        print("torch_premul: no CUDA device", file=sys.stderr)
        return 2
    import chemprop_tpu_torch
    from chemprop_tpu_torch.ops import build, bwd_message, bwd_message_premul
    from chemprop_tpu_torch.ops.message import bwd_message_premul_plain

    if Path(chemprop_tpu_torch.__file__).resolve().parent.parent != tree:
        print(f"torch_premul: imported {chemprop_tpu_torch.__file__}, not {tree}",
              file=sys.stderr)
        return 2
    tag = "" if args.tree is None else "_" + tree.name
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    source = "bwd_premul" if "bwd_premul" in build.SOURCES else "message_bwd"
    log = build._finish(source, build._start(source))
    for line in log.splitlines():
        if any(k in line for k in ("Used", "spill", "error", "arn")):
            print(f"[{source}] {line.strip()}")
    tiled = "tiles" in inspect.signature(bwd_message_premul).parameters
    record = {"card": card, "kind": torch.cuda.get_device_name(0), "tree": str(tree),
              "source": f"chemprop_tpu_torch/csrc/{source}.cu", "tile_form": tiled, "widths": []}
    record["sass"] = build.sass_contains(source, ("HGMMA", "UTMALDG", "HMMA"))
    print(json.dumps({"card": card, "sass": record["sass"]}))

    ds = lipo_dataset()
    bmg = benchmark_batch(ds, "cuda").bmg
    graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
    n_e, n_v = bmg.E.shape[0], bmg.V.shape[0]
    n_real = int(bmg.edge_mask.sum())
    pad = ~bmg.edge_mask
    tiles = bmg.tile_ptr
    ok = tiles is not None
    for d in (384, 128):
        g = torch.Generator(device="cuda").manual_seed(args.seed + d)
        G_in = torch.randn((n_e, d), generator=g, device="cuda").to(torch.bfloat16)
        y = torch.randn((n_e, d), generator=g, device="cuda").clamp_min(0).to(torch.bfloat16)
        H0 = torch.randn((n_e, d), generator=g, device="cuda").to(torch.bfloat16)
        W = (torch.randn((d, d), generator=g, device="cuda") * d**-0.5).to(torch.bfloat16)
        res = {"card": card, "d": d, "rows": n_e, "real_rows": n_real, "tiles": tiles.numel() - 1,
               "checks": {}}
        if tiled:
            from chemprop_tpu_torch.ops.message import bwd_message_premul_info

            res["launch"] = bwd_message_premul_info(d, tiles.numel() - 1)

        def kernel(fold, with_tiles=True):
            kw = {"tiles": tiles} if tiled and with_tiles else {}
            return bwd_message_premul(G_in, y, H0, W, *graph, fold_h0=fold, **kw)

        for fold in (True, False):
            got = kernel(fold)
            want_G, want_z = bwd_message_premul_plain(G_in, y, H0, W, *graph, fold_h0=fold)
            # chip_smoke.py's limits: z one ulp of a value apart (1e-4 near
            # zero), G one ulp of each of its terms and one of its own rounding
            gz_abs = ((G_in.float() @ W.float().t()) * (y > 0)).abs()
            terms = torch.zeros((n_v, d), device="cuda").index_add_(
                0, bmg.dst.long(), gz_abs[bmg.rev.long()])[bmg.dst.long()]
            c = {}
            for name, a, w, scale in (("G", got[0], want_G, terms), ("z", got[1], want_z, None)):
                err = (a.float() - w.float()).abs()
                limit = 1e-4 + 2 * BF16_ULP * (w.float().abs() if scale is None else scale)
                c[f"{name}_max_abs_err"] = float(err.max())
                c[f"{name}_max_err_over_limit"] = float((err / limit).max())
                c[f"{name}_ok"] = bool((err <= limit).all())
            c["padding_rows_zero"] = not (got[0][pad].any() or got[1][pad].any())
            again = kernel(fold)
            c["bit_equal_rerun"] = bool(torch.equal(got[0], again[0]) and
                                        torch.equal(got[1], again[1]))
            if tiled:
                other = kernel(fold, with_tiles=False)
                c["bit_equal_without_tiles"] = bool(torch.equal(got[0], other[0]) and
                                                    torch.equal(got[1], other[1]))
            c["ok"] = all(v for k, v in c.items() if isinstance(v, bool))
            ok &= c["ok"]
            res["checks"][f"fold_h0={fold}"] = c

        def unfused():
            dh = torch.mm(G_in, W.t())
            G, gz = bwd_message(dh, y, *graph)
            return G, gz + dh * (H0 > 0)

        res["ms"] = time_ms(lambda: kernel(True), args.reps)
        if tiled:
            res["without_tiles_ms"] = time_ms(lambda: kernel(True, False), args.reps)
        res["without_fold_h0_ms"] = time_ms(lambda: kernel(False), args.reps)
        res["unfused_ms"] = time_ms(unfused, args.reps)
        res["plain_ms"] = time_ms(
            lambda: bwd_message_premul_plain(G_in, y, H0, W, *graph, fold_h0=True), args.reps)
        res["bound_ms"], res["bound_by"] = bound_ms(n_e, n_real, n_v, d, True)
        res["without_fold_h0_bound_ms"] = bound_ms(n_e, n_real, n_v, d, False)[0]
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        res["host_us"] = host_us(lambda: kernel(True))
        if args.profile:
            fns = {"kernel": lambda: kernel(True), "unfused": unfused}
            if tiled:
                fns["without_tiles"] = lambda: kernel(True, False)
            res["kernels_us"] = profile(fns)
        print(json.dumps(res))
        record["widths"].append(res)
        del G_in, y, H0, W
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"torch_premul{tag}.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"ok": ok, "tree": str(tree), "card": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
