#!/usr/bin/env python3
"""Kernel A of the PyTorch/CUDA port (``message``:
``M[e] = sum_{k : dst[k] == src[e]} H[k] - H[rev[e]]``) on one GPU: its
build, what its machine code holds, its agreement with the plain version and
its time beside message.cu's form and the one library call that computes the
same function.

    python3 experiments/torch_message.py [--reps 21] [--profile] [--tree DIR]

The graph is the benchmark batch (2048 molecules of
tests/data/regression/mol/mol.csv, tiled, as ``chip_smoke.py`` builds it:
[123,392 x d] edge tables and their tile table), at d = 384 (the default
model's hidden width 300, padded) and d = 128, in bfloat16 (the composed path
of a non-ReLU or undirected model) and float32 (the f32 model's
iterations). At each width and dtype the kernel with the batch's tile table
is held against ``message_plain`` under ``chip_smoke.py``'s limits (float32
1e-5, bfloat16 one ulp) and against message.cu's form (no table) and a
second call bit for bit on every row, and its padding rows must be zero.
Timed (medians of ``--reps`` runs of 5 calls between CUDA events): the
kernel with the tile table and without one (message.cu), the plain version,
``torch.sparse.mm`` of ``S - R`` in CSR form (built once, outside the timed
calls) with H, and a plain device copy of H (the rate a kernel moving these
bytes can expect), beside the bound: the bytes the function must move
(``chip_smoke.message_bytes``: H over the real rows, M over every row, the
ids of the real rows and nodes, the tile table) over the memory rate, or the
adds over the f32 peak, both of an H100 SXM. It prints the launch shape
(slice width, slices, stages, shared memory, grid, blocks per SM).
``--profile`` traces 10 calls of each and prints the device microseconds of
every kernel they launch, per call.

``--tree DIR`` imports ``chemprop_tpu_torch`` from another checkout (for
example a ``git archive`` of the parent commit, whose wrapper takes no tile
table: it then runs its one form), so that two versions of the kernel are
timed on the same card in one run; everything else comes from this
checkout. Every line carries the card's name and power limit. The record
goes to chiprun_out/torch_message[_<tree>][_profile].json."""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
MEM_RATE, F32_PEAK = 3.35e12, 67e12  # H100 SXM, NVIDIA's data sheet
BF16_ULP = 2.0**-7


def bound_ms(nbytes: int, adds: float) -> tuple[float, str]:
    """The bytes of ``chip_smoke.message_bytes`` over the memory rate, or the
    adds (per real row and element, one per in-edge of its source and one
    subtraction) over the f32 peak, whichever takes longer."""
    tb, to = nbytes / MEM_RATE * 1e3, adds / F32_PEAK * 1e3
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
    from chip_smoke import benchmark_batch, lipo_dataset, message_bytes, message_matrix, time_ms
    from experiments.torch_fused_iter import host_us, profile

    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("torch_message: no CUDA device", file=sys.stderr)
        return 2
    import chemprop_tpu_torch
    from chemprop_tpu_torch.ops import build, message
    from chemprop_tpu_torch.ops.message import message_plain

    if Path(chemprop_tpu_torch.__file__).resolve().parent.parent != tree:
        print(f"torch_message: imported {chemprop_tpu_torch.__file__}, not {tree}",
              file=sys.stderr)
        return 2
    tag = ("" if args.tree is None else "_" + tree.name) + ("_profile" if args.profile else "")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    tiled = "tiles" in inspect.signature(message).parameters
    source = "message_tiles" if tiled else "message"
    log = build._finish(source, build._start(source))
    for line in log.splitlines():
        if any(k in line for k in ("Used", "spill", "error", "arn")):
            print(f"[{source}] {line.strip()}")
    record = {"card": card, "kind": torch.cuda.get_device_name(0), "tree": str(tree),
              "source": f"chemprop_tpu_torch/csrc/{source}.cu", "tile_form": tiled, "runs": []}
    record["sass"] = build.sass_contains(source, ("UBLKCP", "SYNCS"))
    print(json.dumps({"card": card, "sass": record["sass"]}))

    bmg = benchmark_batch(lipo_dataset(), "cuda").bmg
    graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
    n_e = bmg.E.shape[0]
    real = bmg.edge_mask
    n_real = int(real.sum())
    pad = ~real
    tiles = bmg.tile_ptr
    in_deg = (bmg.edge_ptr[1:] - bmg.edge_ptr[:-1]).long()
    adds_per_col = float((in_deg[bmg.src.long()][real] + 1).sum())
    SR32 = message_matrix(bmg)
    ok = tiles is not None
    for d in (384, 128):
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(args.seed + d)
            H = torch.randn((n_e, d), generator=g, device="cuda").to(dtype)
            name = str(dtype).removeprefix("torch.")
            res = {"card": card, "d": d, "dtype": name, "rows": n_e, "real_rows": n_real,
                   "tiles": tiles.numel() - 1}
            if tiled:
                from chemprop_tpu_torch.ops.message import message_info

                res["launch"] = message_info(d, dtype, tiles.numel() - 1)

            def kernel(with_tiles=True):
                return message(H, *graph, tiles) if tiled and with_tiles else message(H, *graph)

            got = kernel()
            want = message_plain(H, *graph)
            # chip_smoke.py's limits: f32 sums in another order than the plain
            # version's, rounded once to bf16 in bfloat16
            rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (BF16_ULP, 1e-6)
            err = (got.float() - want.float()).abs()
            limit = atol + rtol * want.float().abs()
            c = {"max_abs_err": float(err.max()),
                 "max_err_over_limit": float((err / limit).max()),
                 "within_limit": bool((err <= limit).all()),
                 "padding_rows_zero": not got[pad].any(),
                 "bit_equal_rerun": bool(torch.equal(got, kernel()))}
            if tiled:
                c["bit_equal_without_tiles"] = bool(torch.equal(got, kernel(False)))
            c["ok"] = all(v for v in c.values() if isinstance(v, bool))
            ok &= c["ok"]
            res["checks"] = c

            res["ms"] = time_ms(kernel, args.reps)
            if tiled:
                res["without_tiles_ms"] = time_ms(lambda: kernel(False), args.reps)
            res["plain_ms"] = time_ms(lambda: message_plain(H, *graph), args.reps)
            try:  # the yardstick only: the card's PyTorch may refuse a bf16 CSR product
                SR = SR32.to(dtype)
                res["sparse_mm_ms"] = time_ms(lambda: torch.sparse.mm(SR, H), args.reps)
            except RuntimeError as e:
                SR = None
                res["sparse_mm_ms"] = f"torch.sparse.mm refused {name}: {e}".splitlines()[0]
            # the card's rate on a plain copy of H (one table read, one written)
            H_copy = torch.empty_like(H)
            res["copy_ms"] = time_ms(lambda: H_copy.copy_(H), args.reps)
            res["copy_tb_per_s"] = 2 * H.numel() * H.element_size() / res["copy_ms"] / 1e9
            res["bytes"] = message_bytes(bmg, d, H.element_size())
            res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], adds_per_col * d)
            res["share_of_bound"] = res["bound_ms"] / res["ms"]
            res["host_us"] = host_us(kernel)
            if args.profile:
                fns = {"kernel": kernel, "copy": lambda: H_copy.copy_(H)}
                if tiled:
                    fns["without_tiles"] = lambda: kernel(False)
                if SR is not None:
                    fns["sparse_mm"] = lambda: torch.sparse.mm(SR, H)
                res["kernels_us"] = profile(fns)
            print(json.dumps(res), flush=True)
            record["runs"].append(res)
            del H, H_copy, SR
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"torch_message{tag}.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"ok": ok, "tree": str(tree), "card": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
