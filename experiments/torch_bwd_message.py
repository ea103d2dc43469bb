#!/usr/bin/env python3
"""Kernel F of the PyTorch/CUDA port (``bwd_message``: one depth iteration's
masked transposed message, ``gz = g [y > 0] (+ gz_acc)`` and
``G = (S - R)^T (g [y > 0])``) on one GPU: its build, what its machine code
holds, its agreement with the plain version and with its node-warp form, and
its time beside the library calls that compute the same function.

    python3 experiments/torch_bwd_message.py [--reps 21] [--profile] [--tree DIR]

The graph is the benchmark batch (2048 molecules of
tests/data/regression/mol/mol.csv, tiled, as ``chip_smoke.py`` builds it:
[123,392 x d] edge tables and its tile table), at d = 384 (the default
model's hidden width 300, padded) and d = 128, in three forms: float32 (the
float32 training step), bfloat16 (the bfloat16 dropout step) and bfloat16
with ``gz_acc`` (the depth loop's second call). In each the kernel with the
batch's tile table is held against ``bwd_message_plain`` under
``chip_smoke.py``'s limits (float32: 1e-5; bfloat16: one ulp), against its
node-warp form (``csrc/message_bwd.cu``, the call without a table) bit for bit
on every row, and against a second call; padding rows must be zero. Timed
(medians of ``--reps`` runs of 5 calls between CUDA events): the kernel with
the table and without, the plain version, ``torch.sparse.mm`` of (S - R)^T
in CSR with the masked cotangent (one library call that forms G alone; the
mask is formed outside the timed call), the two-call library route that
forms both outputs (``g * (y > 0)`` (+ ``gz_acc``), then the sparse product),
and a plain device copy of g (the rate a kernel moving these bytes can
expect), beside the bound: the larger of the bytes the function must move
(``chip_smoke.bwd_message_bytes``) over the memory rate and the adds over the
f32 peak, both of an H100 SXM. ``--profile`` traces 10 calls of each and
prints the device microseconds of every kernel they launch, per call.

``--tree DIR`` imports ``chemprop_tpu_torch`` from another checkout (for
example a ``git archive`` of the parent commit, whose wrapper takes no tile
table: it then runs its one form), so that two versions of the kernel are
timed on the same card; everything else comes from this checkout. Every line
carries the card's name and power limit. The record goes to
chiprun_out/torch_bwd_message[_<tree>][_profile].json."""

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


def bound_ms(nbytes: int, ops: float) -> tuple[float, str]:
    """Bytes over the memory rate, or operations over the f32 peak, whichever
    takes longer."""
    tb, to = nbytes / MEM_RATE * 1e3, ops / F32_PEAK * 1e3
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
    from chip_smoke import (benchmark_batch, bwd_message_bytes, lipo_dataset, message_matrix,
                            time_ms)
    from experiments.torch_fused_iter import host_us, profile

    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_message: no CUDA device", file=sys.stderr)
        return 2
    import chemprop_tpu_torch
    from chemprop_tpu_torch.ops import build, bwd_message
    from chemprop_tpu_torch.ops.message import bwd_message_plain

    if Path(chemprop_tpu_torch.__file__).resolve().parent.parent != tree:
        print(f"torch_bwd_message: imported {chemprop_tpu_torch.__file__}, not {tree}",
              file=sys.stderr)
        return 2
    tag = ("" if args.tree is None else "_" + tree.name) + ("_profile" if args.profile else "")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    tiled = "tiles" in inspect.signature(bwd_message).parameters
    source = "message_bwd_tiles" if tiled else "message_bwd"
    log = build._finish(source, build._start(source))
    for line in log.splitlines():
        if any(k in line for k in ("Used", "spill", "error", "arn")):
            print(f"[{source}] {line.strip()}")
    record = {"card": card, "kind": torch.cuda.get_device_name(0), "tree": str(tree),
              "source": f"chemprop_tpu_torch/csrc/{source}.cu", "tile_form": tiled, "cases": []}
    record["sass"] = build.sass_contains(source, ("UBLKCP", "UTMALDG", "SYNCS"))
    print(json.dumps({"card": card, "sass": record["sass"]}))

    bmg = benchmark_batch(lipo_dataset(), "cuda").bmg
    graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
    n_e = bmg.E.shape[0]
    n_real = int(bmg.edge_mask.sum())
    pad = ~bmg.edge_mask
    tiles = bmg.tile_ptr
    SRt32 = message_matrix(bmg).to_sparse_coo().t().coalesce().to_sparse_csr()
    ok = tiles is not None
    forms = (("float32", torch.float32, False), ("bfloat16", torch.bfloat16, False),
             ("bfloat16_gz_acc", torch.bfloat16, True))
    for d in (384, 128):
        for name, dtype, with_acc in forms:
            g = torch.Generator(device="cuda").manual_seed(args.seed + d)
            gg = torch.randn((n_e, d), generator=g, device="cuda").to(dtype)
            y = torch.randn((n_e, d), generator=g, device="cuda").clamp_min(0).to(dtype)
            acc = torch.randn((n_e, d), generator=g, device="cuda").to(dtype) if with_acc else None
            res = {"card": card, "d": d, "form": name, "rows": n_e, "real_rows": n_real,
                   "tiles": tiles.numel() - 1}
            if tiled:
                from chemprop_tpu_torch.ops.message import bwd_message_info

                res["launch"] = bwd_message_info(d, dtype, tiles.numel() - 1)

            def kernel(with_tiles=True):
                kw = {"tiles": tiles} if tiled and with_tiles else {}
                return bwd_message(gg, y, *graph, gz_acc=acc, **kw)

            got = kernel()
            want_G, want_gz = bwd_message_plain(gg, y, *graph, gz_acc=acc)
            rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (BF16_ULP, 1e-6)
            c = {}
            for key, x, w in (("G", got[0], want_G), ("gz", got[1], want_gz)):
                err = (x.float() - w.float()).abs()
                limit = atol + rtol * w.float().abs()
                c[f"{key}_max_abs_err"] = float(err.max())
                c[f"{key}_ok"] = bool((err <= limit).all())
            c["padding_rows_zero"] = not (got[0][pad].any() or got[1][pad].any())
            again = kernel()
            c["bit_equal_rerun"] = bool(torch.equal(got[0], again[0]) and
                                        torch.equal(got[1], again[1]))
            if tiled:
                other = kernel(with_tiles=False)
                c["bit_equal_node_warp_form"] = bool(torch.equal(got[0], other[0]) and
                                                     torch.equal(got[1], other[1]))
            c["ok"] = all(v for v in c.values() if isinstance(v, bool))
            ok &= c["ok"]
            res["checks"] = c

            # the library calls: (S - R)^T in CSR times the masked cotangent
            # (G alone, the mask made outside the timed call), and the two
            # calls that form both outputs
            gzm = gg * (y > 0)
            lib = {}
            try:
                SRt = SRt32.to(dtype)
                lib["sparse_mm_G_ms"] = time_ms(lambda: torch.sparse.mm(SRt, gzm), args.reps)

                def two_calls():
                    z = gg * (y > 0)
                    G = torch.sparse.mm(SRt, z)
                    return G, z if acc is None else z + acc

                lib["mask_then_sparse_mm_ms"] = time_ms(two_calls, args.reps)
            except RuntimeError as e:  # the card's PyTorch may refuse bf16
                lib["refused"] = f"torch.sparse.mm refused {dtype}: {e}".splitlines()[0]
                SRt = two_calls = None
            res["library"] = lib

            res["ms"] = time_ms(kernel, args.reps)
            if tiled:
                res["without_tiles_ms"] = time_ms(lambda: kernel(False), args.reps)
            res["plain_ms"] = time_ms(lambda: bwd_message_plain(gg, y, *graph, gz_acc=acc),
                                      args.reps)
            # the card's rate on a plain copy of g (one table read, one written)
            g_copy = torch.empty_like(gg)
            res["copy_ms"] = time_ms(lambda: g_copy.copy_(gg), args.reps)
            res["copy_tb_per_s"] = 2 * gg.numel() * gg.element_size() / res["copy_ms"] / 1e9
            res["bytes"] = bwd_message_bytes(bmg, d, gg.element_size(), with_acc)
            res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"],
                                                        (3 + int(with_acc)) * n_real * d)
            res["share_of_bound"] = res["bound_ms"] / res["ms"]
            res["host_us"] = host_us(kernel)
            if args.profile:
                fns = {"kernel": kernel, "copy": lambda: g_copy.copy_(gg)}
                if tiled:
                    fns["without_tiles"] = lambda: kernel(False)
                if SRt is not None:
                    fns["sparse_mm_G"] = lambda: torch.sparse.mm(SRt, gzm)
                    fns["mask_then_sparse_mm"] = two_calls
                res["kernels_us"] = profile(fns)
            print(json.dumps(res))
            record["cases"].append(res)
            del gg, y, acc, g_copy, gzm
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"torch_bwd_message{tag}.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"ok": ok, "tree": str(tree), "card": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
