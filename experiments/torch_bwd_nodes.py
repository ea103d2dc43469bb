#!/usr/bin/env python3
"""Kernel G of the PyTorch/CUDA port (``bwd_message_nodes``: the last depth
iteration's backward from the M_v readout's node cotangent,
``gz = g_nodes[dst] [y > 0]`` and ``G = (S - R)^T gz``) on one GPU: its build,
what its machine code holds, its agreement with the plain version and its
time beside the unfused route of the same function.

    python3 experiments/torch_bwd_nodes.py [--reps 21] [--profile] [--tree DIR]

The graph is the benchmark batch (2048 molecules of
tests/data/regression/mol/mol.csv, tiled, as ``chip_smoke.py`` builds it:
[123,392 x d] edge tables, a [57,088 x d] node table and its tile table), at
d = 384 (the default model's hidden width 300, padded) and d = 128. At each
width the kernel with the batch's tile table and without one is held against
``bwd_message_nodes_plain`` under ``chip_smoke.py``'s limits (G within one
bf16 ulp, gz exactly); the two forms must agree bit for bit on every row, a
second call with the first, and padding rows must be zero. Timed (medians of
``--reps`` runs of 5 calls between CUDA events): the kernel with tiles and
without, the plain version, and the unfused route (``index_select`` of
``g_nodes`` at ``dst``, then ``bwd_message``) and a plain device copy of
``y`` (the rate a kernel moving these bytes can expect), beside the bound:
the larger of the bytes the function must move
(``chip_smoke.bwd_nodes_bytes``: y over the real rows, the g_nodes rows of
the nodes that own rows, G and gz over every row, the ids of the real rows)
over the memory rate and the adds over the f32 peak, both of an H100 SXM.
It prints the launch shape (slice width, slices, stages, shared memory,
grid, blocks per SM). ``--profile`` traces 10 calls of each and prints the
device microseconds of every kernel they launch, per call.

``--tree DIR`` imports ``chemprop_tpu_torch`` from another checkout (for
example a ``git archive`` of the parent commit, whose wrapper takes no tile
table: it then runs its one form), so that two versions of the kernel are
timed on the same card in one run; everything else comes from this
checkout. Every line carries the card's name and power limit. The record
goes to chiprun_out/torch_bwd_nodes[_<tree>][_profile].json."""

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


def bound_ms(nbytes: int, n_real: int, d: int) -> tuple[float, str]:
    """The bytes of ``chip_smoke.bwd_nodes_bytes`` over the memory rate, or
    per real row and element an add into the node's sum, a subtraction and
    a mask over the f32 peak, whichever takes longer."""
    tb, to = nbytes / MEM_RATE * 1e3, 3 * n_real * d / F32_PEAK * 1e3
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
    from chip_smoke import benchmark_batch, bwd_nodes_bytes, lipo_dataset, time_ms
    from experiments.torch_fused_iter import host_us, profile

    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_nodes: no CUDA device", file=sys.stderr)
        return 2
    import chemprop_tpu_torch
    from chemprop_tpu_torch.ops import build, bwd_message, bwd_message_nodes
    from chemprop_tpu_torch.ops.message import bwd_message_nodes_plain

    if Path(chemprop_tpu_torch.__file__).resolve().parent.parent != tree:
        print(f"torch_bwd_nodes: imported {chemprop_tpu_torch.__file__}, not {tree}",
              file=sys.stderr)
        return 2
    tag = ("" if args.tree is None else "_" + tree.name) + ("_profile" if args.profile else "")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    source = "bwd_nodes" if "bwd_nodes" in build.SOURCES else "message_bwd"
    log = build._finish(source, build._start(source))
    for line in log.splitlines():
        if any(k in line for k in ("Used", "spill", "error", "arn")):
            print(f"[{source}] {line.strip()}")
    tiled = "tiles" in inspect.signature(bwd_message_nodes).parameters
    record = {"card": card, "kind": torch.cuda.get_device_name(0), "tree": str(tree),
              "source": f"chemprop_tpu_torch/csrc/{source}.cu", "tile_form": tiled, "widths": []}
    record["sass"] = build.sass_contains(source, ("UBLKCP", "SYNCS"))
    print(json.dumps({"card": card, "sass": record["sass"]}))

    bmg = benchmark_batch(lipo_dataset(), "cuda").bmg
    graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
    n_e, n_v = bmg.E.shape[0], bmg.V.shape[0]
    n_real = int(bmg.edge_mask.sum())
    pad = ~bmg.edge_mask
    tiles = bmg.tile_ptr
    dst64 = bmg.dst.long()
    ok = tiles is not None
    for d in (384, 128):
        g = torch.Generator(device="cuda").manual_seed(args.seed + d)
        g_nodes = torch.randn((n_v, d), generator=g, device="cuda").to(torch.bfloat16)
        g_nodes[-1] = 0  # the sacrificial node's cotangent
        y = torch.randn((n_e, d), generator=g, device="cuda").clamp_min(0).to(torch.bfloat16)
        res = {"card": card, "d": d, "rows": n_e, "real_rows": n_real, "nodes": n_v,
               "tiles": tiles.numel() - 1}
        if tiled:
            from chemprop_tpu_torch.ops.message import bwd_message_nodes_info

            res["launch"] = bwd_message_nodes_info(d, tiles.numel() - 1)

        def kernel(with_tiles=True):
            kw = {"tiles": tiles} if tiled and with_tiles else {}
            return bwd_message_nodes(g_nodes, y, *graph, **kw)

        def unfused():
            return bwd_message(torch.index_select(g_nodes, 0, dst64), y, *graph)

        got = kernel()
        want_G, want_gz = bwd_message_nodes_plain(g_nodes, y, *graph)
        # chip_smoke.py's limits: G one ulp (f32 sums in another order than
        # the plain version's, rounded once), gz exactly (a masked copy)
        err = (got[0].float() - want_G.float()).abs()
        limit = 1e-6 + BF16_ULP * want_G.float().abs()
        c = {"G_max_abs_err": float(err.max()), "G_max_err_over_limit": float((err / limit).max()),
             "G_ok": bool((err <= limit).all()), "gz_equal": bool(torch.equal(got[1], want_gz)),
             "padding_rows_zero": not (got[0][pad].any() or got[1][pad].any())}
        again = kernel()
        c["bit_equal_rerun"] = bool(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
        if tiled:
            other = kernel(with_tiles=False)
            c["bit_equal_without_tiles"] = bool(torch.equal(got[0], other[0]) and
                                                torch.equal(got[1], other[1]))
        c["ok"] = all(v for v in c.values() if isinstance(v, bool))
        ok &= c["ok"]
        res["checks"] = c

        res["ms"] = time_ms(kernel, args.reps)
        if tiled:
            res["without_tiles_ms"] = time_ms(lambda: kernel(False), args.reps)
        res["unfused_ms"] = time_ms(unfused, args.reps)
        res["plain_ms"] = time_ms(lambda: bwd_message_nodes_plain(g_nodes, y, *graph), args.reps)
        # the card's rate on a plain copy of y (one table read, one written):
        # what a kernel that moves these bytes can expect to reach
        y_copy = torch.empty_like(y)
        res["copy_ms"] = time_ms(lambda: y_copy.copy_(y), args.reps)
        res["copy_tb_per_s"] = 2 * y.numel() * 2 / res["copy_ms"] / 1e9
        res["bytes"] = bwd_nodes_bytes(bmg, d)
        res["bound_ms"], res["bound_by"] = bound_ms(res["bytes"], n_real, d)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
        res["host_us"] = host_us(kernel)
        if args.profile:
            fns = {"kernel": kernel, "unfused": unfused, "copy": lambda: y_copy.copy_(y)}
            if tiled:
                fns["without_tiles"] = lambda: kernel(False)
            res["kernels_us"] = profile(fns)
        print(json.dumps(res))
        record["widths"].append(res)
        del g_nodes, y, y_copy
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"torch_bwd_nodes{tag}.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"ok": ok, "tree": str(tree), "card": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
