#!/usr/bin/env python3
"""Kernel C of the PyTorch/CUDA port (``sorted_segment_sum``: the sum of each
segment of rows sorted by segment id, in f32, cast once; with counts for the
mean readout) on one GPU: its build, what its machine code holds, its
agreement with the plain version and its time beside ``index_add_``.

    python3 experiments/torch_segment.py [--reps 21] [--profile] [--tree DIR]

The inputs are the readouts of the benchmark batch (2048 molecules of
tests/data/regression/mol/mol.csv, tiled, as ``chip_smoke.py`` builds it):
the M_v readout, edges to nodes ([123,392 x d] -> [57,088 x d], bf16 -> bf16
as in the bf16 model, f32 -> f32 as in the f32 one), and the mean readout,
nodes to graphs with counts ([57,088 x d] -> [2,049 x d], bf16 -> f32 and
f32 -> f32), at d = 384 (the default model's hidden width 300, padded) and
d = 128. Each is held against ``sorted_segment_sum_plain`` under
``chip_smoke.py``'s limits (f32 out: 1e-5 of the segment's sum of |x|; bf16
out: one ulp), and a second call must give the same bits. Timed (medians of
``--reps`` runs of 5 calls between CUDA events): the kernel, the plain
version and ``index_add_`` into a zeroed table of the input's dtype (the
one PyTorch call for the sum; its order varies from run to run), beside the
bound: the bytes (rows read, outputs and counts written, ids and ptr read)
over the memory rate of an H100 SXM. ``--profile`` traces 10 calls of each and prints the device
microseconds of every kernel they launch, per call.

``--tree DIR`` imports ``chemprop_tpu_torch`` from another checkout (for
example a ``git archive`` of the parent commit), so that two versions of the
kernel are timed on the same card in one run; everything else comes from
this checkout. Every line carries the card's name and power limit. The record
goes to chiprun_out/torch_segment[_<tree>][_profile].json."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
MEM_RATE = 3.35e12  # H100 SXM, NVIDIA's data sheet
BF16_ULP = 2.0**-7


def bound_ms(n: int, n_seg: int, d: int, in_bytes: int, out_bytes: int, counts: bool) -> float:
    """Rows read once, outputs (and counts) written once, ids and ptr read."""
    nbytes = n * d * in_bytes + n_seg * d * out_bytes + 4 * (n + n_seg + 1) + 4 * n_seg * counts
    return nbytes / MEM_RATE * 1e3


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
        print("torch_segment: no CUDA device", file=sys.stderr)
        return 2
    import chemprop_tpu_torch
    from chemprop_tpu_torch.ops import build, sorted_segment_sum, sorted_segment_sum_counts
    from chemprop_tpu_torch.ops import segment

    if Path(chemprop_tpu_torch.__file__).resolve().parent.parent != tree:
        print(f"torch_segment: imported {chemprop_tpu_torch.__file__}, not {tree}",
              file=sys.stderr)
        return 2
    tag = ("" if args.tree is None else "_" + tree.name) + ("_profile" if args.profile else "")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    log = build._finish("segment", build._start("segment"))
    for line in log.splitlines():
        if any(k in line for k in ("Used", "spill", "error", "arn")):
            print(f"[segment] {line.strip()}")
    record = {"card": card, "kind": torch.cuda.get_device_name(0), "tree": str(tree),
              "source": "chemprop_tpu_torch/csrc/segment.cu", "cases": []}
    record["sass"] = build.sass_contains("segment", ("UBLKCP", "SYNCS"))
    print(json.dumps({"card": card, "sass": record["sass"]}))

    bmg = benchmark_batch(lipo_dataset(), "cuda").bmg
    readouts = {"edge->node": (bmg.dst, bmg.edge_ptr, False),
                "node->graph": (bmg.batch, bmg.node_ptr, True)}
    dtypes = {"edge->node": ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)),
              "node->graph": ((torch.bfloat16, torch.float32), (torch.float32, torch.float32))}
    ok = True
    for d in (384, 128):
        for name, (ids, ptr, with_counts) in readouts.items():
            n, n_seg = ids.shape[0], ptr.numel() - 1
            g = torch.Generator(device="cuda").manual_seed(args.seed + d)
            x32 = torch.randn((n, d), generator=g, device="cuda")
            ids64 = ids.long()
            for in_dt, out_dt in dtypes[name]:
                x = x32.to(in_dt)
                res = {"card": card, "readout": name, "d": d, "rows": n, "segments": n_seg,
                       "dtype": f"{in_dt}->{out_dt}", "counts": with_counts}
                if hasattr(segment, "sorted_segment_sum_info"):
                    res["launch"] = segment.sorted_segment_sum_info(n, n_seg, d, in_dt, out_dt)

                def kernel():
                    if with_counts:
                        return sorted_segment_sum_counts(x, ids, ptr, out_dt)
                    return sorted_segment_sum(x, ids, ptr, out_dt), None

                got, counts = kernel()
                want, want_counts = segment.sorted_segment_sum_plain(x, ids, ptr, out_dt,
                                                                     with_counts)
                err = (got.float() - want.float()).abs()
                if out_dt == torch.bfloat16:
                    limit = 1e-4 + BF16_ULP * want.float().abs()
                else:
                    scale = segment.sorted_segment_sum_plain(x.abs(), ids, ptr, torch.float32)[0]
                    limit = 1e-6 + 1e-5 * scale
                again = kernel()
                res["max_abs_err"] = float(err.max())
                res["max_err_over_limit"] = float((err / limit).max())
                res["within_limit"] = bool((err <= limit).all())
                res["counts_equal"] = (not with_counts) or bool(torch.equal(counts, want_counts))
                res["bit_equal_rerun"] = bool(torch.equal(got, again[0]))
                ok &= res["within_limit"] and res["counts_equal"] and res["bit_equal_rerun"]

                acc = torch.zeros((n_seg, d), dtype=in_dt, device="cuda")
                res["ms"] = time_ms(kernel, args.reps)
                res["plain_ms"] = time_ms(
                    lambda: segment.sorted_segment_sum_plain(x, ids, ptr, out_dt, with_counts),
                    args.reps)
                res["library_ms"] = time_ms(lambda: acc.index_add_(0, ids64, x), args.reps)
                res["bound_ms"] = bound_ms(n, n_seg, d, x.element_size(),
                                           got.element_size(), with_counts)
                res["share_of_bound"] = res["bound_ms"] / res["ms"]
                res["host_us"] = host_us(kernel)
                if args.profile:
                    res["kernels_us"] = profile(
                        {"kernel": kernel, "index_add_": lambda: acc.index_add_(0, ids64, x)})
                print(json.dumps(res))
                record["cases"].append(res)
            del x32
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"torch_segment{tag}.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"ok": ok, "tree": str(tree), "card": card}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
