#!/usr/bin/env python3
"""What binds kernel D (``csrc/iter2.cu``, ``fused_iter2`` over the tile
table) on one GPU: copies of the kernel with parts removed, timed beside the
kernel itself and two ``fused_iter`` launches on the benchmark batch.

    python3 experiments/torch_iter2_parts.py [--reps 11]

Each copy is the source with a few lines replaced (the edits are listed in
``PARTS``; a copy whose edit no longer matches the source fails the run), is
built with the package's own ``nvcc`` flags into ``chemprop_tpu_torch/_build/
parts/`` and is launched through the same C interface on the benchmark batch
(2048 molecules of tests/data/regression/mol/mol.csv, tiled, as
``chip_smoke.py`` builds it) at d = 384 and d = 128. The copies compute wrong
results; only their time is read: medians of ``--reps`` runs of 5 calls
between CUDA events. ``no_formation`` forms no message rows (every stage is
written, from zero sums), ``no_staging`` copies no rows of H0 or y1 into
shared memory, ``no_epilogue`` neither adds H0 nor writes y, and ``hand_over_only``
removes all three: what is left is the ring's hand-over between the gather
warps, the consumer warpgroups and the CTAs of a cluster (the pushes
included), the products, H0's TMA and the walk. Every line carries the
card's name and power limit; the record goes to
chiprun_out/torch_iter2_parts.json."""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# each part: (text in the source, its replacement)
NO_FORMATION = [("      for (int k = 0; k < most; ++k) {\n        uint4 v[I2_ROWS];",
                 "      for (int k = 0; k < 0; ++k) {\n        uint4 v[I2_ROWS];")]
NO_STAGING = [("      if (r.r0 + row < r.r1)\n        cp_async16(",
               "      if (r.r0 + row < r.r1 && row < 0)\n        cp_async16(")]
NO_EPILOGUE = [
    ("    epilogue<I2_N>(acc, b, h0_ptr, n0, t);",
     "    if (acc[0] == 12345.f) epilogue<I2_N>(acc, b, h0_ptr, n0, t);"),
    ("    store_tile<I2_N>(x.it == 1 ? y1 : y2, h0_ptr, rows.r0 + wg * FI_ROWS, rows.r1, d, n0,"
     " t);",
     "    if (acc[1] == 12345.f)\n      store_tile<I2_N>(x.it == 1 ? y1 : y2, h0_ptr, rows.r0 +"
     " wg * FI_ROWS, rows.r1, d, n0, t);"),
]
PARTS = {
    "kernel": [],
    "no_formation": NO_FORMATION,
    "no_staging": NO_STAGING,
    "no_epilogue": NO_EPILOGUE,
    "no_formation_no_staging": NO_FORMATION + NO_STAGING,
    "hand_over_only": NO_FORMATION + NO_STAGING + NO_EPILOGUE,
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=11)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))

    import torch

    if not torch.cuda.is_available():
        print("torch_iter2_parts: no CUDA device", file=sys.stderr)
        return 2
    from chemprop_tpu_torch.ops import build, fused_iter
    from chip_smoke import benchmark_batch, card_line, lipo_dataset, time_ms

    card = card_line()
    print(card)
    source = (build.CSRC / "iter2.cu").read_text()
    out_dir = build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)

    def make(name):
        text = source
        for old, new in PARTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: the edit no longer matches csrc/iter2.cu: {old!r}")
            text = text.replace(old, new)
        cu = build.CSRC / f"_part_{name}.cu"  # beside the headers it includes
        cu.write_text(text)
        so = out_dir / f"{name}.so"
        try:
            subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                           check=True, capture_output=True, text=True)
        finally:
            cu.unlink()
        return name, so

    with concurrent.futures.ThreadPoolExecutor(len(PARTS)) as pool:
        libs = dict(pool.map(make, PARTS))

    bmg = benchmark_batch(lipo_dataset(), "cuda").bmg
    graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
    tiles, n = bmg.tile_ptr, bmg.E.shape[0]
    record = {"card": card, "kind": torch.cuda.get_device_name(0), "ms": {}}
    for d in (384, 128):
        gen = torch.Generator(device="cuda").manual_seed(d)
        H0 = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
        W = (torch.randn((d, d), generator=gen, device="cuda") * d**-0.5).to(torch.bfloat16)
        y1, y2 = torch.empty_like(H0), torch.empty_like(H0)

        def two_launches():
            return fused_iter(fused_iter(H0, H0, W, None, *graph, relu_stream=True), H0, W, None,
                              *graph)

        ms = time_ms(two_launches, args.reps)
        record["ms"][f"two_fused_iter@{d}"] = ms
        print(json.dumps({"card": card, "part": "two_fused_iter", "d": d, "ms": ms}), flush=True)
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in build.SIGNATURES["iter2"].items():
                getattr(lib, fn).argtypes = argtypes
            ptrs = [t.data_ptr() for t in (H0, W)] + [None] + [
                t.data_ptr() for t in (bmg.src, bmg.rev, bmg.edge_ptr, tiles, y1, y2)]

            def run():
                err = lib.iter2(*ptrs, n, tiles.numel() - 1, d, bmg.edge_ptr.numel() - 2,
                                torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            ms = time_ms(run, args.reps)
            record["ms"][f"{name}@{d}"] = ms
            print(json.dumps({"card": card, "part": name, "d": d, "ms": ms}), flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_iter2_parts.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
