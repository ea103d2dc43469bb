#!/usr/bin/env python3
"""What binds kernel E (``csrc/iter_bwd.cu``, ``iter_bwd`` over the tile
table) on one GPU: copies of the kernel with one part removed, timed beside
the kernel itself on the benchmark batch.

    python3 experiments/torch_iter_bwd_parts.py [--reps 11]

Each copy is the source with a few lines replaced (the edits are listed in
``PARTS``; a copy whose edit no longer matches the source fails the run), is
built with the package's own ``nvcc`` flags into ``chemprop_tpu_torch/_build/
parts/`` and is launched through the same C interface on the benchmark batch
(2048 molecules of tests/data/regression/mol/mol.csv, tiled, as
``chip_smoke.py`` builds it) at d = 384 and d = 128. The copies compute wrong
results; only their time is read: medians of ``--reps`` runs of 5 calls
between CUDA events. ``hand_over_only`` keeps nothing but the barriers that
hand the stages and the half buffers from role to role and from CTA to CTA;
``one_thread_arrivals`` has one thread arrive on the cluster's barriers CTA
after CTA, in place of one lane per CTA side by side.
Every line carries the card's name and power limit; the record goes to
chiprun_out/torch_iter_bwd_parts.json."""

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
NO_PUSHES = [
    ("bulk_copy_cluster(cluster_map(dst, q), dst, bytes, cluster_map(full, q));", ""),
    ("mbar_arrive_expect_tx(full, (NB - 1) * bytes);", "mbar_arrive(full);"),
]
NO_G_BOX = [("for (int task = t; task < (k1 - k0) * 8; task += IB_G_THREADS) {",
             "for (int task = t; task < 0; task += IB_G_THREADS) {")]
NO_PRODUCTS = [
    ("for (int kb = 0; kb < NB; ++kb)\n#pragma unroll\n          for (int kk = 0; kk < 4; ++kk)",
     "for (int kb = 0; kb < 0; ++kb)\n#pragma unroll\n          for (int kk = 0; kk < 4; ++kk)"),
    ("for (int kk = 0; kk < kc; ++kk) {", "for (int kk = 0; kk < 0; ++kk) {"),
]
NO_MASK = [("      if (i >= x.rows) continue;\n      uint4 z = zero4;",
            "      continue;\n      uint4 z = zero4;")]
NO_DH_STORES = [("    if (i < y.rows)\n      *reinterpret_cast<uint4*>(dH",
                 "    if (0)\n      *reinterpret_cast<uint4*>(dH")]
NO_IDS = [
    ("    v[q] = i < real ? __ldg(dst + r0 + i) : -1;\n"
     "    rv[q] = i < real ? __ldg(rev + r0 + i) - r0 : 0;",
     "    v[q] = i < real ? i : -1;\n    rv[q] = i < real ? i : 0;"),
    ("  const int before = r0 > 0 ? __ldg(dst + r0 - 1) : -1;\n"
     "  const int after = r0 + real < n_edges ? __ldg(dst + r0 + real) : -1;",
     "  const int before = -1;\n  const int after = -1;"),
]
NO_TMA = [
    ("        mbar_arrive_expect_tx(bar(sm, B_HFULL + k), IB_HBOX);\n"
     "        tma_load_2d(sm.h + k * IB_HBOX, th, bar(sm, B_HFULL + k), c0, x.r0 + IB_HALF * h);",
     "        mbar_arrive(bar(sm, B_HFULL + k));"),
    ("      mbar_arrive_expect_tx(bar(sm, B_ZFULL + s), IB_BOX);\n"
     "      tma_load_2d(sm.z[s], tg, bar(sm, B_ZFULL + s), c0, x.r0);",
     "      mbar_arrive(bar(sm, B_ZFULL + s));"),
    ("      mbar_arrive_expect_tx(bar(sm, B_YFULL), IB_BOX);\n"
     "      tma_load_2d(sm.y, ty, bar(sm, B_YFULL), c0, x.r0);",
     "      mbar_arrive(bar(sm, B_YFULL));"),
]
# the barriers' arrivals from one thread, CTA after CTA, in place of one lane
# per CTA side by side
ONE_THREAD_ARRIVALS = [
    ("      if (threadIdx.x < NB) mbar_arrive_cluster(cluster_map(bar(sm, B_GFREE + b), threadIdx.x));",
     "      if (threadIdx.x == 0)\n"
     "        for (int p = 0; p < NB; ++p) mbar_arrive_cluster(cluster_map(bar(sm, B_GFREE + b), p));"),
]
PARTS = {
    "kernel": [],
    "one_thread_arrivals": ONE_THREAD_ARRIVALS,
    "no_pushes": NO_PUSHES,
    "no_G_box": NO_G_BOX,
    "no_products": NO_PRODUCTS,
    "no_mask": NO_MASK,
    "no_dH_stores": NO_DH_STORES,
    "no_loads": NO_IDS + NO_TMA,
    "hand_over_only": (NO_IDS + NO_TMA + NO_G_BOX + NO_PUSHES + NO_PRODUCTS + NO_MASK
                       + NO_DH_STORES),
    "hand_over_only_one_thread_arrivals": (NO_IDS + NO_TMA + NO_G_BOX + NO_PUSHES + NO_PRODUCTS
                                           + NO_MASK + NO_DH_STORES + ONE_THREAD_ARRIVALS),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=11)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))

    import torch

    if not torch.cuda.is_available():
        print("torch_iter_bwd_parts: no CUDA device", file=sys.stderr)
        return 2
    from chemprop_tpu_torch.ops import build
    from chip_smoke import benchmark_batch, card_line, lipo_dataset, time_ms

    card = card_line()
    print(card)
    source = (build.CSRC / "iter_bwd.cu").read_text()
    out_dir = build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)

    def make(name):
        text = source
        for old, new in PARTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: the edit no longer matches csrc/iter_bwd.cu: {old!r}")
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
    tiles, n = bmg.tile_ptr, bmg.E.shape[0]
    record = {"card": card, "kind": torch.cuda.get_device_name(0), "ms": {}}
    for d in (384, 128):
        gen = torch.Generator(device="cuda").manual_seed(d)
        g = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
        y = torch.randn((n, d), generator=gen, device="cuda").clamp_min(0).to(torch.bfloat16)
        H = torch.randn((n, d), generator=gen, device="cuda").clamp_min(0).to(torch.bfloat16)
        W = (torch.randn((d, d), generator=gen, device="cuda") * d**-0.5).to(torch.bfloat16)
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in build.SIGNATURES["iter_bwd"].items():
                getattr(lib, fn).argtypes = argtypes
            clusters = lib.iter_bwd_clusters(d, tiles.numel() - 1)
            dH, gz = torch.empty_like(g), torch.empty_like(g)
            dW = torch.empty((d, d), dtype=torch.float32, device="cuda")
            partial = torch.empty((clusters, d, d), dtype=torch.float32, device="cuda")
            ptrs = [t.data_ptr() for t in (g, y, H, W, bmg.dst, bmg.rev, bmg.edge_ptr, tiles)]
            ptrs += [None, None, None]  # a tile table: no cross rows
            ptrs += [t.data_ptr() for t in (dH, gz, partial, dW)]

            def run():
                err = lib.iter_bwd_tiles(*ptrs, n, d, bmg.edge_ptr.numel() - 2,
                                         tiles.numel() - 1, clusters, 0,
                                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            ms = time_ms(run, args.reps)
            record["ms"][f"{name}@{d}"] = ms
            print(json.dumps({"card": card, "part": name, "d": d, "ms": ms}), flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_iter_bwd_parts.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
