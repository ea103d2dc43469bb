#!/usr/bin/env python3
"""What binds kernel F (``csrc/message_bwd_tiles.cu``, ``bwd_message`` over
the tile table) on one GPU: copies of the kernel with parts removed, timed
beside the kernel itself and its node-warp form on the benchmark batch.

    python3 experiments/torch_bwd_message_parts.py [--reps 21]

Each copy is the source with a few lines replaced (the edits are listed in
``PARTS``; a copy whose edit no longer matches the source fails the run), is
built with the package's own ``nvcc`` flags into ``chemprop_tpu_torch/_build/
parts/`` and is launched through the same C interface on the benchmark batch
(2048 molecules of tests/data/regression/mol/mol.csv, tiled, as
``chip_smoke.py`` builds it) at d = 384 in the three forms the training steps
call: float32, bfloat16, and bfloat16 with ``gz_acc``. The copies compute
wrong results; only their time is read: medians of ``--reps`` runs of 5 calls
between CUDA events, and the device microseconds of each from a trace after
them. Four are design alternatives, not parts: ``rows_not_boxes`` brings
each slice in by one bulk copy a row instead of TMA boxes of 32 rows,
``boxes_of_16`` and ``boxes_of_64`` in boxes of 16 or 64 rows, and
``slices_256B`` takes slices of 256 bytes a row (bf16 128 columns, f32 64)
and three stages, not 384 bytes and two.
``no_copies`` brings no rows of g, y or acc into shared memory, ``no_sums``
forms no G (every real row is written as NaN), ``no_gz`` writes no gz,
``no_G`` writes no G, and ``ring_only`` removes the copies, sums and
stores: what is left is the ring's hand-over between the producer and the
consumer warps, the ids, the mask in shared memory and the walk over the
tiles. Every line carries the card's name and power limit; the record goes
to chiprun_out/torch_bwd_message_parts.json."""

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
NO_COPIES = [
    ("    if (lane == 0) mbar_expect_tx(full, (uint32_t)(tables * real * RB));\n",
     "    if (lane == 0) mbar_expect_tx(full, 0u);\n"),
    ("  const int lane = threadIdx.x % 32;\n  if (WHOLE) {\n",
     "  const int lane = threadIdx.x % 32;\n  if (lane < 32) return;\n  if (WHOLE) {\n"),
]
ROWS = [("  if (N <= FT_BOX_MAX) {\n    boxed =", "  if (false) {\n    boxed =")]
BOXES_16 = [("constexpr int FT_BOX_ROWS = 32;", "constexpr int FT_BOX_ROWS = 16;")]
BOXES_64 = [("constexpr int FT_BOX_ROWS = 32;", "constexpr int FT_BOX_ROWS = 64;")]
SLICES_256B = [("  const int widths[4] = {768, 512, 384, 256};",
                "  const int widths[3] = {768, 512, 256};")]
NO_SUMS = [("      o[k] = task < real * CH ? transposed_chunk<T, CH>(sg, st.ids, i, ch) : zero4;",
            "      o[k] = task < real * CH && i + ch >= 0 ? nan_chunk<T>() : zero4;")]
NO_GZ = [("        if (gz_out != nullptr)\n          z4[at(task)] =",
          "        if (gz_out != nullptr && z.x == 0x12345u)\n          z4[at(task)] =")]
NO_G = [("      if (task < rows * CH) G4[at(task)] = o[k];",
         "      if (task < rows * CH && o[k].x == 0x12345u) G4[at(task)] = o[k];")]
PARTS = {
    "kernel": [],
    "rows_not_boxes": ROWS,
    "boxes_of_16": BOXES_16,
    "boxes_of_64": BOXES_64,
    "slices_256B": SLICES_256B,
    "no_copies": NO_COPIES,
    "no_sums": NO_SUMS,
    "no_gz": NO_GZ,
    "no_G": NO_G,
    "ring_only": NO_COPIES + NO_SUMS + NO_GZ + NO_G,
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=21)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))

    import torch

    if not torch.cuda.is_available():
        print("torch_bwd_message_parts: no CUDA device", file=sys.stderr)
        return 2
    from chemprop_tpu_torch.ops import build, bwd_message
    from chemprop_tpu_torch.ops.segment import DTYPES
    from chip_smoke import benchmark_batch, card_line, lipo_dataset, time_ms
    from experiments.torch_fused_iter import profile

    card = card_line()
    print(card)
    source = (build.CSRC / "message_bwd_tiles.cu").read_text()
    out_dir = build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)

    def make(name):
        text = source
        for old, new in PARTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: the edit no longer matches "
                                   f"csrc/message_bwd_tiles.cu: {old!r}")
            text = text.replace(old, new)
        cu = build.CSRC / f"_part_bwd_{name}.cu"  # beside the headers it includes
        cu.write_text(text)
        so = out_dir / f"message_bwd_{name}.so"
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
    tiles, n, d = bmg.tile_ptr, bmg.E.shape[0], 384
    record = {"card": card, "kind": torch.cuda.get_device_name(0), "ms": {}, "device_us": {}}
    for form, dtype, with_acc in (("bfloat16", torch.bfloat16, False),
                                  ("bfloat16_gz_acc", torch.bfloat16, True),
                                  ("float32", torch.float32, False)):
        gen = torch.Generator(device="cuda").manual_seed(d)
        g = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
        y = torch.randn((n, d), generator=gen, device="cuda").clamp_min(0).to(dtype)
        acc = torch.randn((n, d), generator=gen, device="cuda").to(dtype) if with_acc else None
        G, gz = torch.empty_like(g), torch.empty_like(g)
        fns = {"node_warp": lambda: bwd_message(g, y, *graph, gz_acc=acc)}
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in build.SIGNATURES["message_bwd_tiles"].items():
                getattr(lib, fn).argtypes = argtypes
            ptrs = [None if t is None else t.data_ptr()
                    for t in (g, y, acc, bmg.dst, bmg.rev, bmg.edge_ptr, tiles, G, gz)]

            def run(lib=lib, ptrs=ptrs, name=name):
                err = lib.bwd_message_tiles(*ptrs, n, d, bmg.edge_ptr.numel() - 2,
                                            tiles.numel() - 1, DTYPES[dtype],
                                            torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            fns[name] = run
        for name, fn in fns.items():
            ms = time_ms(fn, args.reps)
            record["ms"][f"{name}@{form}"] = ms
            print(json.dumps({"card": card, "part": name, "form": form, "ms": ms}), flush=True)
        # device time after every untimed run: a trace slows the launches after it
        for name, us in profile(fns).items():
            record["device_us"][f"{name}@{form}"] = us
            print(json.dumps({"card": card, "part": name, "form": form, "device_us": us}),
                  flush=True)
        del g, y, acc, G, gz
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_bwd_message_parts.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
