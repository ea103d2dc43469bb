#!/usr/bin/env python3
"""What binds kernel A (``csrc/message_tiles.cu``, ``message`` over the tile
table) on one GPU: copies of the kernel with parts removed, timed beside the
kernel itself and message.cu's form on the benchmark batch, in bfloat16.

    python3 experiments/torch_message_parts.py [--reps 21]

Each copy is the source with a few lines replaced (the edits are listed in
``PARTS``; a copy whose edit no longer matches the source fails the run), is
built with the package's own ``nvcc`` flags into ``chemprop_tpu_torch/_build/
parts/`` and is launched through the same C interface on the benchmark batch
(2048 molecules of tests/data/regression/mol/mol.csv, tiled, as
``chip_smoke.py`` builds it) at d = 384 and d = 128. The copies compute wrong
results; only their time is read: medians of ``--reps`` runs of 5 calls
between CUDA events, and the device microseconds of each from a trace
after them. ``no_copies`` brings no H rows into shared memory, ``no_ids``
reads no src, rev or ptr (every row sums its own stage row), ``no_gather``
reads no stage row (every real row is written as NaN), ``no_stores`` writes
no output, and ``ring_only`` removes all four: what is left is the ring's
hand-over between the producer and the consumer warps and the walk over the
tiles. ``slices_192`` is a design alternative, not a part: bf16 rows taken
in two 192-column slices (one copy a row, four stages) instead of one copy
of each whole tile (two stages). Every line carries the card's name and
power limit; the record goes to chiprun_out/torch_message_parts.json."""

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
    ("    const uint32_t bytes = (uint32_t)real * RB;\n",
     "    const uint32_t bytes = 0;\n"),
    ("      for (int i = lane; i < real; i += 32)\n        bulk_load(",
     "      for (int i = lane; i < real && bytes > 0; i += 32)\n        bulk_load("),
]
NO_IDS = [
    ("      sv[q] = i < real ? __ldg(src + r0 + i) : 0;\n"
     "      rv[q] = i < real ? __ldg(rev + r0 + i) - r0 : 0;\n",
     "      sv[q] = 0;\n      rv[q] = i;\n"),
    ("      lo[q] = i < real ? __ldg(ptr + sv[q]) - r0 : 0;\n"
     "      hi[q] = i < real ? __ldg(ptr + sv[q] + 1) - r0 : 0;\n",
     "      lo[q] = i + sv[q];\n      hi[q] = i + 1;\n"),
]
NO_GATHER = [("        if (id & MT_BAD) {\n", "        if (true) {\n")]
NO_STORES = [("      if (i < rows) *(reinterpret_cast<uint4*>(M",
              "      if (i < rows && out[k].x == 0x12345u) *(reinterpret_cast<uint4*>(M")]
SLICES_192 = [
    ("  const int widths[3] = {768, 512, 256};", "  const int widths[4] = {384, 768, 512, 256};"),
    ("      case 768: return mt_launch<bf16, 384>(",
     "      case 384: return mt_launch<bf16, 192>(H, src, rev, ptr, tiles, M, d, pad_node,"
     " n_tiles, stream, blocks_per_sm);\n      case 768: return mt_launch<bf16, 384>("),
]
PARTS = {
    "kernel": [],
    "no_copies": NO_COPIES,
    "no_ids": NO_IDS,
    "no_gather": NO_GATHER,
    "no_stores": NO_STORES,
    "ring_only": NO_COPIES + NO_IDS + NO_GATHER + NO_STORES,
    "slices_192": SLICES_192,
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=21)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))

    import torch

    if not torch.cuda.is_available():
        print("torch_message_parts: no CUDA device", file=sys.stderr)
        return 2
    from chemprop_tpu_torch.ops import build, message
    from chemprop_tpu_torch.ops.segment import DTYPES
    from chip_smoke import benchmark_batch, card_line, lipo_dataset, time_ms
    from experiments.torch_fused_iter import profile

    card = card_line()
    print(card)
    source = (build.CSRC / "message_tiles.cu").read_text()
    out_dir = build.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)

    def make(name):
        text = source
        for old, new in PARTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: the edit no longer matches csrc/message_tiles.cu: "
                                   f"{old!r}")
            text = text.replace(old, new)
        cu = build.CSRC / f"_part_msg_{name}.cu"  # beside the headers it includes
        cu.write_text(text)
        so = out_dir / f"message_{name}.so"
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
    record = {"card": card, "kind": torch.cuda.get_device_name(0), "ms": {}, "device_us": {}}
    for d in (384, 128):
        gen = torch.Generator(device="cuda").manual_seed(d)
        H = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
        M = torch.empty_like(H)
        fns = {"message_cu": lambda: message(H, *graph)}
        for name, so in libs.items():
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in build.SIGNATURES["message_tiles"].items():
                getattr(lib, fn).argtypes = argtypes
            ptrs = [t.data_ptr() for t in (H, bmg.src, bmg.rev, bmg.edge_ptr, tiles, M)]

            def run(lib=lib, ptrs=ptrs, name=name):
                err = lib.message_tiles(*ptrs, n, d, bmg.edge_ptr.numel() - 2,
                                        tiles.numel() - 1, DTYPES[torch.bfloat16],
                                        torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            fns[name] = run
        for name, fn in fns.items():
            ms = time_ms(fn, args.reps)
            record["ms"][f"{name}@{d}"] = ms
            print(json.dumps({"card": card, "part": name, "d": d, "ms": ms}), flush=True)
        # device time after every untimed run: a trace slows the launches after it
        for name, us in profile(fns).items():
            record["device_us"][f"{name}@{d}"] = us
            print(json.dumps({"card": card, "part": name, "d": d, "device_us": us}), flush=True)
        del H, M
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_message_parts.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
