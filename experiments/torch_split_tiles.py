#!/usr/bin/env python3
"""Kernels G and H of the PyTorch/CUDA port over a split tile table on one
GPU, beside their forms without a table, and one bf16 training step with
each.

    python3 experiments/torch_split_tiles.py [--reps 21] [--copies 1,4]

The batch is Tox21 (tests/data/classification/mol.csv: 500 molecules, 8 of
them of more than 128 directed edges) collated once (``--copies 1``) or
several times over (``4``: 2000 molecules). It has no tile table: its split
table (``BatchMolGraph.split_ptr``) cuts those molecules at their nodes'
boundaries, and ``cross_rows`` lists the rows whose sum reads another tile.
At d = 384 (the default model's hidden width 300, padded) in bf16, G
(``bwd_message_nodes``) and H (``bwd_message_premul``, with and without
``fold_h0``) over the split table are checked bit-equal to their forms
without a table (the node-warp pass of message_bwd.cu; H's product over
fixed tiles then that pass) and timed beside them: medians of ``--reps``
runs of 5 calls between CUDA events, and device microseconds per call of
every kernel each launches, from a ``torch.profiler`` trace of 10 calls. The
cross-rows pass (``ops.message._cross_rows``) is timed alone. Then one bf16
training step of the BCE model at full width (``chip_smoke.head_model``:
hidden width 300, depth 3, batch norm, 4 tasks) on the batch, with the split
table and with it taken away: wall milliseconds (events) and device
milliseconds (trace). Every line carries the card's name and power limit;
the record goes to chiprun_out/torch_split_tiles.json."""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
D = 384


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--copies", default="1,4")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("torch_split_tiles: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import head_dataset, head_model, read_targets, time_ms
    from experiments.torch_fused_iter import profile

    from chemprop_tpu_torch.data import collate_batch
    from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED, bwd_message_nodes, bwd_message_premul
    from chemprop_tpu_torch.ops.message import _cross_rows
    from chemprop_tpu_torch.train import Trainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    ds = head_dataset(read_targets(REPO / "tests/data/classification/mol.csv"))[0]
    data = [ds[i] for i in range(len(ds))]
    record = {"card": card, "d": D, "batches": []}
    for copies in map(int, args.copies.split(",")):
        host = collate_batch(data * copies)
        batch = host.to("cuda")
        b = batch.bmg
        if b.tile_ptr is not None or b.split_ptr is None:
            print("torch_split_tiles: the batch should have a split table only", file=sys.stderr)
            return 1
        graph = (b.src, b.dst, b.rev, b.edge_ptr)
        n_e, n_v = b.E.shape[0], b.V.shape[0]
        g = torch.Generator(device="cuda").manual_seed(copies)
        y = torch.randn((n_e, D), generator=g, device="cuda").clamp_min(0).to(torch.bfloat16)
        g_in = torch.randn((n_e, D), generator=g, device="cuda").to(torch.bfloat16)
        H0 = torch.randn((n_e, D), generator=g, device="cuda").to(torch.bfloat16)
        W = (torch.randn((D, D), generator=g, device="cuda") * D**-0.5).to(torch.bfloat16)
        g_nodes = torch.randn((n_v, D), generator=g, device="cuda").to(torch.bfloat16)
        g_nodes[-1] = 0
        split = {"tiles": b.split_ptr, "cross": b.cross_rows}
        fns = {
            "G split": lambda: bwd_message_nodes(g_nodes, y, *graph, **split),
            "G without a table": lambda: bwd_message_nodes(g_nodes, y, *graph),
            "H fold_h0 split": lambda: bwd_message_premul(g_in, y, H0, W, *graph, fold_h0=True,
                                                          **split),
            "H fold_h0 without a table": lambda: bwd_message_premul(g_in, y, H0, W, *graph,
                                                                    fold_h0=True),
            "H split": lambda: bwd_message_premul(g_in, y, None, W, *graph, **split),
            "H without a table": lambda: bwd_message_premul(g_in, y, None, W, *graph),
        }
        for a in ("G", "H fold_h0", "H"):
            got, want = fns[f"{a} split"](), fns[f"{a} without a table"]()
            if not all(torch.equal(x, w) for x, w in zip(got, want)):
                print(f"torch_split_tiles: {a} over the split table differs", file=sys.stderr)
                return 1
        gz, G = fns["G split"]()[1], torch.empty_like(y)
        fns["cross rows alone"] = lambda: _cross_rows(gz, b.dst, b.rev, b.edge_ptr, b.cross_rows, G)
        res = {"card": card, "copies": copies, "molecules": len(data) * copies, "rows": n_e,
               "real_rows": int(b.edge_mask.sum()), "tiles": b.split_ptr.numel() - 1,
               "cross_rows": b.cross_rows.numel(),
               "ms": {k: time_ms(f, args.reps) for k, f in fns.items()},
               "device_us": profile(fns)}

        # one bf16 training step of the BCE model, with the split table and without
        unsplit = batch._replace(bmg=dataclasses.replace(b, split_ptr=None, cross_rows=None))
        trainer = Trainer(head_model(torch.bfloat16, "BinaryClassificationFFN", n_tasks=4),
                          max_epochs=20, warmup_epochs=2, seed=12)
        trainer.init_state(batch, 8)
        steps = {"step split": lambda: trainer.train_step(batch),
                 "step without a table": lambda: trainer.train_step(unsplit)}
        UNSERVED.clear()
        LAUNCHES.clear()
        steps["step split"]()
        res["step_split_unserved"] = dict(UNSERVED)
        res["step_split_launches"] = dict(LAUNCHES)
        res["step_ms"] = {k: time_ms(f, args.reps, inner=2) for k, f in steps.items()}
        traces = profile(steps, calls=5)
        res["step_device_ms"] = {k: sum(v.values()) / 1e3 for k, v in traces.items()}
        record["batches"].append(res)
        print(json.dumps(res), flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_split_tiles.json").write_text(json.dumps(record, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
