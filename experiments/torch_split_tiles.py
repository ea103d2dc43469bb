#!/usr/bin/env python3
"""Kernels A, F, G, H, D and E of the PyTorch/CUDA port over a split tile
table on one GPU, beside their forms without a table, the passes alone, and
five training steps with the split table and without it.

    python3 experiments/torch_split_tiles.py [--reps 21] [--copies 1,4]
                                             [--tree DIR] [--steps-only]
                                             [--e-only [--tag T]]

The batch is Tox21 (tests/data/classification/mol.csv: 500 molecules, 8 of
them of more than 128 directed edges) collated once (``--copies 1``) or
several times over (``4``: 2000 molecules). It has no tile table: its split
table (``BatchMolGraph.split_ptr``) cuts those molecules at their nodes'
boundaries, ``cross_rows`` lists the rows whose sum reads another tile, and
``y1_rows`` / ``y2_rows`` the rows the chained iterations cannot form in
their tile. At d = 384 (the default model's hidden width 300, padded):

* A (``message``) in f32 and bf16, F (``bwd_message``) in f32 and bf16 with
  the mask, with and without ``gz_acc``, G (``bwd_message_nodes``) and H
  (``bwd_message_premul``, with and without ``fold_h0``) in bf16 over the
  split table, each checked bit-equal to its form without a table
  (``message.cu``, the node-warp pass of ``message_bwd.cu``; H's product
  over fixed tiles then that pass) and timed beside it;
* D (``fused_iter2``) over the split table with its row passes, checked
  bit-equal to two B launches (its form without a table) and timed beside
  them; E (``iter_bwd``) over the split table with the launch that forms
  its cross rows' G first, its gz checked
  bit-equal to its form without a table (``message_bwd.cu``'s three
  launches) and timed beside it;
* the passes alone: A's (``message_rows``) in f32 and bf16, F's
  (``bwd_message_rows`` from g and y) in f32 and bf16, G's and H's (the
  same kernel from the gz table, no mask) in bf16, D's (``fused_iter_rows``
  over y1_rows, then y2_rows) and E's launch before its tile launch
  (``iter_bwd_rows``: the cross rows' G) in bf16;
* one f32 training step and one bf16 step with dropout 0.1 of the default
  model at full width with a BCE head (``chip_smoke.head_model``: depth 3,
  batch norm, 4 tasks), one bf16 step without dropout, one with ``iter2``
  (D in the forward) and one with dropout 0.1 and ``fused_bwd`` (E in the
  backward), each with the split table and with it taken away.

Times are medians of ``--reps`` runs of 5 calls (2 for a step) between CUDA
events, and device microseconds per call of every kernel each call
launches, from ``torch.profiler`` traces of 10 calls (5 for a step) that
held every call (``chip_smoke.kernel_trace``). ``--tree DIR`` imports the
package from another checkout, e.g. the parent commit unpacked under
``_chip_checkout/``, so that both are timed in one call (``chip_smoke``'s
helpers and the profiler stay this checkout's); ``--steps-only`` times the steps alone (a tree
whose kernels take no split table). ``--e-only`` times kernel E alone, in
any tree that has E over the split table: E over the split table (each of
its launches in the trace) and without a table, ``torch.mm`` of ``G_c W^T``
and of ``H[rows]^T G_c`` at the cross rows (yardsticks), the bf16 steps with ``iter2`` and with dropout and
``fused_bwd``, and E over the split table and without a table on each
batch of 50 molecules of Tox21 that has a split table (its record's name
has ``_e`` in place of ``_steps``, and ``--tag T`` adds ``_T``). Every line
carries the card's name and power limit; the record goes to
chiprun_out/torch_split_tiles[_steps][_<tree>].json."""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
D = 384


def kernel_times(b, copies: int, reps: int) -> dict:
    """A, F, G and H over the split table and without a table, checked
    bit-equal, and the second passes alone: event and device times."""
    import torch
    from chip_smoke import time_ms
    from experiments.torch_fused_iter import profile

    from chemprop_tpu_torch.ops import (
        bwd_message, bwd_message_nodes, bwd_message_premul, fused_iter, fused_iter2, iter_bwd,
        message,
    )
    from chemprop_tpu_torch.ops.message import (
        _cross_rows, _fused_iter_rows, _iter_bwd_rows, _message_rows,
    )

    graph = (b.src, b.dst, b.rev, b.edge_ptr)
    n_e, n_v = b.E.shape[0], b.V.shape[0]
    g = torch.Generator(device="cuda").manual_seed(copies)

    def randn(shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)

    t = {dt: {"H": randn((n_e, D), dt), "g": randn((n_e, D), dt),
              "y": randn((n_e, D), dt).clamp_min(0), "acc": randn((n_e, D), dt)}
         for dt in (torch.float32, torch.bfloat16)}
    yb, H0, g_nodes = t[torch.bfloat16]["y"], randn((n_e, D)), randn((n_v, D))
    W = randn((D, D), scale=D**-0.5)
    g_nodes[-1] = 0
    split = {"tiles": b.split_ptr, "cross": b.cross_rows}
    fns = {}
    for dt, x in t.items():
        name = str(dt).removeprefix("torch.")
        fns[f"A {name} split"] = lambda x=x: message(x["H"], *graph, **split)
        fns[f"A {name} without a table"] = lambda x=x: message(x["H"], *graph)
        for form, acc in (("", None), (" gz_acc", "acc")):
            kw = lambda x=x, acc=acc: dict(gz_acc=x[acc] if acc else None)  # noqa: E731
            fns[f"F {name}{form} split"] = lambda x=x, kw=kw: bwd_message(
                x["g"], x["y"], *graph, **kw(), **split)
            fns[f"F {name}{form} without a table"] = lambda x=x, kw=kw: bwd_message(
                x["g"], x["y"], *graph, **kw())
    fns.update({
        "G split": lambda: bwd_message_nodes(g_nodes, yb, *graph, **split),
        "G without a table": lambda: bwd_message_nodes(g_nodes, yb, *graph),
        "H fold_h0 split": lambda: bwd_message_premul(t[torch.bfloat16]["g"], yb, H0, W, *graph,
                                                      fold_h0=True, **split),
        "H fold_h0 without a table": lambda: bwd_message_premul(t[torch.bfloat16]["g"], yb, H0, W,
                                                                *graph, fold_h0=True),
        "H split": lambda: bwd_message_premul(t[torch.bfloat16]["g"], yb, None, W, *graph,
                                              **split),
        "H without a table": lambda: bwd_message_premul(t[torch.bfloat16]["g"], yb, None, W,
                                                        *graph),
        "D split": lambda: fused_iter2(H0, W, None, *graph, b.split_ptr, (b.y1_rows, b.y2_rows)),
        "D without a table": lambda: two_b(H0),
    })

    def two_b(x):
        y1 = fused_iter(x, x, W, None, *graph, relu_stream=True)
        return y1, fused_iter(y1, x, W, None, *graph)

    gb, Hx = t[torch.bfloat16]["g"], t[torch.bfloat16]["H"].clamp_min(0)
    e_split = lambda: iter_bwd(gb, yb, Hx, W, *graph, tiles=b.split_ptr,  # noqa: E731
                               cross=b.cross_rows)
    e_free = lambda: iter_bwd(gb, yb, Hx, W, *graph)  # noqa: E731
    if not torch.equal(e_split()[1], e_free()[1]):
        raise SystemExit("torch_split_tiles: E's gz over the split table differs")
    kernels = sorted({k.removesuffix(" split") for k in fns if k.endswith(" split")})
    for k in kernels:
        got, want = fns[f"{k} split"](), fns[f"{k} without a table"]()
        got, want = (got,) if isinstance(got, torch.Tensor) else got, \
            (want,) if isinstance(want, torch.Tensor) else want
        if not all(torch.equal(x, w) for x, w in zip(got, want)):
            raise SystemExit(f"torch_split_tiles: {k} over the split table differs")
    # the passes alone, into a scratch output (each overwrites the same rows)
    ids, cross = (b.src, b.rev, b.edge_ptr), b.cross_rows
    for dt, x in t.items():
        name = str(dt).removeprefix("torch.")
        out = torch.empty_like(x["H"])
        fns[f"A pass {name}"] = lambda x=x, out=out: _message_rows(x["H"], *ids, cross, out)
        fns[f"F pass {name}"] = lambda x=x, out=out: _cross_rows(x["g"], x["y"], b.dst, b.rev,
                                                                 b.edge_ptr, cross, out)
    gz, G = fns["G split"]()[1], torch.empty_like(yb)
    fns["G and H pass bfloat16"] = lambda: _cross_rows(gz, None, b.dst, b.rev, b.edge_ptr, cross,
                                                       G)
    fns["E split"], fns["E without a table"] = e_split, e_free
    y1, y2 = fns["D split"]()
    out = torch.empty_like(H0)
    fns["D pass y1"] = lambda: _fused_iter_rows(H0, H0, W, None, *ids, b.y1_rows, out,
                                                relu_stream=True)
    fns["D pass y2"] = lambda: _fused_iter_rows(y1, H0, W, None, *ids, b.y2_rows, out)
    fns["E pass"] = lambda: _iter_bwd_rows(gb, yb, b.dst, b.rev, b.edge_ptr, cross)
    return {"ms": {k: time_ms(f, reps) for k, f in fns.items()}, "device_us": profile(fns)}


def e_inputs(b, seed: int):
    """E's bf16 inputs at d = 384 for the batch ``b``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    n_e = b.E.shape[0]
    return (randn((n_e, D)), randn((n_e, D)).clamp_min(0), randn((n_e, D)).clamp_min(0),
            randn((D, D), D**-0.5))


def e_times(b, copies: int, reps: int) -> dict:
    """E over the split table and without a table (gz checked bit-equal)
    and, as yardsticks, the two library products at the cross rows: event
    and device times."""
    import torch
    from chip_smoke import time_ms
    from experiments.torch_fused_iter import profile

    from chemprop_tpu_torch.ops import iter_bwd

    graph, cross = (b.src, b.dst, b.rev, b.edge_ptr), b.cross_rows
    g, y, H, W = e_inputs(b, copies)
    fns = {"E split": lambda: iter_bwd(g, y, H, W, *graph, tiles=b.split_ptr, cross=cross),
           "E without a table": lambda: iter_bwd(g, y, H, W, *graph)}
    if not torch.equal(fns["E split"]()[1], fns["E without a table"]()[1]):
        raise SystemExit("torch_split_tiles: E's gz over the split table differs")
    Gc = g[cross.long()].contiguous()  # the cross rows' G's shape and dtype
    Hr, Wt = H[cross.long()].contiguous(), W.t().contiguous()
    fns["torch.mm G_c W^T"] = lambda: torch.mm(Gc, Wt)
    fns["torch.mm H[rows]^T G_c"] = lambda: torch.mm(Hr.t(), Gc, out_dtype=torch.float32)
    return {"ms": {k: time_ms(f, reps) for k, f in fns.items()}, "device_us": profile(fns)}


def e_batches_of_50(data, reps: int) -> list[dict]:
    """E over the split table and without a table on each batch of 50
    molecules (in the file's order) that has a split table."""
    import torch
    from chip_smoke import time_ms
    from experiments.torch_fused_iter import profile

    from chemprop_tpu_torch.data import collate_batch
    from chemprop_tpu_torch.ops import iter_bwd

    out = []
    for i in range(0, len(data), 50):
        b = collate_batch(data[i:i + 50]).to("cuda").bmg
        if b.split_ptr is None:
            continue
        graph = (b.src, b.dst, b.rev, b.edge_ptr)
        g, y, H, W = e_inputs(b, i)
        fns = {"E split": lambda: iter_bwd(g, y, H, W, *graph, tiles=b.split_ptr,
                                           cross=b.cross_rows),
               "E without a table": lambda: iter_bwd(g, y, H, W, *graph)}
        if not torch.equal(fns["E split"]()[1], fns["E without a table"]()[1]):
            raise SystemExit("torch_split_tiles: E's gz over the split table differs")
        out.append({"first_molecule": i, "rows": b.E.shape[0], "tiles": b.split_ptr.numel() - 1,
                    "cross_rows": b.cross_rows.numel(),
                    "ms": {k: time_ms(f, reps) for k, f in fns.items()},
                    "device_ms": {k: sum(v.values()) / 1e3 for k, v in profile(fns).items()}})
    return out


STEPS = (("float32", "float32", 0.0, {}),
         ("bfloat16 dropout", "bfloat16", 0.1, {}),
         ("bfloat16", "bfloat16", 0.0, {}),
         ("bfloat16 iter2", "bfloat16", 0.0, dict(iter2=True)),
         ("bfloat16 dropout fused_bwd", "bfloat16", 0.1, dict(fused_bwd=True)))
E_STEPS = ("bfloat16 iter2", "bfloat16 dropout fused_bwd")


def step_times(batch, reps: int, names=None) -> dict:
    """Training steps of the full-width BCE model (``STEPS``, or those
    named), with the split table and with it taken away: event and device
    milliseconds, and the launches and unserved calls of one step with it."""
    import torch
    from chip_smoke import head_model, time_ms
    from experiments.torch_fused_iter import profile

    from chemprop_tpu_torch.ops import LAUNCHES, UNSERVED, KernelOptions
    from chemprop_tpu_torch.train import Trainer

    b = batch.bmg
    unsplit = batch._replace(bmg=dataclasses.replace(b, split_ptr=None, cross_rows=None))
    res = {}
    for name, dtype, rate, options in STEPS:
        if names is not None and name not in names:
            continue
        model = head_model(getattr(torch, dtype), "BinaryClassificationFFN", n_tasks=4)
        model.message_passing.drop.rate = rate  # dropout between the iterations
        model.message_passing.kernel_options = KernelOptions(**options)
        trainer = Trainer(model, max_epochs=20, warmup_epochs=2, seed=12)
        trainer.init_state(batch, 8)
        steps = {f"{name} split": lambda: trainer.train_step(batch),
                 f"{name} without a table": lambda: trainer.train_step(unsplit)}
        UNSERVED.clear()
        LAUNCHES.clear()
        steps[f"{name} split"]()
        res[f"{name} split launches"] = dict(LAUNCHES)
        res[f"{name} split unserved"] = {k: v for k, v in UNSERVED.items() if v}
        res.setdefault("ms", {}).update({k: time_ms(f, reps, inner=2) for k, f in steps.items()})
        traces = profile(steps, calls=5)
        res.setdefault("device_ms", {}).update(
            {k: sum(v.values()) / 1e3 for k, v in traces.items()})
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--copies", default="1,4")
    ap.add_argument("--tree", type=Path, default=None,
                    help="import chemprop_tpu_torch and chip_smoke from this checkout instead")
    ap.add_argument("--steps-only", action="store_true", help="time the training steps alone")
    ap.add_argument("--e-only", action="store_true",
                    help="time kernel E, its two steps and E on batches of 50 molecules alone")
    ap.add_argument("--tag", default="", help="a suffix of the record's file name")
    args = ap.parse_args()
    tree = (args.tree or REPO).resolve()
    sys.path.insert(0, str(REPO))
    # the smoke run's helpers and the profiler, from this checkout whatever
    # --tree says
    import chip_smoke  # noqa: F401
    import experiments.torch_fused_iter  # noqa: F401

    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_split_tiles: no CUDA device", file=sys.stderr)
        return 2
    import chemprop_tpu_torch
    from chip_smoke import head_dataset, read_targets

    from chemprop_tpu_torch.data import collate_batch

    if Path(chemprop_tpu_torch.__file__).resolve().parent.parent != tree:
        print(f"imported {chemprop_tpu_torch.__file__}, not {tree}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    ds = head_dataset(read_targets(tree / "tests/data/classification/mol.csv"))[0]
    data = [ds[i] for i in range(len(ds))]
    record = {"card": card, "d": D, "tree": str(tree), "batches": []}
    for copies in map(int, args.copies.split(",")):
        batch = collate_batch(data * copies).to("cuda")
        b = batch.bmg
        if b.tile_ptr is not None or b.split_ptr is None:
            print("torch_split_tiles: the batch should have a split table only", file=sys.stderr)
            return 1
        res = {"card": card, "tree": str(tree), "copies": copies,
               "molecules": len(data) * copies, "rows": b.E.shape[0],
               "real_rows": int(b.edge_mask.sum()), "tiles": b.split_ptr.numel() - 1,
               "cross_rows": b.cross_rows.numel()}
        if args.e_only:
            res["e"] = e_times(b, copies, args.reps)
        elif not args.steps_only:
            res["kernels"] = kernel_times(b, copies, args.reps)
        res["steps"] = step_times(batch, args.reps, E_STEPS if args.e_only else None)
        record["batches"].append(res)
        print(json.dumps(res), flush=True)
    if args.e_only:
        record["batches_of_50"] = e_batches_of_50(data, args.reps)
        print(json.dumps({"card": card, "batches_of_50": record["batches_of_50"]}), flush=True)
    from chip_smoke import TRACES

    record["device_traces"] = TRACES
    print(json.dumps({"device_traces": TRACES}))
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    tag = ("_steps" if args.steps_only else "_e" if args.e_only else "") + \
        ("" if args.tree is None else f"_{tree.name}") + (f"_{args.tag}" if args.tag else "")
    (out / f"torch_split_tiles{tag}.json").write_text(json.dumps(record, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
