#!/usr/bin/env python3
"""Which side's bits vary in the float32 tanh module of
``tests/test_torch_cuda.py::test_message_passing_variants_on_card_match_cpu``:
the same ``BondMessagePassing`` (d_h 64, tanh, float32, parameters from
``torch.manual_seed(0)``) on the test's ten molecules, called ``--calls``
times on the card and on the CPU.

    python3 experiments/torch_tanh_bits.py [--calls 50] [--deterministic]

It prints, for each device, how many distinct outputs the calls gave (1: the
same bits every call), and for each stage of the forward (W_i's product,
each iteration's message, product and tanh, the M_v readout, W_o's product)
how many distinct results that stage gave over the calls, fed the same
inputs. Against a float64 reference of the same forward it prints each
device's largest error and the largest error in units of the test's limit
(1e-5 + 1e-4 |x|), and the card's against the CPU's as the test holds them.
``--deterministic`` sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and
``torch.use_deterministic_algorithms(True)`` before anything runs on the
card. The card's name and power limit head the output; the record goes to
chiprun_out/torch_tanh_bits.json."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SMIS = ["CCO", "c1ccccc1", "CC(=O)Nc1ccc(O)cc1", "CNC(C)Cc1ccccc1",
        "CC(C)CC1=CC=C(C=C1)C(C)C(=O)O", "c1ccc2ccccc2c1", "CC(=O)OC1=CC=CC=C1C(=O)O",
        "C1CCNCC1", "C", "O=[N+]([O-])c1ccc(Cl)cc1"]  # the test's molecules


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    if args.deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    sys.path.insert(0, str(REPO))
    import torch

    if args.deterministic:
        torch.use_deterministic_algorithms(True)
    from chemprop_tpu_torch.chem import make_mol
    from chemprop_tpu_torch.data.collate import PadSpec, batch_mol_graphs
    from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer
    from chemprop_tpu_torch.nn import BondMessagePassing
    from chemprop_tpu_torch.ops import message, sorted_segment_sum
    from chemprop_tpu_torch.ops.message import message_plain
    from chemprop_tpu_torch.ops.segment import sorted_segment_sum_plain

    if not torch.cuda.is_available():
        print("torch_tanh_bits: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    feat = SimpleMoleculeMolGraphFeaturizer()
    cpu_bmg = batch_mol_graphs([feat(make_mol(s)) for s in SMIS], PadSpec(256, 768, len(SMIS)))
    gpu_bmg = cpu_bmg.to("cuda")
    mp = BondMessagePassing(d_h=64, activation="tanh")
    torch.manual_seed(0)
    for p in mp.parameters():
        torch.nn.init.normal_(p, std=0.1)
    real = cpu_bmg.node_mask
    W_i, _ = mp._padded(mp.W_i, mp.d_v + mp.d_e, mp.d_pad)
    W_h, _ = mp._padded(mp.W_h, mp.d_pad, mp.d_pad)
    W_o, b_o = mp._padded(mp.W_o, mp.d_v + mp.d_pad, mp.d_pad)

    def stages(bmg, W_i, W_h, W_o, b_o, msg, seg):
        """The module's composed forward, stage by stage."""
        graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
        out = {}
        x = torch.cat([bmg.V.to(W_i.dtype)[bmg.src.long()], bmg.E.to(W_i.dtype)], dim=1)
        H0 = out["H0 = x W_i"] = x @ W_i
        H = torch.tanh(H0)
        for it in range(1, mp.depth):
            M = out[f"M{it} = message"] = msg(H, *graph, bmg.tile_ptr)
            z = out[f"z{it} = M W_h"] = M @ W_h
            H = out[f"H{it} = tanh(H0 + z)"] = torch.tanh(H0 + z)
        M_v = out["M_v = segment sum"] = seg(H.contiguous(), bmg.dst, bmg.edge_ptr)
        VM = torch.cat([bmg.V.to(W_i.dtype), M_v], dim=1)
        out["H_v = tanh(VM W_o + b_o)"] = torch.tanh(VM @ W_o + b_o)
        return out

    def plain_seg(x, ids, ptr):
        return sorted_segment_sum_plain(x, ids, ptr, x.dtype)[0]

    def plain_msg(H, src, dst, rev, ptr, tiles):
        return message_plain(H, src, dst, rev, ptr)

    ref = stages(cpu_bmg, W_i.double(), W_h.double(), W_o.double(), b_o.double(),
                 plain_msg, plain_seg)
    want = ref["H_v = tanh(VM W_o + b_o)"][real]
    record = {"card": card, "calls": args.calls, "deterministic": args.deterministic}
    outs = {}
    with torch.no_grad():
        for dev, bmg in (("cpu", cpu_bmg), ("cuda", gpu_bmg)):
            m = mp.to(dev)
            runs = [m(bmg).cpu() for _ in range(args.calls)]
            outs[dev] = runs
            distinct = len({r.numpy().tobytes() for r in runs})
            errs = [(r[real].double() - want).abs() for r in runs]
            limit = 1e-5 + 1e-4 * want.abs()
            record[dev] = {
                "distinct_outputs": distinct,
                "max_err_vs_float64": max(float(e.max()) for e in errs),
                "max_err_over_test_limit_vs_float64": max(float((e / limit).max()) for e in errs),
            }
            # each stage fed the same inputs every call
            Ws = [w.to(dev) for w in (W_i, W_h, W_o, b_o)]
            seg = sorted_segment_sum if dev == "cuda" else plain_seg
            msg = message if dev == "cuda" else plain_msg
            per_stage = [stages(bmg, *Ws, msg, seg) for _ in range(args.calls)]
            record[dev]["distinct_by_stage"] = {
                k: len({s[k].cpu().numpy().tobytes() for s in per_stage}) for k in per_stage[0]}
            record[dev]["stage_max_err_vs_float64"] = {
                k: float((per_stage[0][k].cpu().double() - ref[k]).abs().max())
                for k in per_stage[0]}
        mp.to("cpu")
    cpu0 = outs["cpu"][0][real]
    limit = 1e-5 + 1e-4 * cpu0.abs()
    over = [int(((r[real] - cpu0).abs() > limit).sum()) for r in outs["cuda"]]
    ratio = [float(((r[real] - cpu0).abs() / limit).max()) for r in outs["cuda"]]
    record["cuda_vs_cpu"] = {"elements": int(cpu0.numel()),
                             "calls_with_elements_over_the_test_limit": sum(o > 0 for o in over),
                             "most_elements_over": max(over), "max_err_over_limit": max(ratio),
                             "max_abs_err": max(float((r[real] - cpu0).abs().max())
                                                for r in outs["cuda"])}
    print(json.dumps(record, indent=1))
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = "torch_tanh_bits" + ("_deterministic" if args.deterministic else "") + ".json"
    (out / name).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
