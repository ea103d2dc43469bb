#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``chemprop_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--reps 21]

from the root of a checkout. It needs one CUDA device and exits non-zero,
printing no result, without one or outside a checkout. Phases, each fatal on
failure:

1. the card's name and power limit (``nvidia-smi``); build the kernels from
   ``chemprop_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. hold every kernel against its plain PyTorch version on the card, at the
   shapes of the serving path's benchmark batch: 2048 molecules of
   tests/data/regression/mol/mol.csv, tiled (the batch ``bench.py`` builds),
   hidden width 300 padded to 384;
3. the main path: ``python -m chemprop_tpu_torch.cli predict`` on the 100
   rows of mol.csv with the reference checkpoint
   tests/data/example_model_v2_regression_mol.pt, on ``cuda`` in float32 and
   bfloat16, held against the same entry point's CPU predictions; the launch
   counts are zeroed just before each dtype's run and read just after it,
   and each path must have launched its own kernels;
4. on the benchmark batch: each dtype's launches in one forward, counted on
   their own; timing with CUDA events of each kernel, its plain version and
   the one PyTorch call that computes the same function, where there is one;
   and the forward's molecules per second.

The last lines of standard output are the ``kernels`` JSON line, the card's
name and power limit, and ``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json."""

from __future__ import annotations

import argparse
import csv
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CKPT = REPO / "tests/data/example_model_v2_regression_mol.pt"
MOL_CSV = REPO / "tests/data/regression/mol/mol.csv"
BATCH_SIZE = 2048  # bench.py's benchmark batch
BF16_ULP = 2.0**-7  # relative spacing of bfloat16

# published dense peaks (NVIDIA data sheets): memory bytes/s, bf16 tensor-core
# and f32 (non-tensor) operations/s, by the part named in the card's name
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),  # SXM, 80 GB HBM3
}

# the TPU kernels the port replaces; "timed" names the check whose inputs
# the timing phase uses, so that the row's error is that case's
KERNELS = {
    "message": dict(
        source="chemprop_tpu_torch/csrc/message.cu",
        replaces="chemprop_tpu/ops/fused_message.py:244",
        tpu_kernel="_kernel via _fused_message_impl",
        timed="message[float32]",
    ),
    "fused_iter": dict(
        source="chemprop_tpu_torch/csrc/message.cu",
        replaces="chemprop_tpu/ops/fused_message.py:290",
        tpu_kernel="_iter_kernel via _iter_impl",
        timed="fused_iter[relu_stream=False,bias=False]",
    ),
    "sorted_segment_sum": dict(
        source="chemprop_tpu_torch/csrc/segment.cu",
        replaces="chemprop_tpu/ops/sorted_segments.py:51",
        tpu_kernel="_make_kernel via _sorted_segment_sum_fwd_impl",
        timed="sorted_segment_sum[edge->node,torch.bfloat16->torch.bfloat16]",
    ),
}
# the kernels each main path must launch, and those it must not (depth 3:
# two message-passing iterations; the M_v and the mean readout)
PATH_KERNELS = {
    "float32": {"message": 2, "sorted_segment_sum": 2, "fused_iter": 0},
    "bfloat16": {"fused_iter": 2, "sorted_segment_sum": 2, "message": 0},
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name: str) -> tuple[float, float, float]:
    for part, p in PEAKS.items():
        if part in name:
            return p
    fail(f"no published peaks for {name!r}")


def read_smiles() -> list[str]:
    with open(MOL_CSV, newline="") as f:
        return [row[0] for row in list(csv.reader(f))[1:]]


def benchmark_batch(device):
    from chemprop_tpu_torch.chem import make_mol
    from chemprop_tpu_torch.data import batch_mol_graphs
    from chemprop_tpu_torch.featurizers import SimpleMoleculeMolGraphFeaturizer

    feat = SimpleMoleculeMolGraphFeaturizer()
    mgs = [feat(make_mol(s)) for s in read_smiles()]
    mgs = (mgs * -(-BATCH_SIZE // len(mgs)))[:BATCH_SIZE]
    return batch_mol_graphs(mgs).to(device)


def max_err(got, want) -> tuple[float, float]:
    """(max abs error, max |want|)."""
    return float((got.float() - want.float()).abs().max()), float(want.float().abs().max())


def check(name: str, got, want, rtol: float, atol: float, errs: dict, scale=None) -> None:
    """Fail unless ``|got - want| <= atol + rtol * scale`` everywhere;
    ``scale`` is ``|want|`` unless given."""
    abs_err, ref = max_err(got, want)
    print(json.dumps({"check": name, "max_abs_err": abs_err, "max_abs_ref": ref,
                      "rtol": rtol, "atol": atol,
                      "scale": "|want|" if scale is None else "segment sum of |x|"}))
    scale = want.float().abs() if scale is None else scale
    if not ((got.float() - want.float()).abs() <= atol + rtol * scale).all():
        fail(f"{name}: kernel disagrees with its plain version (max abs err {abs_err})")
    errs[name] = abs_err


def check_kernels(bmg, d: int, seed: int) -> tuple[dict, dict]:
    """Phase 2: each kernel against its plain version at the main path's
    shapes, in the dtypes the main paths give it; returns the inputs the
    timing phase reuses and each check's max abs error."""
    import torch

    from chemprop_tpu_torch.ops import fused_iter, message
    from chemprop_tpu_torch.ops import sorted_segment_sum, sorted_segment_sum_counts
    from chemprop_tpu_torch.ops.message import fused_iter_plain, message_plain
    from chemprop_tpu_torch.ops.segment import sorted_segment_sum_plain

    dev = bmg.V.device
    g = torch.Generator(device=dev).manual_seed(seed)
    n_e, n_v = bmg.E.shape[0], bmg.V.shape[0]
    graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
    H32 = torch.randn((n_e, d), generator=g, device=dev)
    H0 = torch.randn((n_e, d), generator=g, device=dev).to(torch.bfloat16)
    H = H32.to(torch.bfloat16)
    W = (torch.randn((d, d), generator=g, device=dev) * d**-0.5).to(torch.bfloat16)
    b = torch.randn(d, generator=g, device=dev).to(torch.bfloat16)
    Hv = torch.randn((n_v, d), generator=g, device=dev).to(torch.bfloat16)
    errs: dict = {}

    # f32: only the summation order differs; bf16 out: one rounding apart
    check("message[float32]", message(H32, *graph), message_plain(H32, *graph), 1e-5, 1e-5, errs)
    for relu_stream, bias in ((True, None), (False, None), (False, b)):
        tag = f"fused_iter[relu_stream={relu_stream},bias={bias is not None}]"
        x = H0 if relu_stream else H
        # the bf16 message may round one ulp apart, which W carries into y;
        # y's own rounding adds one ulp
        check(tag, fused_iter(x, H0, W, bias, *graph, relu_stream=relu_stream),
              fused_iter_plain(x, H0, W, bias, *graph, relu_stream=relu_stream),
              2 * BF16_ULP, 0.02, errs)
    # f32 sums in another order differ by up to a few eps times the sum of
    # |x| over the segment (the padding segments hold thousands of rows, and
    # the plain version's index_add_ order itself varies from run to run),
    # so f32 outputs are held to 1e-5 of that; a bf16 output rounds once more
    def abs_sums(data, ids, ptr):
        return sorted_segment_sum_plain(data.abs(), ids, ptr, torch.float32)[0]

    for data, out_dtype in ((H32, torch.float32), (H, torch.bfloat16)):
        got = sorted_segment_sum(data, bmg.dst, bmg.edge_ptr, out_dtype)
        want, _ = sorted_segment_sum_plain(data, bmg.dst, bmg.edge_ptr, out_dtype)
        tag = f"sorted_segment_sum[edge->node,{data.dtype}->{out_dtype}]"
        if out_dtype == torch.bfloat16:
            check(tag, got, want, BF16_ULP, 1e-4, errs)
        else:
            check(tag, got, want, 1e-5, 1e-6, errs, abs_sums(data, bmg.dst, bmg.edge_ptr))
    for data in (Hv.float(), Hv):
        got, counts = sorted_segment_sum_counts(data, bmg.batch, bmg.node_ptr)
        want, want_counts = sorted_segment_sum_plain(
            data, bmg.batch, bmg.node_ptr, torch.float32, True
        )
        check(f"sorted_segment_sum[node->graph+counts,{data.dtype}]", got, want, 1e-5, 1e-6,
              errs, abs_sums(data, bmg.batch, bmg.node_ptr))
        if not torch.equal(counts, want_counts):
            fail("sorted_segment_sum: counts disagree")
    torch.cuda.synchronize()
    return dict(H32=H32, H=H, H0=H0, W=W, Hv=Hv), errs


def cli_predict(dtype: str, device: str | None, out: Path):
    """The user's entry point, in this process so that its launches count."""
    import numpy as np

    from chemprop_tpu_torch.cli.main import main

    argv = ["predict", "--model-path", str(CKPT), "-i", str(MOL_CSV), "-o", str(out),
            "--dtype", dtype]
    if device is not None:
        argv += ["--device", device]
    if main(argv) != 0:
        fail(f"predict --dtype {dtype} returned non-zero")
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != ["name", "pred_0"] or len(rows) != 101:
        fail(f"predict --dtype {dtype}: unexpected CSV layout {rows[0]} x {len(rows)}")
    preds = np.array([float(r[1]) for r in rows[1:]])
    if not np.isfinite(preds).all():
        fail(f"predict --dtype {dtype}: non-finite predictions")
    return preds


def check_path_launches(path: str, launches: dict, per_forward: bool) -> None:
    """Fail unless the path launched its kernels (exactly the expected counts
    for one forward) and none of the other path's."""
    for name, want in PATH_KERNELS[path].items():
        got = launches.get(name, 0)
        ok = got == want if per_forward or want == 0 else got > 0
        if not ok:
            fail(f"the {path} path launched {name} {got} times, expected "
                 f"{want}{'' if per_forward or want == 0 else ' or more'}")


def main_path(out_dir: Path) -> tuple[dict, dict]:
    """Phase 3: the CLI on cuda in f32 and bf16, against its CPU predictions;
    each path's launches are counted on their own."""
    import numpy as np

    from chemprop_tpu_torch.ops import LAUNCHES

    gpu, launches = {}, {}
    for dt in ("float32", "bfloat16"):
        LAUNCHES.clear()
        gpu[dt] = cli_predict(dt, None, out_dir / f"gpu_{dt}.csv")
        launches[dt] = dict(LAUNCHES)
        check_path_launches(dt, launches[dt], per_forward=False)
    print(json.dumps({"main_path_launches": launches}))
    cpu = {dt: cli_predict(dt, "cpu", out_dir / f"cpu_{dt}.csv") for dt in ("float32", "bfloat16")}
    res = {
        "f32_vs_cpu_f32": float(np.abs(gpu["float32"] - cpu["float32"]).max()),
        "bf16_vs_cpu_bf16": float(np.abs(gpu["bfloat16"] - cpu["bfloat16"]).max()),
        "bf16_vs_cpu_f32": float(np.abs(gpu["bfloat16"] - cpu["float32"]).max()),
        "pred_range": [float(cpu["float32"].min()), float(cpu["float32"].max())],
    }
    print(json.dumps({"main_path": res}))
    # f32: another summation order only. bf16 against the CPU's bf16: the
    # same computation, apart from summation order and the odd bf16 rounding
    # flip of a hidden value, which the mean readout and the f32 FFN shrink
    # far below one bf16 ulp of a prediction (2**-6 near 2.2). bf16 against
    # f32: the JAX package's bf16 parity envelope (rtol 0.05, atol 0.1)
    if not np.allclose(gpu["float32"], cpu["float32"], rtol=1e-5, atol=1e-4):
        fail("float32 predictions on cuda disagree with the CPU's")
    if not np.allclose(gpu["bfloat16"], cpu["bfloat16"], rtol=0, atol=1e-3):
        fail("bfloat16 predictions on cuda disagree with the CPU's bfloat16 ones")
    if not np.allclose(gpu["bfloat16"], cpu["float32"], rtol=0.05, atol=0.1):
        fail("bfloat16 predictions on cuda leave the envelope of the CPU's float32 ones")
    return launches, res


def time_ms(fn, reps: int, inner: int = 5) -> float:
    """Median over ``reps`` runs of ``inner`` back-to-back calls between two
    CUDA events, per call, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def timings(bmg, t: dict, d: int, reps: int, card: str) -> dict:
    """Phase 4: kernel, plain and library times with the least time the card
    could take (bytes over the memory rate or operations over the peak)."""
    import torch

    from chemprop_tpu_torch.ops import fused_iter, message, sorted_segment_sum
    from chemprop_tpu_torch.ops.message import fused_iter_plain, message_plain
    from chemprop_tpu_torch.ops.segment import sorted_segment_sum_plain

    bw, bf16_peak, f32_peak = peaks(card)
    graph = (bmg.src, bmg.dst, bmg.rev, bmg.edge_ptr)
    n_e, n_v = bmg.E.shape[0], bmg.V.shape[0]
    real = bmg.edge_mask
    # per edge: the in-edges of its source (one add each) and the reverse edge
    in_deg = (bmg.edge_ptr[1:] - bmg.edge_ptr[:-1]).long()
    adds = float((in_deg[bmg.src.long()][real] + 1).sum()) * d
    n_real = int(real.sum())
    ids_bytes = 4 * (3 * n_e + n_v + 1)
    out = {}

    def bound(nbytes, ops, peak):
        tb, to = nbytes / bw * 1e3, ops / peak * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    # message, f32 as on the main path: H read once, M written once
    b_ms, b_by = bound(2 * n_e * d * 4 + ids_bytes, adds, f32_peak)
    out["message"] = dict(
        ms=time_ms(lambda: message(t["H32"], *graph), reps),
        plain_ms=time_ms(lambda: message_plain(t["H32"], *graph), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="float32",
    )
    # fused iteration, bf16: H and H0 read, y written, W read once; the
    # message adds and the product of the real rows' messages with W
    b_ms, b_by = bound(3 * n_e * d * 2 + d * d * 2 + ids_bytes, 2 * n_real * d * d, bf16_peak)
    out["fused_iter"] = dict(
        ms=time_ms(lambda: fused_iter(t["H"], t["H0"], t["W"], None, *graph), reps),
        plain_ms=time_ms(lambda: fused_iter_plain(t["H"], t["H0"], t["W"], None, *graph), reps),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="bfloat16",
    )
    # segment sum, the M_v readout in bf16: E rows read, N rows written
    ids64 = bmg.dst.long()
    acc = torch.zeros((n_v, d), dtype=torch.bfloat16, device=bmg.V.device)
    b_ms, b_by = bound((n_e + n_v) * d * 2 + 4 * (n_e + n_v + 1), n_e * d, f32_peak)
    out["sorted_segment_sum"] = dict(
        ms=time_ms(lambda: sorted_segment_sum(t["H"], bmg.dst, bmg.edge_ptr), reps),
        plain_ms=time_ms(
            lambda: sorted_segment_sum_plain(t["H"], bmg.dst, bmg.edge_ptr, torch.bfloat16), reps
        ),
        library_ms=time_ms(lambda: acc.index_add_(0, ids64, t["H"]), reps),
        bound_ms=b_ms, bound_by=b_by, shape=[n_e, d], dtype="bfloat16",
    )
    return out


def forward_rate(bmg, reps: int) -> dict:
    """Each dtype's launches in one forward on the benchmark batch (counted
    on their own, and held to the expected counts), then the forward's
    molecules per second (featurisation and collate are host work and not
    included)."""
    import torch

    from chemprop_tpu_torch.models import load_model
    from chemprop_tpu_torch.ops import LAUNCHES

    rates = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model, _ = load_model(CKPT, bmg.V.device, dt)
        LAUNCHES.clear()
        model(bmg)
        launches = dict(LAUNCHES)
        check_path_launches(name, launches, per_forward=True)
        ms = time_ms(lambda: model(bmg), reps, inner=3)
        rates[name] = {"launches_per_forward": launches, "forward_ms": ms,
                       "molecules_per_s": BATCH_SIZE / ms * 1e3}
    return rates


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=21, help="timed runs per measurement (>= 20)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    if not (REPO / "chemprop_tpu_torch" / "csrc").is_dir() or not CKPT.exists():
        print("chip_smoke: run it from the root of a chemprop-tpu checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chemprop_tpu_torch.ops import build_all

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    t0 = time.time()
    logs = build_all()
    build_s = time.time() - t0
    print(json.dumps({"phase": "build", "seconds": build_s}))
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "error" in line:
                print(f"[{name}] {line.strip()}")

    d = 384  # hidden width 300, lane-padded as in the JAX package
    bmg = benchmark_batch("cuda")
    shapes = {"molecules": BATCH_SIZE, "E_pad": bmg.E.shape[0], "E_real": int(bmg.edge_mask.sum()),
              "N_pad": bmg.V.shape[0], "N_real": int(bmg.node_mask.sum()), "d": d}
    print(json.dumps({"benchmark_batch": shapes}))
    tensors, errs = check_kernels(bmg, d, args.seed)

    out_dir = REPO / "chiprun_out"
    (out_dir / "chip_smoke_preds").mkdir(parents=True, exist_ok=True)
    launches, path_res = main_path(out_dir / "chip_smoke_preds")

    times = timings(bmg, tensors, d, args.reps, kind)
    rates = forward_rate(bmg, args.reps)
    print(json.dumps({"forward": rates}))

    kernels = []
    for name, meta in KERNELS.items():
        by_path = {p: launches[p].get(name, 0) for p in launches}
        per_fwd = {p: rates[p]["launches_per_forward"].get(name, 0) for p in rates}
        checks = {tag: err for tag, err in errs.items() if tag.split("[")[0] == name}
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            tpu_kernel=meta["tpu_kernel"], launches=sum(by_path.values()),
            launches_by_path=by_path, launches_per_forward=per_fwd,
            max_abs_err=errs[meta["timed"]], max_abs_err_by_check=checks, **times[name],
        ))
    record = {"card": card, "kind": kind, "build_s": build_s, "benchmark_batch": shapes,
              "main_path": path_res, "forward": rates, "kernels": kernels}
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
