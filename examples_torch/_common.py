"""Shared plumbing of the port's examples: repo-relative data paths, the
``--device`` and ``--quick`` flags every script takes, and an in-process
runner of the port's command line. Every example writes its artefacts under
``examples_torch/out/<name>/``."""

from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"

if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def parse_args(doc: str, argv: list[str] | None = None) -> argparse.Namespace:
    """``--device`` (default ``cuda``, which raises where there is no GPU) and
    ``--quick`` (fewer epochs and rows, for a run on the CPU; never the
    default)."""
    import torch

    from chemprop_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of every trainer and subcommand (default: cuda)")
    ap.add_argument("--quick", action="store_true",
                    help="fewer epochs and rows (a check on the CPU, not the example)")
    args = ap.parse_args(argv)
    # the port's rule: cuda means a GPU, and its absence raises here
    resolve_device(None if torch.device(args.device).type == "cuda" else args.device)
    return args


def out_dir(name: str) -> Path:
    d = Path(__file__).resolve().parent / "out" / name
    d.mkdir(parents=True, exist_ok=True)
    return d


def epochs(n: int, quick: bool) -> str:
    return str(1 if quick else n)


def head(path: Path, out: Path, quick: bool, n: int = 24) -> Path:
    """``path``, or with ``quick`` its header and first ``n`` rows in ``out``."""
    if not quick:
        return path
    with open(path, newline="") as f:
        rows = list(csv.reader(f))[: n + 1]
    dst = out / f"{path.stem}_head{n}.csv"
    with open(dst, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return dst


def run_cli(argv: list, device: str | None) -> None:
    """Run a subcommand of the port's command line in this process (as
    ``python -m chemprop_tpu_torch.cli ...``), on ``device`` where given."""
    from chemprop_tpu_torch.cli.main import main

    extra = [] if device is None else ["--device", device]
    rc = main([*map(str, argv), *extra])
    if rc not in (0, None):
        raise SystemExit(rc)
