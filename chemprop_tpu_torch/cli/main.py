"""Entry point of the port's command line (cf. ``chemprop_tpu/cli/main.py``);
this slice has the ``predict`` subcommand."""

from __future__ import annotations

import argparse

from chemprop_tpu_torch.cli import predict


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m chemprop_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    predict.add_args(sub.add_parser("predict", help="predict with a trained model"))
    args = parser.parse_args(argv)
    return predict.main(args)
