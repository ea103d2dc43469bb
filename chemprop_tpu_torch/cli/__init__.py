"""Command line: ``python -m chemprop_tpu_torch.cli predict ...``."""

from chemprop_tpu_torch.cli.main import construct_parser, main

__all__ = ["construct_parser", "main"]
