"""Command line: ``python -m chemprop_tpu_torch.cli predict ...``."""
