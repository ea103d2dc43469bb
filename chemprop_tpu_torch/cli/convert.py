"""``convert``: a reference checkpoint -> a ``CPTPU001`` file, which the JAX
package and the port both load (cf. ``chemprop_tpu/cli/convert.py``).

    python -m chemprop_tpu_torch.cli convert -i model.pt [-o model.tpu.ckpt] \\
        [--conversion torch_to_tpu|v1_to_v2|v2_0_to_v2_1]

The input is a chemprop v2 ``.pt`` / ``.ckpt``, a chemprop v1 ``.pt`` or a
``CPTPU001`` file, read by ``models.load_model`` on the CPU and written by
``models.serialize.save_model`` with its output columns. ``--conversion``
takes the JAX CLI's three choices, which all write a ``CPTPU001`` file, as
there. The output is ``<input>.tpu.ckpt`` by default. No device is used."""

from __future__ import annotations

import argparse
from pathlib import Path

from chemprop_tpu_torch.cli.utils.command import Subcommand
from chemprop_tpu_torch.models import serialize
from chemprop_tpu_torch.models.load import load_model


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("-i", "--input-path", type=Path, required=True,
                        help="reference v1/v2 .pt/.ckpt checkpoint")
    parser.add_argument("-o", "--output-path", type=Path, default=None)
    parser.add_argument(
        "--conversion", default="torch_to_tpu", choices=["torch_to_tpu", "v1_to_v2", "v2_0_to_v2_1"],
        help="all three write a CPTPU001 file, as in the JAX package's CLI")
    return parser


def main(args: argparse.Namespace) -> int:
    out = args.output_path or args.input_path.with_suffix(".tpu.ckpt")
    model, output_columns = load_model(args.input_path, "cpu")
    serialize.save_model(out, model, output_columns)
    print(f"converted {args.input_path} -> {out}")
    return 0


add_convert_args = add_args  # the JAX package's name


class ConvertSubcommand(Subcommand):
    """``convert`` on the command line: :func:`add_args` and :func:`main`."""

    COMMAND = "convert"
    HELP = "convert a reference checkpoint to a CPTPU001 file"
    add_args = staticmethod(add_args)
    func = staticmethod(main)
