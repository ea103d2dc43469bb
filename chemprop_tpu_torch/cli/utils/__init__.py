"""The command line's reference-compatible Python surface (cf.
``chemprop_tpu/cli/utils/__init__.py``): argparse helpers, the
``Subcommand`` base that every subcommand of the port's command line
subclasses, CSV and datapoint factories, and small attribute utilities,
under the JAX package's names, so that a script written against
``chemprop_tpu.cli.utils`` runs on the port. The parsing is the port's own
(:mod:`chemprop_tpu_torch.cli.parsing`, :mod:`chemprop_tpu_torch.cli.mab`),
with the ``csv`` module where the JAX package reads through pandas."""

from __future__ import annotations

from chemprop_tpu_torch.cli.utils import actions, args, command, parsing, utils
from chemprop_tpu_torch.cli.utils.actions import LookupAction
from chemprop_tpu_torch.cli.utils.args import activation_function_argument, bounded
from chemprop_tpu_torch.cli.utils.command import Subcommand
from chemprop_tpu_torch.cli.utils.parsing import (
    build_data_from_files,
    build_MAB_data_from_files,
    get_column_names,
    make_datapoints,
    make_dataset,
    parse_activation,
    parse_indices,
)
from chemprop_tpu_torch.cli.utils.utils import (
    _pop_attr,
    _pop_attr_d,
    format_probability_string,
    pop_attr,
)

__all__ = [
    "activation_function_argument",
    "bounded",
    "LookupAction",
    "Subcommand",
    "build_data_from_files",
    "build_MAB_data_from_files",
    "make_datapoints",
    "make_dataset",
    "get_column_names",
    "parse_activation",
    "parse_indices",
    "actions",
    "args",
    "command",
    "format_probability_string",
    "parsing",
    "utils",
    "pop_attr",
    "_pop_attr",
    "_pop_attr_d",
]
