"""Entry point of the port's command line (cf. ``chemprop_tpu/cli/main.py``):
the ``train``, ``predict``, ``fingerprint``, ``convert``, ``serve`` and
``hpopt`` subcommands, each a ``cli.utils.Subcommand`` of its module
(``TrainSubcommand`` ...), ``--version``, logging (``-v`` / ``-q`` /
``--logfile``), and argument defaults from a JSON or TOML file
(``--config-path``, before or after the subcommand; a flag given on the
command line wins).

    python -m chemprop_tpu_torch.cli {train,predict,fingerprint,convert,serve,hpopt} ..."""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

from chemprop_tpu_torch import __version__
from chemprop_tpu_torch.cli.convert import ConvertSubcommand
from chemprop_tpu_torch.cli.fingerprint import FingerprintSubcommand
from chemprop_tpu_torch.cli.hpopt import HpoptSubcommand
from chemprop_tpu_torch.cli.predict import PredictSubcommand
from chemprop_tpu_torch.cli.serve import ServeSubcommand
from chemprop_tpu_torch.cli.train import TrainSubcommand

logger = logging.getLogger(__name__)

LOG_LEVELS = {0: logging.INFO, 1: logging.DEBUG, -1: logging.WARNING, -2: logging.ERROR}
SUBCOMMANDS = (TrainSubcommand, PredictSubcommand, FingerprintSubcommand, ConvertSubcommand,
               ServeSubcommand, HpoptSubcommand)


def construct_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m chemprop_tpu_torch.cli")
    parser.add_argument("--version", action="version", version=__version__)
    parser.add_argument("--logfile", "--log", nargs="?", const="default")
    parser.add_argument("-v", action="count", default=0, dest="verbose")
    parser.add_argument("-q", action="count", default=0, dest="quiet")
    parser.add_argument("--config-path", type=Path, help="JSON/TOML file of argument defaults")
    subparsers = parser.add_subparsers(title="mode", dest="mode", required=True)
    for cmd in SUBCOMMANDS:
        cmd.add(subparsers)
    return parser


def _apply_config_defaults(argv: list[str]) -> list[str]:
    """``argv`` with the config file's entries appended as flags, each one
    the command line does not give already (true booleans as bare flags,
    lists as several values, None and false left out)."""
    if "--config-path" not in argv:
        return argv
    path = Path(argv[argv.index("--config-path") + 1])
    if path.suffix == ".toml":
        import tomllib

        cfg = tomllib.loads(path.read_text())
    else:
        cfg = json.loads(path.read_text())
    extra: list[str] = []
    for k, v in cfg.items():
        flag = f"--{k.replace('_', '-')}"
        if flag in argv or v is None:
            continue
        if isinstance(v, bool):
            if v:
                extra.append(flag)
        elif isinstance(v, (list, tuple)):
            extra.extend([flag, *map(str, v)])
        else:
            extra.extend([flag, str(v)])
    return argv + extra


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = construct_parser()
    args = parser.parse_args(_apply_config_defaults(argv))

    level = LOG_LEVELS.get(min(max(args.verbose - args.quiet, -2), 1), logging.INFO)
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if args.logfile:
        logpath = (Path("chemprop_tpu_torch.log") if args.logfile == "default"
                   else Path(args.logfile))
        handlers.append(logging.FileHandler(logpath))
    logging.basicConfig(level=level, format="%(asctime)s %(levelname)s %(name)s: %(message)s",
                        handlers=handlers, force=True)
    # -i takes one to three files for train and one elsewhere; the code after
    # sees args.data_path (the first file) and args.data_paths (all of them)
    dp = getattr(args, "data_path", None)
    if isinstance(dp, list):
        if args.mode == "train":
            if not 1 <= len(dp) <= 3:
                parser.error("train takes one, two, or three -i/--data-path files")
        elif len(dp) != 1:
            parser.error(f"{args.mode} takes exactly one -i/--data-path file")
        args.data_paths = dp
        args.data_path = dp[0]
    elif dp is not None:
        args.data_paths = [dp]
    logger.info(f"chemprop_tpu_torch :: {args.mode}")
    return args.func(args) or 0


if __name__ == "__main__":
    raise SystemExit(main())
