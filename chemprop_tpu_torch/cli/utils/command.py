"""The ``Subcommand`` base (cf. ``chemprop_tpu/cli/utils/command.py``)."""

from __future__ import annotations

from abc import ABC, abstractmethod
from argparse import ArgumentParser, Namespace

__all__ = ["Subcommand"]


class Subcommand(ABC):
    """A named subcommand of the command line: its flags and its entry
    function. A subclass sets ``COMMAND`` (the subparser's name) and
    ``HELP``, and implements ``add_args`` and ``func``; ``add`` puts it on a
    parser's subparsers, with ``func`` as the parsed arguments' ``func``."""

    COMMAND: str
    HELP: str | None = None

    @classmethod
    def add(cls, subparsers, parents=()) -> ArgumentParser:
        parser = subparsers.add_parser(cls.COMMAND, help=cls.HELP, parents=list(parents))
        cls.add_args(parser).set_defaults(func=cls.func)
        return parser

    @classmethod
    @abstractmethod
    def add_args(cls, parser: ArgumentParser) -> ArgumentParser: ...

    @classmethod
    @abstractmethod
    def func(cls, args: Namespace): ...
