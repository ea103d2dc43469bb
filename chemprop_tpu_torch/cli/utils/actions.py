"""A registry-backed argparse action (cf. ``chemprop_tpu/cli/utils/actions.py``)."""

from __future__ import annotations

from argparse import Action
from typing import Any, Mapping

__all__ = ["LookupAction"]


def LookupAction(obj: Mapping[str, Any]) -> type[Action]:
    """An argparse action whose ``choices`` are the keys of a registry
    mapping: ``parser.add_argument(..., action=LookupAction(registry))``
    holds the flag to the registry's keys and stores the string given. A
    default that is not a key raises."""

    class _LookupAction(Action):
        def __init__(self, option_strings, dest, default=None, choices=None, **kwargs):
            if default is not None and default not in obj:
                raise ValueError(f"invalid default {default!r}; expected one of {tuple(obj)}")
            super().__init__(option_strings, dest, default=default,
                             choices=choices if choices is not None else tuple(obj), **kwargs)

        def __call__(self, parser, namespace, values, option_string=None):
            setattr(namespace, self.dest, values)

    return _LookupAction
