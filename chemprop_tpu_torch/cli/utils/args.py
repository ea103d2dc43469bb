"""Argument-parsing helpers (cf. ``chemprop_tpu/cli/utils/args.py``)."""

from __future__ import annotations

import functools

__all__ = ["bounded", "uppercase", "lowercase", "activation_function_argument"]


def bounded(lo: float | None = None, hi: float | None = None):
    """A decorator of argparse ``type=`` callables that raises where the
    parsed value lies below ``lo`` or above ``hi``; one of them is needed."""
    if lo is None and hi is None:
        raise ValueError("at least one of lo/hi must be given")

    def decorator(f):
        @functools.wraps(f)
        def wrapper(*a, **kw):
            x = f(*a, **kw)
            if lo is not None and x < lo:
                raise ValueError(f"parsed value below {lo}: {x}")
            if hi is not None and x > hi:
                raise ValueError(f"parsed value above {hi}: {x}")
            return x

        return wrapper

    return decorator


def uppercase(x: str) -> str:
    return x.upper()


def lowercase(x: str) -> str:
    return x.lower()


def _coerce(s: str):
    s = s.strip()
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def activation_function_argument(argument: str):
    """One ``--activation-args`` item: a positional literal (``0.1``) or a
    keyword (``negative_slope=0.1`` -> ``{"negative_slope": 0.1}``), its
    value read as a bool, an int, a float or else a string."""
    key, sep, value = argument.partition("=")
    if not sep:
        return _coerce(key)
    return {key.strip(): _coerce(value)}
