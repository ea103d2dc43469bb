"""Small attribute and format utilities (cf. ``chemprop_tpu/cli/utils/utils.py``)."""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = ["pop_attr", "format_probability_string"]

_MISSING = object()


def pop_attr(o: object, attr: str, *args) -> Any | None:
    """``getattr`` and ``delattr`` in one step, as ``dict.pop`` is for keys:
    the default, where one is given, for a missing attribute."""
    if len(args) > 1:
        raise TypeError(f"expected at most 2 arguments, got {1 + len(args)}")
    default = args[0] if args else _MISSING
    try:
        val = getattr(o, attr)
    except AttributeError:
        if default is _MISSING:
            raise
        return default
    delattr(o, attr)
    return val


def _pop_attr(o: object, attr: str) -> Any:
    return pop_attr(o, attr)


def _pop_attr_d(o: object, attr: str, default: Any | None = None) -> Any | None:
    return pop_attr(o, attr, default)


def format_probability_string(test_preds: np.ndarray) -> np.ndarray:
    """The last axis of a probability array joined into ``,``-separated
    scientific-notation strings (a multiclass prediction's CSV cell)."""
    return np.apply_along_axis(
        lambda row: ",".join(f"{p:.6e}" for p in row), test_preds.ndim - 1, test_preds)
