"""Exceptions (cf. ``chemprop_tpu/exceptions.py``)."""

from __future__ import annotations


class InvalidShapeError(ValueError):
    def __init__(self, var_name: str, received, expected):
        message = (
            f"arg '{var_name}' has incorrect shape! "
            f"got: `{' x '.join(map(str, received))}`, "
            f"expected: `{' x '.join(map(str, expected))}`"
        )
        super().__init__(message)
