"""Case-insensitive string enums and small helpers (cf.
``chemprop_tpu/utils/utils.py``)."""

from __future__ import annotations

import os
from enum import StrEnum
from typing import Callable, Iterable, Sequence, TypeVar

T = TypeVar("T")
U = TypeVar("U")


class EnumMapping(StrEnum):
    """A StrEnum with case-insensitive lookup via ``get``."""

    @classmethod
    def get(cls, name: "str | EnumMapping") -> "EnumMapping":
        if isinstance(name, cls):
            return name
        try:
            return cls[str(name).upper().replace("-", "_")]
        except KeyError:
            raise KeyError(
                f"Unsupported {cls.__name__} member! got: {name!r}; "
                f"expected one of: {', '.join(m.name for m in cls)}"
            ) from None

    @classmethod
    def keys(cls) -> list[str]:
        return [m.name.lower() for m in cls]

    @classmethod
    def values(cls) -> list[str]:
        return [m.value for m in cls]


def parallel_execute(
    fn: Callable[..., U],
    items: Sequence,
    n_workers: int = 0,
    chunksize: int | None = None,
) -> list[U]:
    """``fn`` over ``items``: in this process for ``n_workers <= 1``, else in
    a pool of that many forked processes (at most the machine's cores)."""
    if n_workers is None or n_workers <= 1:
        return [fn(item) for item in items]
    import multiprocessing as mp

    n_workers = min(n_workers, os.cpu_count() or 1)
    if chunksize is None:
        chunksize = max(1, len(items) // (n_workers * 4))
    with mp.get_context("fork").Pool(n_workers) as pool:
        return list(pool.map(fn, items, chunksize=chunksize))


def batched(iterable: Iterable[T], n: int) -> Iterable[list[T]]:
    """Lists of ``n`` items of ``iterable`` in order, the last one shorter."""
    batch: list[T] = []
    for item in iterable:
        batch.append(item)
        if len(batch) == n:
            yield batch
            batch = []
    if batch:
        yield batch


def create_and_call_object(
    cls, call_args: tuple = (), call_kwargs: dict | None = None,
    init_args: tuple = (), init_kwargs: dict | None = None,
):
    """Make an instance of ``cls`` and call it at once (for parallel calls of
    callable objects)."""
    return cls(*init_args, **(init_kwargs or {}))(*call_args, **(call_kwargs or {}))


def pretty_shape(shape) -> str:
    """A shape as ``'10 x 4'``."""
    return " x ".join(map(str, shape))
