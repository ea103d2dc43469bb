"""Class registries and the constructor-filtering factory of the command
line (cf. ``chemprop_tpu/utils/registry.py``). ``PredictorRegistry``,
``AggregationRegistry``, ``LossFunctionRegistry`` and ``MetricRegistry`` are
``ClassRegistry``s: a key is looked up without regard to case, and a missing
one raises a ``KeyError`` that lists the keys."""

from __future__ import annotations

import inspect
from typing import Any, Generic, Iterable, TypeVar

T = TypeVar("T")


class ClassRegistry(dict, Generic[T]):
    """A ``{alias: class}`` mapping filled by the ``register`` decorator; the
    first alias becomes the class's ``alias``."""

    def register(self, alias: str | Iterable[str] | None = None):
        def decorator(cls: type[T]) -> type[T]:
            if alias is None:
                keys = [cls.__name__.lower()]
            elif isinstance(alias, str):
                keys = [alias]
            else:
                keys = list(alias)
            cls.alias = keys[0]
            for k in keys:
                self[k.lower()] = cls
            return cls

        return decorator

    def __getitem__(self, key: str) -> type[T]:
        try:
            return super().__getitem__(key.lower())
        except KeyError:
            raise KeyError(
                f"{key!r} is not registered; available: {sorted(self.keys())}"
            ) from None


class Factory:
    """``cls(*args, **kwargs)`` with the keyword arguments that ``cls``'s
    constructor does not take dropped, so that one namespace of command-line
    options serves many classes."""

    @staticmethod
    def build(cls: type[T], *args: Any, **kwargs: Any) -> T:
        sig = inspect.signature(cls)
        if any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values()):
            return cls(*args, **kwargs)
        accepted = {k: v for k, v in kwargs.items() if k in sig.parameters}
        return cls(*args, **accepted)
