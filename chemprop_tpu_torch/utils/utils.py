"""Case-insensitive string enums (cf. reference ``chemprop/utils/utils.py``)."""

from __future__ import annotations

from enum import StrEnum


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
