"""Type converters for Params: validating conversion of user-supplied
values with clear errors at set-time rather than failures deep inside
transform()."""

from __future__ import annotations

from typing import Any


class SparkDLTypeConverters:
    @staticmethod
    def toString(value: Any) -> str:
        if isinstance(value, str):
            return value
        raise TypeError(f"expected str, got {type(value).__name__}")

    @staticmethod
    def toInt(value: Any) -> int:
        if isinstance(value, bool):
            raise TypeError("expected int, got bool")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        raise TypeError(f"expected int, got {value!r}")

    @staticmethod
    def toBoolean(value: Any) -> bool:
        if isinstance(value, bool):
            return value
        raise TypeError(f"expected bool, got {value!r}")

    @staticmethod
    def toFloat(value: Any) -> float:
        if isinstance(value, bool):
            raise TypeError("expected float, got bool")
        if isinstance(value, (int, float)):
            return float(value)
        raise TypeError(f"expected float, got {value!r}")

    @staticmethod
    def toDevice(value: Any) -> str:
        """'cuda' or 'cpu': where a transformer runs its model."""
        name = SparkDLTypeConverters.toString(value)
        if name not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
        return name
