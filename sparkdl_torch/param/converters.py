"""Type converters for Params: validating conversion of user-supplied
values (model files, column name maps, channel orders) with clear errors
at set-time rather than failures deep inside transform()."""

from __future__ import annotations

import os
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

    @staticmethod
    def toExistingFilePath(value: Any) -> str:
        path = SparkDLTypeConverters.toString(value)
        if not os.path.isfile(path):
            raise ValueError(f"model file does not exist: {path}")
        return path

    @staticmethod
    def toColumnToTensorNameMap(value: Any) -> dict[str, str]:
        return SparkDLTypeConverters._toStrStrMap(value, "column -> tensor name")

    @staticmethod
    def toTensorNameToColumnMap(value: Any) -> dict[str, str]:
        return SparkDLTypeConverters._toStrStrMap(value, "tensor name -> column")

    @staticmethod
    def _toStrStrMap(value: Any, what: str) -> dict[str, str]:
        if not isinstance(value, dict) or not value:
            raise TypeError(f"expected a non-empty dict for {what}, got {value!r}")
        out = {}
        for k, v in value.items():
            if not isinstance(k, str) or not isinstance(v, str):
                raise TypeError(f"{what} entries must be str->str, got {k!r}: {v!r}")
            out[k] = v
        return out

    @staticmethod
    def toChannelOrder(value: Any) -> str:
        v = SparkDLTypeConverters.toString(value)
        if v not in ("RGB", "BGR", "L"):
            raise ValueError(f"channel order must be RGB, BGR or L, got {v!r}")
        return v

    @staticmethod
    def supportedNameConverter(supported: list[str]):
        def convert(value: Any) -> str:
            v = SparkDLTypeConverters.toString(value)
            if v not in supported:
                raise ValueError(f"{v!r} not in supported set {sorted(supported)}")
            return v

        return convert

    @staticmethod
    def toKerasLoss(value: Any) -> str:
        return SparkDLTypeConverters.toString(value)

    @staticmethod
    def toKerasOptimizer(value: Any) -> str:
        return SparkDLTypeConverters.toString(value)
