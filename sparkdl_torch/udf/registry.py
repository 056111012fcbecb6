"""Process-wide UDF registry: a copy of ``sparkdl_tpu.udf.registry``.

The reference registers UDFs into the Spark SQL function registry through
the JVM ([U: python/sparkdl/utils/jvmapi.py], SURVEY.md 2.14/2.20). This
framework keeps its own registry so registered functions are usable from
every backend: ``applyUDF`` runs one over any supported DataFrame, and when
a live SparkSession is importable the function is *also* registered with
Spark SQL (pandas UDF) so ``SELECT my_udf(image) FROM t`` works unchanged.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

_LOCK = threading.Lock()
_REGISTRY: dict[str, Callable[[Any], Any]] = {}


def registerUDF(name: str, fn: Callable[[Any], Any], spark_session=None) -> None:
    """Register ``fn`` (one value -> one value) under ``name``.

    Re-registering a name replaces it (matches Spark SQL semantics).
    """
    with _LOCK:
        _REGISTRY[name] = fn
    session = spark_session or _active_spark_session()
    if session is not None:
        _register_with_spark(session, name, fn)


def getUDF(name: str) -> Callable[[Any], Any]:
    with _LOCK:
        if name not in _REGISTRY:
            raise KeyError(
                f"no UDF named {name!r}; registered: {sorted(_REGISTRY)}"
            )
        return _REGISTRY[name]


def listUDFs() -> list[str]:
    with _LOCK:
        return sorted(_REGISTRY)


def applyUDF(name: str, dataset, inputCol: str, outputCol: str):
    """Run a registered UDF over a DataFrame column (any backend)."""
    from sparkdl_torch.dataframe import transform_partitions

    fn = getUDF(name)

    def partition_fn(rows):
        for r in rows:
            out = dict(r)
            try:
                out[outputCol] = fn(r[inputCol])
            except KeyError:
                raise
            except Exception:
                out[outputCol] = None
            yield out

    return transform_partitions(dataset, partition_fn, [(outputCol, "array<float>")])


def _active_spark_session():
    try:
        from pyspark.sql import SparkSession

        return SparkSession.getActiveSession()
    except Exception:
        return None


def _register_with_spark(session, name: str, fn: Callable) -> None:
    """Best-effort Spark SQL registration (row-at-a-time python UDF)."""
    try:
        from pyspark.sql.functions import udf as spark_udf
        from pyspark.sql.types import ArrayType, FloatType

        wrapped = spark_udf(
            lambda v: [float(x) for x in fn(v)], ArrayType(FloatType())
        )
        session.udf.register(name, wrapped)
    except Exception:  # pragma: no cover - requires a live Spark session
        import logging

        logging.getLogger(__name__).warning(
            "could not register UDF %r with Spark SQL", name, exc_info=True
        )
