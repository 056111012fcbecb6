"""Backend dispatch: run a per-partition row transform on any DataFrame.

Transformers are written once, as a partition function
``fn(iter[dict]) -> iter[dict]``. This module runs that function over:

  * LocalDataFrame    — in-process, partition by partition
  * pandas.DataFrame  — treated as a single partition
  * pyarrow.Table     — treated as a single partition
  * pyspark DataFrame — via ``mapInPandas`` so the model executes inside
    the executors, next to their GPUs (pyspark optional)

pandas, pyarrow and pyspark are imported only when a frame of theirs is
passed in.
"""

from __future__ import annotations

import sys
from typing import Callable, Iterable, Iterator

from sparkdl_torch.dataframe.local import LocalDataFrame


def _instance_of(df, module: str, attr: str) -> bool:
    """isinstance against a class of an optional package, without
    importing the package when the caller never did."""
    mod = sys.modules.get(module)
    return mod is not None and isinstance(df, getattr(mod, attr))


def is_spark_df(df) -> bool:
    return _instance_of(df, "pyspark.sql", "DataFrame")


def make_dataframe(rows, num_partitions: int | None = None) -> LocalDataFrame:
    return LocalDataFrame.from_rows(rows, num_partitions)


def transform_partitions(
    df,
    fn: Callable[[Iterator[dict]], Iterable[dict]],
    output_schema: "list[tuple[str, str]] | None" = None,
):
    """Apply ``fn`` per partition, returning a DataFrame of the same backend.

    ``output_schema`` is a list of (name, spark_ddl_type) for the *added*
    columns; it is required for the pyspark backend (mapInPandas needs a
    schema) and ignored for local backends.
    """
    if isinstance(df, LocalDataFrame):
        return df.mapPartitions(fn)
    if _instance_of(df, "pandas", "DataFrame"):
        import pandas as pd

        return pd.DataFrame(list(fn(iter(df.to_dict("records")))))
    if _instance_of(df, "pyarrow", "Table"):
        import pyarrow as pa

        return pa.Table.from_pylist(list(fn(iter(df.to_pylist()))))
    if is_spark_df(df):
        return _transform_spark(df, fn, output_schema)
    raise TypeError(f"unsupported DataFrame type {type(df)}")


def _transform_spark(df, fn, output_schema):
    """pyspark path: ship ``fn`` to executors via mapInPandas.

    Each executor partition becomes an iterator of pandas chunks; they are
    flattened to row dicts, run through the same partition function the
    local backends use, and re-assembled into pandas frames.
    """
    if output_schema is None:
        raise ValueError("output_schema is required for the pyspark backend")
    import pandas as pd
    from pyspark.sql.types import StructType, _parse_datatype_string

    out_schema = StructType(list(df.schema.fields))
    for name, ddl in output_schema:
        out_schema = out_schema.add(name, _parse_datatype_string(ddl))

    def run(chunks: Iterator[pd.DataFrame]) -> Iterator[pd.DataFrame]:
        def rows() -> Iterator[dict]:
            for chunk in chunks:
                yield from chunk.to_dict("records")

        out_rows = []
        for r in fn(rows()):
            out_rows.append(r)
            if len(out_rows) >= 1024:
                yield pd.DataFrame(out_rows)
                out_rows = []
        if out_rows:
            yield pd.DataFrame(out_rows)

    return df.mapInPandas(run, schema=out_schema)
