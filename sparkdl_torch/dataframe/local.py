"""A minimal partitioned DataFrame for running the pipeline without Spark.

Every Transformer runs against this local backend (partitioned rows,
eager) so single-host GPU inference needs no JVM. Partitioning is real:
transformers batch within, never across, partitions, so the ragged-tail
and bucketing behaviour matches what Spark executors would see.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Sequence


class Row(dict):
    """Dict with attribute access, standing in for pyspark.sql.Row."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e


class LocalDataFrame:
    """List-of-rows DataFrame with explicit partitions."""

    def __init__(self, partitions: Sequence[Sequence[dict]]):
        self._partitions = [list(map(Row, p)) for p in partitions]

    # -- construction -----------------------------------------------------
    @staticmethod
    def from_rows(rows: Iterable[dict], num_partitions: int | None = None) -> "LocalDataFrame":
        rows = list(rows)
        n = max(1, num_partitions or 1)
        if n == 1:
            return LocalDataFrame([rows])
        size = (len(rows) + n - 1) // n if rows else 0
        parts = [rows[i * size : (i + 1) * size] for i in range(n)] if size else [[] for _ in range(n)]
        return LocalDataFrame(parts)

    @staticmethod
    def from_pandas(pdf, num_partitions: int | None = None) -> "LocalDataFrame":
        return LocalDataFrame.from_rows(pdf.to_dict("records"), num_partitions)

    # -- pyspark-like surface --------------------------------------------
    @property
    def columns(self) -> list[str]:
        for p in self._partitions:
            if p:
                return list(p[0].keys())
        return []

    def count(self) -> int:
        return sum(len(p) for p in self._partitions)

    def collect(self) -> list[Row]:
        return [r for p in self._partitions for r in p]

    def take(self, n: int) -> list[Row]:
        return self.collect()[:n]

    def first(self) -> Row | None:
        rows = self.take(1)
        return rows[0] if rows else None

    def select(self, *cols: str) -> "LocalDataFrame":
        return LocalDataFrame(
            [[{c: r[c] for c in cols} for r in p] for p in self._partitions]
        )

    def drop(self, *cols: str) -> "LocalDataFrame":
        keep = [c for c in self.columns if c not in cols]
        return self.select(*keep)

    def withColumnRenamed(self, old: str, new: str) -> "LocalDataFrame":
        def rename(r: dict) -> dict:
            return {new if k == old else k: v for k, v in r.items()}

        return LocalDataFrame([[rename(r) for r in p] for p in self._partitions])

    def repartition(self, n: int) -> "LocalDataFrame":
        return LocalDataFrame.from_rows(self.collect(), n)

    def limit(self, n: int) -> "LocalDataFrame":
        return LocalDataFrame.from_rows(self.collect()[:n], len(self._partitions))

    def toPandas(self):
        import pandas as pd

        return pd.DataFrame(self.collect())

    @property
    def num_partitions(self) -> int:
        return len(self._partitions)

    # -- execution hooks used by transformers ----------------------------
    def mapPartitions(
        self, fn: Callable[[Iterator[dict]], Iterable[dict]]
    ) -> "LocalDataFrame":
        return LocalDataFrame([list(fn(iter(p))) for p in self._partitions])

    def __repr__(self) -> str:
        return (
            f"LocalDataFrame[{', '.join(self.columns)}]"
            f"(rows={self.count()}, partitions={self.num_partitions})"
        )
