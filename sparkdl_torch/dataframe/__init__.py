from sparkdl_torch.dataframe.local import LocalDataFrame, Row
from sparkdl_torch.dataframe.adapters import (
    is_spark_df,
    make_dataframe,
    transform_partitions,
)

__all__ = [
    "LocalDataFrame",
    "Row",
    "is_spark_df",
    "make_dataframe",
    "transform_partitions",
]
