from sparkdl_torch.dataframe.local import LocalDataFrame, Row
from sparkdl_torch.dataframe.adapters import (
    columns_of,
    is_spark_df,
    make_dataframe,
    transform_partitions,
)

__all__ = [
    "LocalDataFrame",
    "Row",
    "columns_of",
    "is_spark_df",
    "make_dataframe",
    "transform_partitions",
]
