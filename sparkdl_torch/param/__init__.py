from sparkdl_torch.param.shared_params import (
    HasBatchSize,
    HasInputCol,
    HasOutputCol,
    Param,
    Params,
    Transformer,
)
from sparkdl_torch.param.converters import SparkDLTypeConverters

__all__ = [
    "HasBatchSize",
    "HasInputCol",
    "HasOutputCol",
    "Param",
    "Params",
    "SparkDLTypeConverters",
    "Transformer",
]
