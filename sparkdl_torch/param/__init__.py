from sparkdl_torch.param.shared_params import (
    Estimator,
    HasBatchSize,
    HasInputCol,
    HasLabelCol,
    HasOutputCol,
    Param,
    Params,
    Pipeline,
    PipelineModel,
    Transformer,
)
from sparkdl_torch.param.converters import SparkDLTypeConverters

__all__ = [
    "Estimator",
    "HasBatchSize",
    "HasInputCol",
    "HasLabelCol",
    "HasOutputCol",
    "Param",
    "Params",
    "Pipeline",
    "PipelineModel",
    "SparkDLTypeConverters",
    "Transformer",
]
