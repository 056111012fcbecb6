from sparkdl_torch.transformers.named_image import (
    DeepImageFeaturizer,
    DeepImagePredictor,
)

__all__ = ["DeepImageFeaturizer", "DeepImagePredictor"]
