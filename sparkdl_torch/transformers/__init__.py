from sparkdl_torch.transformers.named_image import (
    DeepImageFeaturizer,
    DeepImagePredictor,
)
from sparkdl_torch.transformers.text_generator import DeepTextGenerator

__all__ = ["DeepImageFeaturizer", "DeepImagePredictor", "DeepTextGenerator"]
