from sparkdl_torch.transformers.keras_image import KerasImageFileTransformer
from sparkdl_torch.transformers.keras_tensor import KerasTransformer
from sparkdl_torch.transformers.named_image import (
    DeepImageFeaturizer,
    DeepImagePredictor,
)
from sparkdl_torch.transformers.text_generator import DeepTextGenerator
from sparkdl_torch.transformers.tf_image import TFImageTransformer
from sparkdl_torch.transformers.tf_tensor import TFTransformer

__all__ = ["DeepImageFeaturizer", "DeepImagePredictor", "DeepTextGenerator",
           "KerasImageFileTransformer", "KerasTransformer", "TFImageTransformer",
           "TFTransformer"]
