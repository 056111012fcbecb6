"""Model input preprocessing on tensors.

The keras.applications ``preprocess_input`` modes the named-model
registry uses: 'tf' (Inception/Xception), 'caffe' (ResNet/VGG), 'torch'.
Inputs are RGB float tensors in [0, 255] with shape (..., H, W, 3);
outputs are what each model family expects.
"""

from __future__ import annotations

import torch

_CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)
_TORCH_MEAN = (0.485, 0.456, 0.406)
_TORCH_STD = (0.229, 0.224, 0.225)


def preprocess_tf(x: torch.Tensor) -> torch.Tensor:
    """Scale [0,255] -> [-1, 1]."""
    return x / 127.5 - 1.0


def preprocess_caffe(x: torch.Tensor) -> torch.Tensor:
    """RGB -> BGR, subtract ImageNet channel means (no scaling)."""
    mean = torch.tensor(_CAFFE_MEAN_BGR, dtype=x.dtype, device=x.device)
    return x.flip(-1) - mean


def preprocess_torch(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(_TORCH_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(_TORCH_STD, dtype=x.dtype, device=x.device)
    return (x / 255.0 - mean) / std


def preprocess_identity(x: torch.Tensor) -> torch.Tensor:
    return x


PREPROCESSORS = {
    "tf": preprocess_tf,
    "caffe": preprocess_caffe,
    "torch": preprocess_torch,
    "identity": preprocess_identity,
}
