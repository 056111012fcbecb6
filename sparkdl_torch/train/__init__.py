"""Training loops and fine-tune drivers: the port of ``sparkdl_tpu.train``.

The framework-provided equivalents of HorovodRunner's user training loop
for the two training configurations — BERT fine-tuning
(:func:`finetune_classifier`) and ResNet ImageNet-style training
(``train/vision.py``) — in PyTorch's idiom: the model is an ``nn.Module``
updated in place by a ``torch.optim`` optimizer, on one device. Data
parallelism over several cards comes with ROADMAP A8.
"""

from sparkdl_torch.train.finetune import (
    classification_train_step,
    finetune_classifier,
)

__all__ = ["classification_train_step", "finetune_classifier"]
