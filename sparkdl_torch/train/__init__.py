"""Training loops and fine-tune drivers: the port of ``sparkdl_tpu.train``.

The framework-provided equivalents of HorovodRunner's user training loop
for the two training configurations — BERT fine-tuning
(:func:`finetune_classifier`) and ResNet ImageNet-style training
(``train/vision.py``) — in PyTorch's idiom: the model is an ``nn.Module``
updated in place by a ``torch.optim`` optimizer. Across the cards of a
``TorchRunner`` job ``finetune_classifier`` trains over any mesh the
partitioner lays (``partition/``): dp and ZeRO over fsdp, Megatron's tp,
ring attention's sp, experts over ep and pipeline stages over pp.
"""

from sparkdl_torch.train.finetune import (
    classification_train_step,
    finetune_classifier,
)

__all__ = ["classification_train_step", "finetune_classifier"]
