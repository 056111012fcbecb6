"""Train steps for the CNN zoo (models with BatchNorm state): the port of
``sparkdl_tpu.train.vision``.

The zoo models return ``(features, probs)`` and carry BatchNorm running
statistics, so their supervised step differs from the stateless-encoder
step of ``train/finetune.py``: the loss comes from probabilities and the
running statistics move with every step. Each builder returns
``step(x, y) -> loss`` that updates the parameters (through a
``torch.optim`` optimizer), the running statistics and the optimizer's
state in place — PyTorch's idiom for the JAX package's pure step, whose
``donate`` option has no counterpart here. ``optax.sgd(lr, momentum=0.9)``
is ``torch.optim.SGD(params, lr, momentum=0.9)``: both take the first
gradient as the first momentum buffer.
"""

from __future__ import annotations

from typing import Callable

import torch

from sparkdl_torch.models.common import set_running_stats


def _nll_from_probs(probs: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The zoo models output probabilities; one NLL definition so the
    plain and fused paths stay numerically comparable."""
    logp = torch.log(torch.clamp(probs, min=1e-8))
    return -torch.gather(logp, 1, y.long()[:, None]).mean()


def vision_loss_fn(model: torch.nn.Module) -> Callable:
    """``loss_fn(x, y) -> (loss, new_batch_stats)`` over a zoo model's
    ``(features, probs)`` training forward. The module moves its own
    running statistics in its forward, so ``new_batch_stats`` is None."""

    def loss_fn(x, y):
        _, probs = model(x, train=True)
        return _nll_from_probs(probs, y), None

    return loss_fn


def _make_step(module: torch.nn.Module, loss_fn: Callable,
               optimizer: torch.optim.Optimizer) -> Callable:
    """One step definition for the plain and fused ResNet paths, so their
    grad/update mechanics cannot drift apart."""

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss, new_stats = loss_fn(x, y)
        loss.backward()
        optimizer.step()
        for name, stats in (new_stats or {}).items():
            set_running_stats(getattr(module, name), stats)
        return loss.detach()

    return step


def make_resnet50_fused_train_step(
    module: torch.nn.Module, optimizer: torch.optim.Optimizer, *,
    num_classes: int = 1000, dtype=torch.bfloat16,
) -> Callable:
    """Same contract as :func:`make_vision_train_step` for a
    :class:`~sparkdl_torch.models.resnet.ResNet50`, but through
    :func:`models.resnet_fused.resnet50_fused_forward`, whose 1x1 convs run
    the fused GEMM + BN-stats kernel. Always the classification head (the
    loss needs probabilities)."""
    from sparkdl_torch.models.resnet_fused import resnet50_fused_forward

    def loss_fn(x, y):
        (_, probs), new_stats = resnet50_fused_forward(
            module, x, train=True, num_classes=num_classes,
            include_top=True, dtype=dtype)
        return _nll_from_probs(probs, y), new_stats

    return _make_step(module, loss_fn, optimizer)


def make_vision_train_step(model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer) -> Callable:
    """``step(x, y) -> loss`` for a BatchNorm CNN: one SGD (or any
    ``optimizer``) step of ``model`` and its running statistics, in place."""
    return _make_step(model, vision_loss_fn(model), optimizer)
