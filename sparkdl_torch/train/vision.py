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

On the card the steps made here run as CUDA graphs, the counterpart of
the reference's ``jax.jit``: the first call for each (x, y) shape runs
the step eagerly (which creates the optimizer's state, e.g. SGD's
momentum buffers) and captures it; later calls copy x and y into the
graph's inputs and replay it. Parameters, running statistics and
optimizer state are updated in place by every replay, so the graph
carries them as the eager step does; a new capture follows a new shape,
changed optimizer settings or replaced parameters
(``runtime/dispatch.py``, :class:`GraphCache`). :func:`_make_step` is
the eager step: what the CPU runs, and the parity reference on the card.
"""

from __future__ import annotations

from typing import Callable

import torch

from sparkdl_torch.models.common import set_running_stats
from sparkdl_torch.runtime.dispatch import (
    GraphCache,
    optimizer_settings,
    require_capturable,
    storage_key,
)


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
    grad/update mechanics cannot drift apart: the eager step."""

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss, new_stats = loss_fn(x, y)
        loss.backward()
        optimizer.step()
        for name, stats in (new_stats or {}).items():
            set_running_stats(getattr(module, name), stats)
        return loss.detach()

    step.graph_key = lambda: (optimizer_settings(optimizer),
                              storage_key(module))
    return step


def _graphed(step: Callable, optimizer: torch.optim.Optimizer,
             path: str) -> Callable:
    """``step`` as a CUDA graph per (x, y) shape on the card, eager on the
    CPU; ``graphed.graphs`` is its :class:`GraphCache`."""
    graphs = GraphCache(path)

    def graphed(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            return step(x, y)
        require_capturable(optimizer, path)
        return graphs(step, (x, y), step.graph_key())

    graphed.graphs = graphs
    return graphed


def resnet50_fused_loss_fn(module: torch.nn.Module, *,
                           num_classes: int = 1000,
                           dtype=torch.bfloat16) -> Callable:
    """``loss_fn(x, y) -> (loss, new_batch_stats)`` through
    :func:`models.resnet_fused.resnet50_fused_forward` (classification
    head: the loss needs probabilities)."""
    from sparkdl_torch.models.resnet_fused import resnet50_fused_forward

    def loss_fn(x, y):
        (_, probs), new_stats = resnet50_fused_forward(
            module, x, train=True, num_classes=num_classes,
            include_top=True, dtype=dtype)
        return _nll_from_probs(probs, y), new_stats

    return loss_fn


def make_resnet50_fused_train_step(
    module: torch.nn.Module, optimizer: torch.optim.Optimizer, *,
    num_classes: int = 1000, dtype=torch.bfloat16,
) -> Callable:
    """Same contract as :func:`make_vision_train_step` for a
    :class:`~sparkdl_torch.models.resnet.ResNet50`, but through
    :func:`models.resnet_fused.resnet50_fused_forward`, whose 1x1 convs run
    the fused GEMM + BN-stats kernel. Always the classification head (the
    loss needs probabilities)."""
    loss_fn = resnet50_fused_loss_fn(module, num_classes=num_classes,
                                     dtype=dtype)
    return _graphed(_make_step(module, loss_fn, optimizer), optimizer,
                    "train_resnet_fused")


def make_vision_train_step(model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer) -> Callable:
    """``step(x, y) -> loss`` for a BatchNorm CNN: one SGD (or any
    ``optimizer``) step of ``model`` and its running statistics, in place;
    a CUDA graph per (x, y) shape on the card."""
    return _graphed(_make_step(model, vision_loss_fn(model), optimizer),
                    optimizer, "train_vision")
