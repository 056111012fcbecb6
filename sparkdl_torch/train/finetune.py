"""Classification fine-tuning (the BERT-base fine-tune configuration and
friends): the port of ``sparkdl_tpu.train.finetune``.

One optimizer step per batch on the model's device: forward, softmax
cross-entropy, backward, ``optimizer.step()``. The model is updated in
place; the default optimizer is ``torch.optim.AdamW(lr, weight_decay=wd,
eps=1e-8)`` over all parameters, the update ``optax.adamw`` makes
(decoupled decay, eps outside the square root).

The JAX loop's options that have no counterpart in the port yet keep
their names and raise ``NotImplementedError`` naming their ROADMAP item:
``mesh``/``partitioner`` (A8 partition), ``checkpoint_dir`` (A8
checkpoint), ``chain_steps`` other than 1 (A4 CUDA graphs), and input
readahead (``input_prefetch`` > 0, ``autotune``; A4 ingest).
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

_NOT_PORTED = "not ported to sparkdl_torch yet (ROADMAP {item})"


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long())


def classification_train_step(model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer) -> Callable:
    """``step(batch) -> {"loss", "accuracy"}`` (0-d tensors on the model's
    device, detached): one optimizer step of ``model`` in place. ``batch``
    is a dict of tensors on that device with ``labels`` plus whatever
    ``model(**inputs) -> logits`` consumes."""

    def step(batch: dict) -> dict:
        labels = batch["labels"]
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        optimizer.zero_grad(set_to_none=True)
        logits = model(**inputs)
        loss = softmax_cross_entropy(logits, labels)
        loss.backward()
        optimizer.step()
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return step


def _device_of(model: torch.nn.Module) -> torch.device:
    for p in model.parameters():
        return p.device
    raise ValueError("the model has no parameters to train")


def finetune_classifier(
    model: torch.nn.Module,
    batches: "Iterator[dict] | list[dict]",
    *,
    learning_rate: float = 2e-5,
    weight_decay: float = 0.01,
    optimizer: "torch.optim.Optimizer | None" = None,
    mesh=None,
    partitioner=None,
    metrics_cb: "Callable[[dict], None] | None" = None,
    checkpoint_dir: "str | None" = None,
    chain_steps: "int | None" = 1,
    input_prefetch: "int | None" = None,
    autotune: "bool | None" = None,
) -> "tuple[torch.nn.Module, list[dict]]":
    """Run the fine-tune loop over ``batches``; returns (model, history).

    ``model(**inputs) -> logits`` is updated in place; each batch is a
    dict of arrays (numpy or tensors) with ``labels``, moved to the
    model's device before its step. ``optimizer`` overrides the default
    ``AdamW(learning_rate, weight_decay=weight_decay, eps=1e-8)`` — pass
    any ``torch.optim`` optimizer over the model's parameters.

    ``history`` holds one ``{"loss", "accuracy", "step_time_s", "step"}``
    per step, in order (``step`` counts from 1); ``metrics_cb`` is called
    with each entry as it lands. ``step_time_s`` is host time from the
    batch's transfer to the step's metrics on the host (the read waits for
    the device).
    """
    if chain_steps is None or chain_steps != 1:
        if chain_steps is not None and chain_steps < 1:
            raise ValueError(f"chain_steps must be >= 1, got {chain_steps}")
        raise NotImplementedError(
            "chaining several steps into one dispatch (chain_steps != 1) is "
            + _NOT_PORTED.format(item="A4 CUDA graphs"))
    if mesh is not None or partitioner is not None:
        raise NotImplementedError(
            "mesh= / partitioner= (data- and model-parallel placement) is "
            + _NOT_PORTED.format(item="A8 partition"))
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpoint_dir (save and resume) is "
            + _NOT_PORTED.format(item="A8 checkpoint"))
    if (input_prefetch is not None and input_prefetch > 0) or autotune:
        raise NotImplementedError(
            "input readahead (input_prefetch > 0, autotune) is "
            + _NOT_PORTED.format(item="A4 ingest")
            + "; input_prefetch=None or 0 runs without readahead")
    dev = _device_of(model)
    if optimizer is None:
        optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate,
                                      weight_decay=weight_decay, eps=1e-8)
    step_fn = classification_train_step(model, optimizer)
    history: list[dict] = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        staged = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                  for k, v in batch.items()}
        metrics = step_fn(staged)
        entry = {k: float(v) for k, v in metrics.items()}
        entry["step_time_s"] = time.perf_counter() - t0
        entry["step"] = i + 1
        history.append(entry)
        if metrics_cb is not None:
            metrics_cb(entry)
    return model, history


def batches_from_arrays(
    arrays: "dict[str, np.ndarray]", batch_size: int, *, epochs: int = 1,
    seed: int = 0, drop_remainder: bool = True,
) -> Iterator[dict]:
    """Shuffled minibatch iterator over same-length arrays (tiny-data path,
    the KerasImageFileEstimator-style in-memory fit)."""
    n = len(next(iter(arrays.values())))
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        end = n - n % batch_size if drop_remainder else n
        for i in range(0, end, batch_size):
            idx = order[i:i + batch_size]
            yield {k: v[idx] for k, v in arrays.items()}
