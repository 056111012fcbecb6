"""Classification fine-tuning (the BERT-base fine-tune configuration and
friends): the port of ``sparkdl_tpu.train.finetune``.

One optimizer step per batch on the model's device: forward, softmax
cross-entropy, backward, ``optimizer.step()``. The model is updated in
place; the default optimizer is ``torch.optim.AdamW(lr, weight_decay=wd,
eps=1e-8)`` over all parameters, the update ``optax.adamw`` makes
(decoupled decay, eps outside the square root).

On the card every dispatch is a CUDA graph, the counterpart of the
reference's jitted step: ``chain_steps=1`` replays a one-step graph per
batch shape, ``chain_steps=K`` one graph of K steps
(:func:`~sparkdl_torch.runtime.dispatch.chain_carry`). On the CPU the same
steps run eagerly. Per-step metrics are read back asynchronously, one
dispatch later (``runtime/completion.py``), as the reference reads them.

Input readahead (``input_prefetch``, ``autotune``) runs the batch source
through the ingest pipeline (sparkdl_torch/ingest), as the JAX loop does.
The JAX loop's options that have no counterpart in the port yet keep
their names and raise ``NotImplementedError`` naming their ROADMAP item:
``mesh``/``partitioner`` (A8 partition) and ``checkpoint_dir`` (A8
checkpoint).
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from sparkdl_torch.observability.registry import registry
from sparkdl_torch.observability.tracing import span
from sparkdl_torch.reliability.faults import fault_point
from sparkdl_torch.runtime.completion import AsyncFetcher
from sparkdl_torch.runtime.dispatch import (
    ChainPolicy,
    calibrate_dispatch_gap,
    chain_carry,
    optimizer_settings,
    record_dispatch,
    require_capturable,
    shape_key,
    storage_key,
)

_NOT_PORTED = "not ported to sparkdl_torch yet (ROADMAP {item})"

_METRICS = None


def _train_metrics():
    """(steps counter, examples counter, step-time histogram), made once."""
    global _METRICS
    if _METRICS is None:
        _METRICS = (
            registry().counter("sparkdl_train_steps_total",
                               "optimizer steps taken"),
            registry().counter("sparkdl_train_examples_total",
                               "examples consumed by training"),
            registry().histogram("sparkdl_train_step_seconds",
                                 "train step wall time (dispatch + sync)"),
        )
    return _METRICS


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long())


def classification_train_step(model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer) -> Callable:
    """``step(batch) -> {"loss", "accuracy"}`` (0-d tensors on the model's
    device, detached): one optimizer step of ``model`` in place, eagerly.
    ``batch`` is a dict of tensors on that device with ``labels`` plus
    whatever ``model(**inputs) -> logits`` consumes. ``step.graph_key()``
    is what a graph of it depends on besides the batch shapes: the
    optimizer's settings and the model's storage."""

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

    step.graph_key = lambda: (optimizer_settings(optimizer),
                              storage_key(model))
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
    ``AdamW(learning_rate, weight_decay=weight_decay, eps=1e-8)`` (with
    ``capturable=True`` on the card) — pass any ``torch.optim`` optimizer
    over the model's parameters. On the card its step runs inside CUDA
    graphs: an Adam-family optimizer with ``capturable=False`` raises
    before the first step, and one whose step cannot be captured for
    another reason raises at its first capture, naming the path.

    ``chain_steps`` fuses K optimizer steps into ONE device dispatch (one
    CUDA graph of K steps on the card, :func:`chain_carry`): same-shape
    batches are grouped K at a time; a shape change flushes the pending
    group unchained, and so does the stream's tail. The loss/accuracy
    trajectory in ``history`` stays per step and in order, and the steps
    are ``chain_steps=1``'s (bitwise on the CPU; on the card wherever the
    kernels are deterministic); host-side work (``metrics_cb``, registry
    updates) happens once per dispatch. None = auto: K from the measured
    step time against the dispatch gap (``ChainPolicy(max_chain=32)``,
    calibrated on the model's device before the loop); 1 (default) = one
    dispatch per step.

    ``history`` holds one ``{"loss", "accuracy", "step_time_s", "step"}``
    per step (``step`` counts from 1); ``metrics_cb`` is called with each
    entry as it lands. Metric values are read asynchronously: each
    dispatch's copy to the host starts when it is enqueued and is
    collected one dispatch later. ``step_time_s`` is a dispatch's wall
    time over its K steps: from the batches' transfer to the device
    finishing the dispatch.

    ``input_prefetch`` is the input iterator's host-side readahead depth
    (sparkdl_torch/ingest): a background producer keeps that many batches
    ready ahead of the step loop, so a slow ``batches`` source overlaps
    the device step instead of serializing with it. The batch stream —
    order and values — is exactly the source's. None = auto
    (``SPARKDL_TORCH_PREFETCH`` pin, else 2; a live autotuner knob when
    ``autotune`` resolves on, ``SPARKDL_TORCH_AUTOTUNE`` deciding for
    None); 0 disables readahead (strictly consumer-pulled); an explicit
    depth pins.
    """
    if chain_steps is not None and chain_steps < 1:
        raise ValueError(f"chain_steps must be >= 1, got {chain_steps}")
    if mesh is not None or partitioner is not None:
        raise NotImplementedError(
            "mesh= / partitioner= (data- and model-parallel placement) is "
            + _NOT_PORTED.format(item="A8 partition"))
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpoint_dir (save and resume) is "
            + _NOT_PORTED.format(item="A8 checkpoint"))
    from sparkdl_torch import ingest
    from sparkdl_torch.ingest.pipeline import resolve_pin

    feed_depth, feed_pinned, _ = resolve_pin(
        input_prefetch, "SPARKDL_TORCH_PREFETCH", 2, what="input_prefetch")
    dev = _device_of(model)
    on_card = dev.type == "cuda"
    if optimizer is None:
        # capturable: the step count stays on the card, so the eager step
        # and every graph of it run the same update kernels
        optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate,
                                      weight_decay=weight_decay, eps=1e-8,
                                      capturable=on_card)
    elif on_card:
        require_capturable(optimizer, "train")
    chained = chain_carry(classification_train_step(model, optimizer))
    policy = ChainPolicy(
        max_chain=chain_steps if chain_steps is not None else 32)
    if chain_steps is None:
        # auto mode: calibrate before the loop, not inside it
        policy.gap_s = calibrate_dispatch_gap(device=dev)
    # host-side readahead between the batch source and the step loop;
    # transfer=identity: the step loop puts each batch on the device
    input_pipe = None
    if feed_depth > 0:
        input_pipe = ingest.Pipeline(batches, name="finetune").prefetch(
            feed_depth, transfer=lambda b: b, pinned=feed_pinned)
        if ingest.autotune_enabled(autotune):
            input_pipe.autotune(True)
        batches = input_pipe
    steps_total, examples_total, step_seconds = _train_metrics()
    history: list[dict] = []
    host_step = 0
    # each dispatch's metrics start their copy to the host at once and are
    # collected one dispatch later, behind the next one
    fetcher = AsyncFetcher(window=2, path="train")
    #: (ticket, wall_s, k, base_step, n_examples) awaiting collection
    deferred: "list[tuple]" = []

    def collect(limit: int) -> None:
        # resolve deferred metric reads down to ``limit`` in flight, in
        # submission order: the trajectory never reorders
        while len(deferred) > limit:
            ticket, wall, k, base, n_examples = deferred.pop(0)
            for j, metrics in enumerate(ticket.result()):
                entry = {key: float(v) for key, v in metrics.items()}
                entry["step_time_s"] = wall / k
                entry["step"] = base + j + 1
                steps_total.inc()
                examples_total.inc(n_examples)
                step_seconds.observe(entry["step_time_s"])
                history.append(entry)
                if metrics_cb is not None:
                    metrics_cb(entry)

    def dispatch(group: "list[dict]") -> None:
        # K steps (K = len(group)), one dispatch
        nonlocal host_step
        fault_point("dispatch")
        k = len(group)
        n_examples = len(next(iter(group[0].values())))
        with span("dispatch.chain" if k > 1 else "train.step", path="train",
                  step=host_step, k=k, examples=k * n_examples):
            t0 = time.perf_counter()
            staged = [{key: torch.as_tensor(v).to(dev, non_blocking=True)
                       for key, v in b.items()} for b in group]
            metrics = chained(staged)
            if on_card:
                # the wall stays an honest device time for the policy,
                # as the reference's block on the step count
                torch.cuda.current_stream(dev).synchronize()
            wall = time.perf_counter() - t0
        record_dispatch("train", k, wall)
        policy.record(wall, k)
        deferred.append((fetcher.submit(metrics), wall, k, host_step,
                         n_examples))
        host_step += k
        collect(fetcher.window - 1)

    pending: "list[dict]" = []
    pending_key = None
    try:
        for batch in batches:
            if chain_steps == 1:
                dispatch([batch])
                continue
            key = shape_key(batch)
            if pending and key != pending_key:
                # ragged boundary (an epoch's tail batch): a chain holds
                # one shape, so the pending group flushes unchained
                for b in pending:
                    dispatch([b])
                pending = []
            pending.append(batch)
            pending_key = key
            k_target = (chain_steps if chain_steps is not None
                        else policy.chain_len())
            if len(pending) >= k_target:
                dispatch(pending)
                pending = []
        for b in pending:  # stream tail: no one-off K
            dispatch([b])
    except BaseException:
        # the metrics of steps already dispatched still land in history
        # (best effort: a dead device fails this too)
        try:
            collect(0)
        except BaseException:
            pass
        raise
    finally:
        if input_pipe is not None:
            input_pipe.close()
    collect(0)  # drain the async window: history complete
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
