"""Resumable training: crash -> restore -> replay -> continue, exactly.
The port of ``sparkdl_tpu.reliability.supervisor``.

``finetune_classifier`` checkpoints and skips already-trained steps on
restart; :func:`resumable_finetune` closes the loop under a
:class:`~sparkdl_torch.reliability.retry.RetryPolicy`:

1. run an attempt; on a retryable failure, back off (full jitter);
2. the next attempt (a fresh loop: a new optimizer and new CUDA graphs)
   restores the newest *intact* checkpoint into the model and optimizer
   (``CheckpointManager.restore`` falls back past torn writes), replays
   the data iterator to the restored step, and continues;
3. per-step metrics are merged across attempts by step number: re-run
   steps (between the restored checkpoint and the crash point) recompute
   bitwise-identical values, so the recovered loss trajectory equals an
   uninterrupted run's exactly.

The model is trained in place, so an attempt that finds no checkpoint
starts from the weights (and optimizer state) the first attempt started
from: the supervisor keeps a host copy of both.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Callable, Iterable

import torch

from sparkdl_torch.observability import flight
from sparkdl_torch.reliability.retry import RetryPolicy

__all__ = ["resumable_finetune"]

_log = logging.getLogger(__name__)

#: Default classification for training crashes: retry anything except
#: clear programming errors (a preemption surfaces as RuntimeError /
#: OSError / a CUDA or NCCL error, all of which deserve a resume).
_DEFAULT_POLICY = dict(
    max_attempts=3,
    base_delay_s=0.05,
    max_delay_s=5.0,
    fatal=(TypeError, AssertionError),
)


def _host_copy(state: Any) -> Any:
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: _host_copy(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_host_copy(v) for v in state)
    return copy.deepcopy(state)


def resumable_finetune(
    model: torch.nn.Module,
    make_batches: "Callable[[], Iterable[dict]] | list[dict]",
    *,
    checkpoint_dir: str,
    retry: "RetryPolicy | None" = None,
    metrics_cb: "Callable[[dict], None] | None" = None,
    **finetune_kwargs: Any,
) -> "tuple[torch.nn.Module, list[dict]]":
    """``finetune_classifier`` that survives crashes mid-run.

    ``make_batches`` must be replayable: a zero-arg callable returning a
    fresh deterministic iterator (``lambda: batches_from_arrays(...)``)
    or a list of batches. A plain one-shot iterator cannot replay after
    a crash and is rejected loudly.

    ``checkpoint_dir`` is required: it is the recovery mechanism. Each
    attempt resumes from the newest intact checkpoint in it (none on the
    first attempt = start from scratch). ``retry`` defaults to 3
    attempts with full-jitter backoff against the process retry budget.
    The other keywords go to ``finetune_classifier`` (``partitioner``,
    ``checkpoint_every``, ``chain_steps``, ...).

    Returns ``(model, history)`` like ``finetune_classifier``;
    ``history`` is merged across attempts by step, so it covers the full
    trajectory though later attempts run only the tail.
    """
    if not checkpoint_dir:
        raise ValueError(
            "resumable_finetune requires checkpoint_dir — the checkpoint "
            "IS the recovery mechanism"
        )
    if not callable(make_batches) and not isinstance(
            make_batches, (list, tuple)):
        raise TypeError(
            "make_batches must be a zero-arg callable returning a fresh "
            "iterator, or a list of batches — a one-shot iterator cannot "
            f"be replayed after a crash (got {type(make_batches).__name__})"
        )
    if retry is None:
        retry = RetryPolicy(**_DEFAULT_POLICY)

    from sparkdl_torch.train.finetune import finetune_classifier

    initial = _host_copy(model.state_dict())
    optimizer = finetune_kwargs.get("optimizer")
    initial_opt = (_host_copy(optimizer.state_dict())
                   if optimizer is not None else None)

    #: step -> metrics entry, merged across attempts. Entries re-emitted
    #: by a replayed step overwrite with bitwise-identical values.
    entries: "dict[int, dict]" = {}

    def merge_cb(m: dict) -> None:
        entries[int(m["step"])] = m
        if metrics_cb is not None:
            metrics_cb(m)

    attempts = {"n": 0}

    def attempt():
        attempts["n"] += 1
        if attempts["n"] > 1:
            # the resume is a flight event: a postmortem shows the crash
            # -> restore -> replay chain, not just the final history
            flight.record_event(
                "supervisor.resume", attempt=attempts["n"],
                checkpoint_dir=str(checkpoint_dir),
                resumed_steps=len(entries),
            )
            _log.warning("resumable_finetune: attempt %d resuming from %s",
                         attempts["n"], checkpoint_dir)
            # the start the first attempt had; a checkpoint, where there
            # is one, overwrites it in the attempt
            model.load_state_dict(initial)
            if initial_opt is not None:
                optimizer.load_state_dict(initial_opt)
        batches = (make_batches() if callable(make_batches)
                   else make_batches)
        return finetune_classifier(
            model, batches,
            checkpoint_dir=checkpoint_dir,
            metrics_cb=merge_cb,
            **finetune_kwargs,
        )

    final_model, _ = retry.call(attempt, site="train.run")
    history = [entries[s] for s in sorted(entries)]
    return final_model, history
