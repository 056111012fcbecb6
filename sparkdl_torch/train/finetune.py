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

Across ranks (``TorchRunner``, ``partition/``) each rank feeds its local
shard of the global batch and the partitioner writes the step's
collectives: the gradient all-reduce, or for ZeRO the reduce-scatter,
the sharded update and the all-gather, inside the same CUDA graph.
``checkpoint_dir`` saves the train state asynchronously every
``checkpoint_every`` steps and at the end, and resumes from it
(``checkpoint/``, driven across crashes by
``reliability.supervisor.resumable_finetune``).
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


def _inner(optimizer) -> torch.optim.Optimizer:
    """The torch optimizer a :class:`ShardedOptimizer` wraps (or itself)."""
    return getattr(optimizer, "optimizer", optimizer)


@torch.no_grad()
def materialize_optimizer_state(optimizer) -> None:
    """Create ``optimizer``'s per-parameter state now, shaped and placed
    as after its first step, so that a checkpoint can be restored into
    it in place (or its bytes measured) before any step. One step at lr
    0 over zero gradients makes the tensors (the parameters do not move:
    the update is scaled by lr); every state tensor is then zeroed.

    The values are placeholders, not a fresh optimizer's (NAdam's
    ``mu_product`` starts at 1, SGD's momentum buffer at the first
    gradient): restore into them, or clear ``optimizer.state``, before
    stepping."""
    opt = _inner(optimizer)
    if opt.state:
        return
    params = [p for g in opt.param_groups for p in g["params"]]
    saved = [p.grad for p in params]
    for p in params:
        p.grad = torch.zeros_like(p)
    lrs = [g["lr"] for g in opt.param_groups]
    for g in opt.param_groups:
        g["lr"] = torch.zeros_like(g["lr"]) if isinstance(g["lr"], torch.Tensor) else 0.0
    try:
        opt.step()
    finally:
        for g, lr in zip(opt.param_groups, lrs):
            g["lr"] = lr
        for p, g in zip(params, saved):
            p.grad = g
    for st in opt.state.values():
        for v in st.values():
            if isinstance(v, torch.Tensor):
                v.zero_()


def train_state(model: torch.nn.Module, optimizer, step: int) -> dict:
    """The checkpointed train state: ``{"model": state_dict, "optim":
    {param name: {state key: tensor}}, "step": int64 tensor}``. Every
    tensor is the live one (a restore writes into it in place); a
    :class:`~sparkdl_torch.partition.ShardedOptimizer` gives the state of
    a parameter sharded across ranks as a DTensor over this rank's slice,
    so a checkpoint reshards across world sizes and layouts."""
    by_name = getattr(optimizer, "state_by_name", None)
    if by_name is not None:
        optim = by_name()
    else:
        optim = {name: dict(optimizer.state[p])
                 for name, p in model.named_parameters()
                 if optimizer.state.get(p)}
    return {"model": model.state_dict(), "optim": optim,
            "step": torch.tensor(int(step), dtype=torch.int64)}


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
    checkpoint_every: int = 100,
    keep_checkpoints: int = 3,
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

    ``partitioner`` owns every placement decision (partition/): where
    the model and each batch live, and the collectives of the step.
    Default: :class:`~sparkdl_torch.partition.DataParallelPartitioner`
    over ``mesh`` (or every rank) when a ``torch.distributed`` process
    group is up or ``mesh`` is given, else a
    :class:`~sparkdl_torch.partition.SingleDevicePartitioner` on the
    model's device. Under a data-parallel partitioner each rank's
    ``batches`` are its local shard of the global batch, and the history
    holds the global batch's metrics (the mean over the ranks). Pass
    ``DataParallelPartitioner(make_mesh(dp=4, fsdp=2), zero_axis="fsdp")``
    for ZeRO-sharded optimizer state (per-rank optimizer memory ~1/fsdp,
    measured into ``sparkdl_opt_state_bytes{axis}``). A mesh whose ``tp``
    axis is larger than 1 (``SPMDPartitioner(make_mesh(dp=2, tp=2),
    BERT_RULES)``) takes a model built under it, holding its
    tensor-parallel slices (``models/convert.py`` ``shard_state_dict``):
    its layers' all-reduces run inside the step's graph beside the
    gradient all-reduce over the data axes, and each data shard's ``tp``
    ranks feed the same rows. The other model axes train the same way:
    ``sp`` (a model with ring attention; each sp rank feeds its block of
    the same rows' tokens), ``ep`` (expert stacks split by ``GPT_RULES``;
    name ``ep`` in ``batch_axes`` for each ep rank to feed its own rows)
    and ``pp`` (``parallel.pipeline_apply`` stages; a rule ``P("pp")`` on
    the stacked stage parameters keeps their optimizer state one stage a
    rank), and a ``tp`` slice may have its state sharded on fsdp too
    (``SPMDPartitioner(make_mesh(fsdp=2, tp=2), VIT_RULES)``); each step
    stays one CUDA graph on the card. The loss trajectory is invariant
    across partitioners up to float reduction order.

    With ``checkpoint_dir`` set, the full train state is saved
    asynchronously every ``checkpoint_every`` steps (at a dispatch
    boundary; a save is forced once a full interval passed since the
    last one landed, so chaining can thin the cadence but never disable
    it) and once at the end, keeping the newest ``keep_checkpoints``;
    an existing checkpoint there is restored first and the steps it
    covers are skipped in ``batches``.

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
    from sparkdl_torch import ingest
    from sparkdl_torch.ingest.pipeline import resolve_pin
    from sparkdl_torch.partition import (
        DataParallelPartitioner,
        SingleDevicePartitioner,
    )
    if partitioner is None:
        if _process_group_up():
            # this rank's device: its card under NCCL, else the CPU
            partitioner = DataParallelPartitioner(mesh=mesh)
        elif mesh is not None:
            partitioner = DataParallelPartitioner(mesh=mesh,
                                                  device=_device_of(model))
        else:
            partitioner = SingleDevicePartitioner(_device_of(model))
    elif mesh is not None and partitioner.mesh != mesh:
        raise ValueError(
            "pass either mesh= or partitioner= (the partitioner owns "
            "its mesh), not both")
    feed_depth, feed_pinned, _ = resolve_pin(
        input_prefetch, "SPARKDL_TORCH_PREFETCH", 2, what="input_prefetch")
    model = partitioner.shard_params(model)
    dev = partitioner.device
    on_card = dev.type == "cuda"
    if optimizer is None:
        # capturable: the step count stays on the card, so the eager step
        # and every graph of it run the same update kernels
        optimizer = torch.optim.AdamW(model.parameters(), lr=learning_rate,
                                      weight_decay=weight_decay, eps=1e-8,
                                      capturable=on_card)
    elif on_card:
        require_capturable(optimizer, "train")
    optimizer = partitioner.shard_opt_state(optimizer, model)
    ckpt = None
    resume_step = 0
    if checkpoint_dir is not None:
        from sparkdl_torch.checkpoint import CheckpointManager

        ckpt = CheckpointManager(checkpoint_dir, keep=keep_checkpoints,
                                 save_interval_steps=checkpoint_every)
        if ckpt.latest_step() is not None:
            # into the live tensors, before any capture: a graph replays
            # the storage it captured. The optimizer's state is made to
            # be written over; a fresh run keeps it lazy (its first step
            # makes it as the optimizer's class does)
            materialize_optimizer_state(optimizer)
            try:
                state = ckpt.restore(
                    template=train_state(model, optimizer, 0))
            except BaseException:
                _inner(optimizer).state.clear()
                ckpt.close()
                raise
            resume_step = int(state["step"])
            if hasattr(optimizer, "reload_shards"):
                optimizer.reload_shards()  # the restored parameters
    # the ZeRO memory win (or its absence) is a measured number:
    # sparkdl_opt_state_bytes{axis} per rank, set once the state exists
    # (at init after a restore, else after the first step)
    bytes_unset = True

    def export_opt_bytes() -> None:
        nonlocal bytes_unset
        if bytes_unset and _inner(optimizer).state:
            partitioner.export_opt_state_bytes(_inner(optimizer))
            bytes_unset = False

    export_opt_bytes()
    chained = chain_carry(partitioner.wrap_step(
        classification_train_step(model, optimizer)))
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
    host_step = resume_step
    last_saved = resume_step
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
        export_opt_bytes()
        record_dispatch("train", k, wall)
        policy.record(wall, k)
        deferred.append((fetcher.submit(metrics), wall, k, host_step,
                         n_examples))
        host_step += k
        maybe_checkpoint()
        collect(fetcher.window - 1)

    def maybe_checkpoint() -> None:
        # at the dispatch boundary: the state is current here
        nonlocal last_saved
        if ckpt is None:
            return
        state = train_state(model, optimizer, host_step)
        if ckpt.save(host_step, state):
            last_saved = host_step
        elif host_step - last_saved >= checkpoint_every:
            # chain boundaries (step = K, 2K, ...) may never align with
            # the interval: force once a full interval has passed
            if ckpt.save(host_step, state, force=True):
                last_saved = host_step

    pending: "list[dict]" = []
    pending_key = None
    try:
        for i, batch in enumerate(batches):
            if i < resume_step:  # deterministic replay on resume
                continue
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
    else:
        collect(0)  # drain the async window: history complete
        if (ckpt is not None and host_step > resume_step
                and last_saved != host_step):
            # the final state lands whatever the interval
            ckpt.save(host_step, train_state(model, optimizer, host_step),
                      force=True)
    finally:
        if input_pipe is not None:
            input_pipe.close()
        if ckpt is not None:
            ckpt.close()
    return model, history


def _process_group_up() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


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
