"""Rank bodies for the port's multi-process tests (``TorchRunner`` jobs).

Kept apart from the test files so that a worker unpickling a job by
reference imports this module only: it imports numpy, torch and
``sparkdl_torch``, never jax or ``sparkdl_tpu`` (a worker must not).
"""

from __future__ import annotations

import os
import signal

import numpy as np

VOCAB = 64
GLOBAL_BATCH, LENGTH, STEPS = 16, 12, 4


def toy_batches(steps: int = STEPS, seed: int = 0) -> "list[dict]":
    """Global batches of the tiny-BERT toy task: the label is whether
    token 1 opens the sequence; half the rows right-padded."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ids = r.integers(2, VOCAB, (GLOBAL_BATCH, LENGTH)).astype(np.int64)
        labels = r.integers(0, 2, GLOBAL_BATCH).astype(np.int64)
        ids[:, 0] = labels
        mask = np.ones((GLOBAL_BATCH, LENGTH), np.int64)
        mask[GLOBAL_BATCH // 2:, LENGTH - 3:] = 0
        out.append({"input_ids": ids, "attention_mask": mask,
                    "labels": labels})
    return out


def local_shard(batches: "list[dict]", rank: int, world: int) -> "list[dict]":
    """Each global batch's rows of ``rank``: what that rank feeds."""
    n = GLOBAL_BATCH // world
    return [{k: v[rank * n:(rank + 1) * n] for k, v in b.items()}
            for b in batches]


def tiny_bert(state: dict):
    from sparkdl_torch.models.bert import BertConfig, BertForSequenceClassification

    m = BertForSequenceClassification(BertConfig.tiny(vocab_size=VOCAB),
                                      device="cpu")
    m.load_state_dict(state)
    return m


def partitioner(kind: str, world: int):
    from sparkdl_torch.partition import DataParallelPartitioner, make_mesh

    if kind == "zero":
        return DataParallelPartitioner(make_mesh(dp=1, fsdp=world),
                                       zero_axis="fsdp")
    return DataParallelPartitioner(make_mesh(dp=world))


def _opt(kind: str, model):
    import torch

    if kind == "sgd":
        return torch.optim.SGD(model.parameters(), lr=0.1)
    return None  # finetune_classifier's AdamW


def _run(state, kind, opt, rank, world, *, lr=1e-3, **kw):
    from sparkdl_torch.train import finetune_classifier

    model = tiny_bert(state)
    _, hist = finetune_classifier(
        model, local_shard(toy_batches(), rank, world), learning_rate=lr,
        optimizer=_opt(opt, model), partitioner=partitioner(kind, world), **kw)
    return model, [h["loss"] for h in hist]


def _bytes(axis: str) -> float:
    from sparkdl_torch.observability.registry import registry

    return registry().get("sparkdl_opt_state_bytes").labelled_values("axis")[axis]


def parity_job(state: dict, crash_dir: str, resume_dir: str) -> dict:
    """Rank body: the dp and ZeRO fine-tunes of the toy task, a ZeRO run
    with checkpoints that crashes at step 3 (its checkpoint resumed on
    one process by the test), and the resume of a one-process run's
    checkpoint under ZeRO on this world."""
    import torch.distributed as dist

    from sparkdl_torch.reliability.faults import inject

    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"world": world}
    _, out["sgd"] = _run(state, "dp", "sgd", rank, world)
    dp_model, out["dp"] = _run(state, "dp", "adamw", rank, world)
    out["dp_bytes"] = _bytes("replicated")
    zero_model, out["zero"] = _run(state, "zero", "adamw", rank, world)
    out["zero_bytes"] = _bytes("fsdp")
    out["zero_vs_dp_param"] = max(
        float((a - b).abs().max()) for a, b in
        zip(dp_model.parameters(), zero_model.parameters()))
    try:
        with inject("dispatch:RuntimeError@3"):
            _run(state, "zero", "adamw", rank, world,
                 checkpoint_dir=crash_dir, checkpoint_every=2)
    except RuntimeError as e:
        out["crash"] = str(e)
    _, out["resumed"] = _run(state, "zero", "adamw", rank, world,
                             checkpoint_dir=resume_dir, checkpoint_every=2)
    return out


def mesh4_job(state: dict) -> dict:
    """Rank body on 4 ranks: ZeRO on a dp=2 x fsdp=2 mesh (a reduce-scatter
    over fsdp, then an all-reduce over dp) and on the dp axis."""
    import torch.distributed as dist

    from sparkdl_torch.partition import DataParallelPartitioner, make_mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for axis in ("fsdp", "dp"):
        from sparkdl_torch.train import finetune_classifier

        _, hist = finetune_classifier(
            tiny_bert(state), local_shard(toy_batches(), rank, world),
            learning_rate=1e-3, partitioner=DataParallelPartitioner(
                make_mesh(dp=2, fsdp=2), zero_axis=axis))
        out[axis] = [h["loss"] for h in hist]
        out[axis + "_bytes"] = _bytes(axis)
    return out


def killed_job(state: dict, ckpt_dir: str, die_at: "int | None") -> dict:
    """Rank body: a ZeRO run checkpointing every step; with ``die_at``,
    rank 1 SIGKILLs itself once that step's checkpoint landed (every rank
    waited for it), as a preempted worker dies."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()

    def cb(entry):
        if die_at is None or entry["step"] != die_at or rank != 1:
            return
        import time

        from sparkdl_torch.checkpoint import latest_step

        deadline = time.monotonic() + 30
        while ((latest_step(ckpt_dir) or 0) < die_at
               and time.monotonic() < deadline):
            time.sleep(0.01)
        if (latest_step(ckpt_dir) or 0) < die_at:
            raise AssertionError(f"step {die_at}'s checkpoint never landed")
        os.kill(os.getpid(), signal.SIGKILL)

    from sparkdl_torch.train import finetune_classifier

    model = tiny_bert(state)
    _, hist = finetune_classifier(
        model, local_shard(toy_batches(), rank, world), learning_rate=1e-3,
        partitioner=partitioner("zero", world), checkpoint_dir=ckpt_dir,
        checkpoint_every=1, metrics_cb=cb)
    return {"losses": [h["loss"] for h in hist],
            "steps": [h["step"] for h in hist]}


def snapshot_job() -> dict:
    """Rank body: a counter only rank 1 has, rolled up over the group."""
    import torch.distributed as dist

    from sparkdl_torch.observability.registry import registry, snapshot_across_hosts

    registry().reset()
    rank = dist.get_rank()
    registry().counter("sparkdl_rollup_probe_total").inc(rank + 1)
    if rank == 1:
        registry().counter("sparkdl_rank1_only_total").inc(5)
    return snapshot_across_hosts()


def health_job() -> dict:
    from sparkdl_torch.observability.health import check_health, preflight

    report = check_health()
    preflight(rank=0)
    return {"ok": report.ok, "collective_ok": report.collective_ok,
            "count": report.process_count, "platform": report.platform}


def rank_info(scale: float = 1.0) -> dict:
    """Rank body: an all-reduce over the group."""
    import torch
    import torch.distributed as dist

    x = torch.ones(3) * (dist.get_rank() + 1) * scale
    dist.all_reduce(x)
    return {"rank": dist.get_rank(), "nprocs": dist.get_world_size(),
            "backend": dist.get_backend(), "sum": float(x.sum()),
            "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def imported_modules() -> "list[str]":
    """Rank body: every module the worker process has imported."""
    import sys

    return sorted(sys.modules)


def boom() -> None:
    raise RuntimeError("worker exploded")
