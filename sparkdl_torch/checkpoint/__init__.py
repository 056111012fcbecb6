"""Framework-managed checkpoint/resume: the port of
``sparkdl_tpu.checkpoint``, on ``torch.distributed.checkpoint``.

Async saves of the full train state (model, optimizer, step) after a
synchronous host snapshot, coordinated across ranks, with a sha256
sidecar per landed step, and restores into the live state's tensors
(resharded when the world size or the sharding changed) for resume
after a crash, a preemption or a barrier-stage retry.
"""

from sparkdl_torch.checkpoint.manager import (
    CheckpointCorruptError,
    CheckpointManager,
    checkpoint_digest,
    latest_step,
    restore_matching,
    save_and_wait,
)

__all__ = [
    "CheckpointCorruptError",
    "CheckpointManager",
    "checkpoint_digest",
    "latest_step",
    "restore_matching",
    "save_and_wait",
]
