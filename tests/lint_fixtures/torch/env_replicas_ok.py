"""Fixture: env-pin NEGATIVE — the replica pin read through resolve_pin,
as the autoscaler reads it."""

from sparkdl_torch.ingest.pipeline import resolve_pin


def pinned_replicas(replicas=None):
    value, pinned, _ = resolve_pin(
        replicas, "SPARKDL_TORCH_REPLICAS", 0, what="replicas")
    return value if pinned else None
