"""Fixture: env-pin POSITIVE — the replica pin read past resolve_pin."""

import os


def pinned_replicas():
    return int(os.environ.get("SPARKDL_TORCH_REPLICAS", "0"))  # VIOLATION: pin-managed
