"""Shared helpers of the text transformers: a bounded LRU for per-process
model caches, and a cheap fingerprint of a state dict to key them by.

(``DeepTextFeaturizer``, the BERT transformer of ``sparkdl_tpu``, is not
ported yet: ROADMAP A6.)
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import torch


class _LruCache(OrderedDict):
    """Tiny bounded LRU so long-lived executors hosting many models don't
    keep every built model (and its device memory) for the process
    lifetime."""

    def __init__(self, maxsize: int):
        super().__init__()
        self.maxsize = maxsize

    def get(self, key, default=None):
        if key in self:
            self.move_to_end(key)
            return self[key]
        return default

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.move_to_end(key)
        while len(self) > self.maxsize:
            self.popitem(last=False)


def _fingerprint(state_dict: dict) -> str:
    """A key for a state dict without copying it to the host: the dict's
    identity, every tensor's name, shape, dtype and device, and the first
    16 elements of the largest tensor (random weights there, where a small
    tensor such as a bias may be all zeros). The identity guards against
    two dicts alike in all of that; the elements against an id reused
    after the first dict was freed."""
    items = sorted(state_dict.items())
    meta = [(k, tuple(t.shape), str(t.dtype), str(t.device)) for k, t in items]
    h = hashlib.blake2b(repr((id(state_dict), meta)).encode(), digest_size=16)
    if items:
        big = max((t for _, t in items), key=lambda t: t.numel())
        h.update(big.detach().reshape(-1)[:16].to("cpu", torch.float32)
                 .numpy().tobytes())
    return h.hexdigest()
