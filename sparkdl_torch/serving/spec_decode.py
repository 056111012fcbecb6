"""Draft proposers + greedy acceptance for speculative decoding.

Speculative decoding splits one decode step into
*propose* (cheap, host-side or small-model) and *verify* (one target-
model dispatch scoring the whole k-token draft span at once): the
target model's per-token cost is dominated by reading weights + KV
cache, so verifying k positions costs barely more than one, and every
accepted draft token is a model pass the engine never dispatches.

Under GREEDY decoding acceptance is exact, not probabilistic: the
verify pass yields the argmax continuation at every draft position, a
draft token is accepted iff it EQUALS the argmax its prefix implies,
and the first mismatch position already carries the corrected token —
so the accepted stream is bitwise-identical to one-token-at-a-time
decode no matter what the proposer suggested
(:func:`greedy_accept`). A bad draft costs wasted verify positions,
never a wrong token.

This module is the PROPOSE half. A draft source is anything with
``propose(context, k) -> list[int]`` (``context`` = prompt + tokens
produced so far, ids only — proposers never touch device state):

* :class:`NGramDraftSource` — prompt-lookup decoding: find the latest
  earlier occurrence of the context's trailing n-gram and propose the
  tokens that followed it. Zero extra weights; strong on repetitive
  spans (code, structured output, greedy loops).
* :class:`PrefixCacheDraftSource` — reads the radix trie
  (:meth:`~sparkdl_torch.serving.prefix_cache.PrefixCache.suggest`):
  when the context is a prefix of a cached longer prompt, the cached
  continuation is the draft. Zero extra weights.
* :class:`ChainedDraftSource` — first non-empty proposal wins; the
  engine default chains trie -> n-gram.

A learned draft MODEL plugs in through the same hook: wrap its decode
loop in ``propose`` and hand it to
``ContinuousGPTEngine(draft_source=...)`` — the engine only ever sees
token ids, so draft-model choice is a proposer detail, not an engine
change.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def greedy_accept(drafts: Sequence[int],
                  outputs: Sequence[int]) -> int:
    """Accepted draft-token count under exact greedy verification.

    ``outputs[j]`` is the target model's argmax at draft position ``j``
    (given the real context plus drafts ``[:j]``); ``drafts[j]`` is
    accepted iff it equals ``outputs[j]`` and every earlier draft was
    accepted. Returns ``m``: ``outputs[:m+1]`` are the real greedy
    tokens this verify produced (the +1 is the bonus token — the first
    output is unconditionally real, and after ``m`` accepted drafts
    ``outputs[m]`` is the correction/continuation).
    """
    m = 0
    for d, o in zip(drafts, outputs):
        if int(d) != int(o):
            break
        m += 1
    return m


class NGramDraftSource:
    """Propose the continuation of the latest earlier occurrence of the
    context's trailing n-gram (prompt-lookup decoding).

    Tries n-gram sizes ``max_n`` down to ``min_n`` and takes the first
    (longest-context) hit, preferring the MOST RECENT earlier
    occurrence that still has ``k`` continuation tokens available —
    recency tracks the local pattern a greedy model is currently
    extending, and the availability constraint keeps repetitive runs
    (where the freshest occurrence sits at the very tail) proposing
    FULL drafts instead of one-token stubs: a constant or periodic
    span then drafts its own cycle, the high-acceptance case
    speculation exists for.
    """

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(
                f"need 1 <= min_n <= max_n, got {min_n}..{max_n}")
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, context: np.ndarray, k: int) -> "list[int]":
        ctx = np.asarray(context)
        for n in range(min(self.max_n, len(ctx) - 1), self.min_n - 1, -1):
            tail = ctx[-n:]
            # windows[i] == ctx[i:i+n]; match anywhere strictly before
            # the trailing occurrence itself
            win = np.lib.stride_tricks.sliding_window_view(ctx, n)
            hits = np.flatnonzero((win[:-1] == tail).all(axis=1))
            if hits.size:
                full = hits[hits + n + k <= len(ctx)]
                start = int(full[-1] if full.size else hits[-1]) + n
                return [int(t) for t in ctx[start:start + k]]
        return []


class PrefixCacheDraftSource:
    """Drafts from the radix prefix cache: cached prompts that EXTEND
    the current context donate their continuation (ids only — see
    ``PrefixCache.suggest``)."""

    def __init__(self, prefix_cache):
        self._cache = prefix_cache

    def propose(self, context: np.ndarray, k: int) -> "list[int]":
        return self._cache.suggest(
            tuple(int(t) for t in context), k)


class ChainedDraftSource:
    """First source with a non-empty proposal wins."""

    def __init__(self, *sources):
        if not sources:
            raise ValueError("need at least one draft source")
        self.sources = sources

    def propose(self, context: np.ndarray, k: int) -> "list[int]":
        for s in self.sources:
            got = s.propose(context, k)
            if got:
                return got
        return []


def default_draft_source(prefix_cache=None,
                         max_n: int = 3) -> ChainedDraftSource:
    """The engine default: radix-trie continuations first (exact cached
    prompts beat statistics), n-gram self-lookup as fallback."""
    ngram = NGramDraftSource(max_n=max_n)
    if prefix_cache is None:
        return ChainedDraftSource(ngram)
    return ChainedDraftSource(
        PrefixCacheDraftSource(prefix_cache), ngram)
