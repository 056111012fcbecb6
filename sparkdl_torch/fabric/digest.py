"""Prefix→host digests: the state that makes routing cache-aware.

The radix prefix cache made placement a *performance* decision:
the host that already holds a prompt's prefix blocks prefills only the
uncached tail of the prompt, so a router that knows *where the
blocks live* beats any load balancer on shared-prefix traffic. Shipping
the tries themselves would be absurd; instead each host publishes a
**digest** — the chained :func:`~sparkdl_torch.serving.prefix_cache.chain_hash`
values of its cached block-aligned prompt prefixes, most-recently-used
first, bounded (``PrefixCache.block_hashes``). The router hashes an
incoming prompt's own block-aligned prefixes ONCE
(:func:`prompt_block_hashes`, O(L) via the same hash chain) and counts
the longest consecutive run present in each host's digest
(:func:`match_blocks`): that count *is* the affinity signal, in blocks.

Digests are advisory, never authoritative: a stale entry (the host
evicted the blocks since publishing) costs one cold prefill on the
"wrong" host — exactly what a digest-less router would have paid —
never a failure. That is why staleness degrades to plain load routing
instead of needing consistency machinery (tested in
tests/test_torch_fabric_digest.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time

from sparkdl_torch.serving.prefix_cache import DIGEST_ROOT, chain_hash

__all__ = [
    "HostDigest",
    "hrw_preferred_host",
    "hrw_score",
    "match_blocks",
    "path_anchor",
    "placement_key",
    "prompt_block_hashes",
    "session_key",
]


# -- rendezvous (HRW) placement ------------------------------------------------
# Every router must map the same key to the same host with NO shared
# state. Rendezvous hashing gives that for free: score
# every (key, host) pair with a seedless hash and take the max — hosts
# agree everywhere, and removing one host only remaps the keys that
# scored highest on it (1/N churn, vs a modulo ring's near-total
# reshuffle). blake2b keeps it PYTHONHASHSEED-independent like the
# digest chain itself.

def hrw_score(key: int, host_id: str) -> int:
    """Rendezvous weight of ``host_id`` for 64-bit ``key``."""
    return int.from_bytes(
        hashlib.blake2b(
            int(key).to_bytes(8, "little", signed=False)
            + host_id.encode("utf-8"),
            digest_size=8).digest(),
        "little")


def hrw_preferred_host(key: int, host_ids) -> "str | None":
    """The fleet-wide agreed host for ``key``: max rendezvous score,
    host_id as the total-order tie-break (scores collide only by hash
    accident; the lexicographic fallback keeps even that deterministic).
    None for an empty candidate set."""
    best = None
    for hid in host_ids:
        cand = (hrw_score(key, hid), hid)
        if best is None or cand > best:
            best = cand
    return best[1] if best is not None else None


def placement_key(tokens, block_size: int) -> int:
    """The 64-bit key routers hash a prompt under. The FIRST block's
    chain hash when the prompt fills one (so every continuation of a
    conversation — whose prefixes share that block — lands on the same
    preferred host), else the chain hash of the whole usable prompt
    (short prompts have no shared-prefix structure to exploit; any
    stable key spreads them)."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    usable = len(tokens) - 1  # the final token always prefills
    if usable >= block_size:
        toks = tuple(int(t) for t in tokens[:block_size])
    else:
        toks = tuple(int(t) for t in tokens)
    return chain_hash(DIGEST_ROOT, toks)


def path_anchor(tokens, block_size: int) -> int:
    """First-block chain hash of a FULL block-aligned path (migration
    uses this to pick a parked session's new home). Unlike
    :func:`placement_key` there is no trailing-token discount: the
    tokens ARE the cached path. Equal to the placement_key of any
    longer next-turn prompt extending the same conversation, which is
    exactly why migrated sessions land where their next turn routes."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    return chain_hash(DIGEST_ROOT, tuple(int(t) for t in tokens[:block_size]))


def session_key(session) -> int:
    """Deterministic 64-bit key for a sticky-session id — the salt that
    keeps session placement independent of prompt placement. Survives
    router restarts and LRU pressure because it is pure arithmetic on
    the id the client already resends every turn."""
    return int.from_bytes(
        hashlib.blake2b(
            b"sparkdl-session:" + str(session).encode("utf-8"),
            digest_size=8).digest(),
        "little")


def prompt_block_hashes(tokens, block_size: int,
                        max_blocks: int = 64) -> "list[int]":
    """Chained hashes of ``tokens``' block-aligned prefixes: entry ``i``
    covers tokens ``[0, (i+1)*block_size)``. The LAST prompt token never
    participates (the cache holds K/V, not logits — the same
    ``tokens[:-1]`` rule ``PrefixCache.match`` applies), so the deepest
    hash covers at most ``len(tokens) - 1`` tokens. ``max_blocks``
    bounds router-side work on very long prompts; affinity past 64
    blocks adds nothing a scheduler can act on."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    usable = len(tokens) - 1  # the final token always prefills
    out: "list[int]" = []
    h = DIGEST_ROOT
    for i in range(min(usable // block_size, max_blocks)):
        h = chain_hash(
            h, tuple(int(t)
                     for t in tokens[i * block_size:(i + 1) * block_size]))
        out.append(h)
    return out


@dataclasses.dataclass
class HostDigest:
    """One host's published prefix digest, as the router holds it.

    ``hashes`` is the membership set; ``version`` is the host's own
    monotonic publish counter (debugging/telemetry — the router always
    replaces wholesale on refresh); ``fetched_at`` stamps staleness."""

    host_id: str
    block_size: int
    hashes: frozenset
    version: int = 0
    fetched_at: float = dataclasses.field(default_factory=time.monotonic)

    @classmethod
    def from_snapshot(cls, snap: "dict | None") -> "HostDigest | None":
        """Build from the dict form ``engine.prefix_digest()`` /
        ``GET /fabric/digest`` returns (None passes through: a dense
        host publishes no digest)."""
        if not snap:
            return None
        return cls(
            host_id=str(snap["host_id"]),
            block_size=int(snap["block_size"]),
            hashes=frozenset(int(h) for h in snap["hashes"]),
            version=int(snap.get("version") or 0),
        )

    def apply_delta(self, delta: "dict | None") -> "HostDigest | None":
        """Fold a ``prefix_digest_delta`` payload into this snapshot,
        returning the advanced copy — the ≤KBs/sec path that replaces
        wholesale refresh at steady state. Three honest
        outcomes, all safe because digests are advisory:

        * advanced copy — contiguous delta (``since == version``);
        * ``self`` unchanged — stale replay (``version`` ≤ ours): the
          journal re-sent history we already hold, applying it twice
          would double-remove, skipping it is idempotent;
        * ``None`` — gap (the host's journal rolled past us, or its
          block grid changed): the caller falls back to one wholesale
          refresh, exactly what it did every cycle before deltas.
        """
        if not delta:
            return None
        version = int(delta.get("version") or 0)
        if int(delta.get("since") or -1) != self.version:
            return self if version <= self.version else None
        if int(delta.get("block_size") or 0) != self.block_size:
            return None
        added = frozenset(int(h) for h in delta.get("added") or ())
        removed = frozenset(int(h) for h in delta.get("removed") or ())
        return dataclasses.replace(
            self, hashes=(self.hashes - removed) | added,
            version=version, fetched_at=time.monotonic())

    def age_s(self, now: "float | None" = None) -> float:
        return (now if now is not None else time.monotonic()) \
            - self.fetched_at


def match_blocks(prompt_hashes: "list[int]",
                 digest: "HostDigest | None") -> int:
    """Longest CONSECUTIVE run of ``prompt_hashes`` (from the start)
    present in ``digest`` — the estimated cached-prefix depth, in
    blocks. Consecutive-from-zero mirrors what the radix match can
    actually reuse: a hole at block ``i`` makes every deeper block
    unreachable. 0 for hosts without a digest."""
    if digest is None:
        return 0
    n = 0
    for h in prompt_hashes:
        if h not in digest.hashes:
            break
        n += 1
    return n
