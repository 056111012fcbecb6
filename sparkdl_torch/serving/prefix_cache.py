"""Radix-style prefix cache over paged KV blocks.

Chat/RAG traffic shares prompt prefixes (system prompts, retrieved
documents): the K/V a prefill computes for those tokens is a pure
function of the token ids before them, so a second request with the
same prefix can reuse the first one's blocks and prefill only its
suffix — prefill FLOPs drop in proportion to the hit rate, the dominant
serving win for shared-prompt traffic.

Structure: a trie keyed by **full-block token tuples** (``block_size``
tokens per edge), so a path from the root spells out an exact token
prefix and each node owns the physical block holding that span's K/V.
A node additionally carries *partial entries* — tail blocks whose
prompt filled only ``q < block_size`` slots — which are shared by
**copy-on-write**: a matching request gathers the partial block's
content into its own private prefill cache and re-installs it into a
block IT owns, so the donor (possibly still decoding into that very
block past offset ``q``) is never written by a sibling.

Lifetime: matched blocks are refcounted through
:class:`~sparkdl_torch.serving.kv_blocks.KVBlockPool`; a registered block
whose refcount drops to zero stays resident as an evictable cache entry
rather than returning to the free list. Eviction is LRU over
refcount-zero **leaves** (evicting a parent before its children would
leave an unmatchable dangling suffix), invoked by the engine when
allocation comes up short. Unregistered blocks free immediately at
refcount zero.

Tiered mode: when the engine attaches a
:class:`~sparkdl_torch.serving.kv_tiers.TieredKVStore`, the trie becomes
a **3-level hierarchy**. A node's ``tier`` says where its block lives:
``"device"`` nodes hold a live pool block; ``"host"``/``"disk"`` nodes
are *parked* — their raw block bytes moved to the cheap tier, their
``block_id`` invalid, their trie position (and token key) intact so the
next turn can find them. One eviction policy covers all levels:
:meth:`demote` pages cold device leaves out (device→host, cascading
host→disk, dropping from disk last), refcounted shares and partial-
holding nodes never park, and :meth:`restore_path` pages a parked
prefix back in ahead of :meth:`match` so a turn resume costs one H2D
copy instead of a re-prefill. A parked node's children are always
parked too (children park before parents; restore revives parents
before children), which is what makes dropping a parked subtree safe.

All bookkeeping runs under the engine lock — host-side scheduling,
no device work. Spine metrics: ``sparkdl_prefix_hits_total`` /
``sparkdl_prefix_misses_total`` count prompt TOKENS served from cache
vs prefilled, ``sparkdl_prefix_evictions_total`` counts blocks evicted.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

from sparkdl_torch.observability.registry import registry
from sparkdl_torch.serving.kv_blocks import KVBlockPool
from sparkdl_torch.serving.kv_tiers import TieredKVStore

_M_HITS = registry().counter(
    "sparkdl_prefix_hits_total",
    "prompt tokens served from cached KV prefixes (prefill skipped)")
_M_MISSES = registry().counter(
    "sparkdl_prefix_misses_total",
    "prompt tokens prefilled from scratch")
_M_EVICTIONS = registry().counter(
    "sparkdl_prefix_evictions_total",
    "cached prefix blocks evicted (LRU, refcount-0 leaves)")


#: chain_hash root: the hash of the empty prefix (any fixed value works;
#: it only needs to agree across hosts, which a constant guarantees)
DIGEST_ROOT = 0


def chain_hash(parent: int, tokens: "tuple[int, ...]") -> int:
    """Stable hash of one more block of prefix tokens chained onto the
    parent prefix's hash — the prefix→host digest entry.

    Chaining makes hashing a prompt's every block-aligned prefix O(L)
    instead of O(L²/bs), and ``blake2b`` (not Python ``hash``) keeps the
    value identical across processes and hosts regardless of
    ``PYTHONHASHSEED`` — the property that lets a router compare a local
    prompt's hashes against digests other hosts published."""
    h = hashlib.blake2b(digest_size=8)
    h.update(int(parent).to_bytes(8, "little", signed=False))
    for t in tokens:
        h.update(int(t).to_bytes(4, "little", signed=True))
    return int.from_bytes(h.digest(), "little")


@dataclasses.dataclass
class _Partial:
    """A cached tail block holding ``len(tokens) < block_size`` prompt
    tokens (shared copy-on-write, never in a sharer's block table)."""

    tokens: tuple
    block_id: int
    parent: Any
    stamp: int


class _Node:
    """One full cached block: ``key`` is its ``block_size``-token span,
    the root-to-node path spells the whole prefix."""

    __slots__ = ("key", "block_id", "parent", "children", "partials",
                 "stamp", "tier", "digest_hash")

    def __init__(self, key, block_id, parent, stamp):
        self.key = key
        self.block_id = block_id
        self.parent = parent
        self.children: "dict[tuple, _Node]" = {}
        self.partials: "list[_Partial]" = []
        self.stamp = stamp
        #: "device" | "host" | "disk" — parked nodes keep their trie
        #: position but hold no pool block (block_id is invalid)
        self.tier = "device"
        #: this prefix's chained digest entry, fixed at creation (the
        #: path never changes while the node exists) — what the digest
        #: journal publishes and block_hashes() reads back
        self.digest_hash = (DIGEST_ROOT if parent is None
                            else chain_hash(parent.digest_hash, key))


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Longest cached prefix of one prompt. ``full_blocks`` go straight
    into the slot's block table (shared, read-only — decode never
    writes columns below the prompt length); ``partial_block`` is
    gathered then re-installed copy-on-write. All matched blocks are
    already refcounted; release through :meth:`PrefixCache.release`
    (full) and a single release of the partial once copied."""

    full_blocks: "list[int]"
    partial_block: "Optional[int]"
    partial_tokens: int
    hit_tokens: int


class PrefixCache:
    """Token-trie prefix index over a :class:`KVBlockPool`."""

    def __init__(self, pool: KVBlockPool,
                 tiers: "Optional[TieredKVStore]" = None,
                 journal_limit: int = 1024):
        self.pool = pool
        self.block_size = pool.block_size
        self._clock = itertools.count(1)
        self._root = _Node(None, -1, None, 0)
        #: block_id -> _Node | _Partial for every trie-registered block
        #: whose bytes are DEVICE-resident (parked nodes leave this map)
        self._registered: "dict[int, Any]" = {}
        #: host/disk tiers for parked nodes (None = flat single-tier)
        self._tiers = tiers
        #: monotonic digest-membership version: bumps once per trie node
        #: added or removed (parking/unparking moves bytes, not
        #: membership, so it does NOT bump). Routers key deltas on it.
        self.digest_version = 0
        #: bounded (version, op, hash) journal of membership mutations —
        #: ``block_hash_delta`` replays the suffix past a router's
        #: version; a router older than the journal's tail gets a gap
        #: (None) and refreshes wholesale. Bounded to the digest cap:
        #: a delta bigger than the digest itself has no reason to exist.
        self._journal: "collections.deque[Tuple[int, str, int]]" = (
            collections.deque(maxlen=max(1, int(journal_limit))))
        # engine-visible counters (the registry families are process
        # totals; benches/snapshots want this engine's share)
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.evictions = 0
        self.parks = 0
        self.unparks = 0

    # -- lookup --------------------------------------------------------------
    @property
    def cached_blocks(self) -> int:
        return len(self._registered)

    def match(self, tokens: "tuple[int, ...]") -> PrefixMatch:
        """Longest cached prefix of ``tokens``; increfs every matched
        block so concurrent eviction cannot reclaim it before the
        caller installs/copies. Callers pass the prompt MINUS its last
        token: the token feeding the first decode step must always be
        prefilled, because the cache holds K/V, not logits."""
        bs = self.block_size
        node = self._root
        full: "list[int]" = []
        i = 0
        while len(tokens) - i >= bs:
            child = node.children.get(tokens[i:i + bs])
            if child is None or child.tier != "device":
                # parked child: the bytes are a tier away, not usable
                # as KV — restore_path() runs before match on the
                # tiered admission path, so hitting one here means the
                # restore fell short (re-prefill the rest)
                break
            full.append(child.block_id)
            node = child
            node.stamp = next(self._clock)
            i += bs
        best: "Optional[_Partial]" = None
        best_q = 0
        rest = tokens[i:]
        for p in node.partials:
            q = _common_prefix(p.tokens, rest)
            if q > best_q:
                best, best_q = p, q
        self.pool.ref(full)
        partial_id = None
        if best is not None and best_q > 0:
            partial_id = best.block_id
            self.pool.ref([partial_id])
            best.stamp = next(self._clock)
        return PrefixMatch(full, partial_id, best_q, i + best_q)

    def suggest(self, tokens: "tuple[int, ...]", k: int) -> "list[int]":
        """Draft up to ``k`` tokens that FOLLOWED this exact context in
        a cached prompt — the zero-weight draft source for speculative
        decoding: the trie already spells out every
        prompt it has seen, so when one request's context is a prefix
        of a cached longer prompt, the cached continuation is a high-
        probability draft (chat history growing turn by turn, retrieval
        prompts sharing scaffolding).

        Token ids only — no block references, no refcounts, no stamps
        touched: drafting must never keep a block alive or perturb LRU
        order (a wrong draft costs one rejected verify position, not a
        corrupted cache).
        """
        if k < 1:
            return []
        bs = self.block_size
        node = self._root
        i = 0
        while len(tokens) - i >= bs:
            child = node.children.get(tokens[i:i + bs])
            if child is None:
                break
            node = child
            i += bs
        rest = tokens[i:]
        out: "list[int]" = []
        # descend through the child whose key extends the remainder;
        # exact-boundary contexts (rest empty) continue down the most
        # recently used child path
        while len(out) < k:
            step = None
            best_stamp = -1
            for key, child in node.children.items():
                if key[:len(rest)] == rest and child.stamp > best_stamp:
                    step, best_stamp = child, child.stamp
            if step is not None:
                out.extend(step.key[len(rest):])
                node, rest = step, ()
                continue
            # no full-block continuation: the freshest partial tail
            # extending the remainder ends the walk
            best = None
            for p in node.partials:
                if (len(p.tokens) > len(rest)
                        and p.tokens[:len(rest)] == rest
                        and (best is None or p.stamp > best.stamp)):
                    best = p
            if best is not None:
                out.extend(best.tokens[len(rest):])
            break
        return out[:k]

    def block_hashes(self, max_entries: int = 1024) -> "list[int]":
        """Chained :func:`chain_hash` values of the cached block-aligned
        prefixes — the compact digest a host publishes so a router can
        place requests where their prefix blocks already live
       . Most-recently-used first, capped at ``max_entries``
        (a bounded digest stays cheap to ship and compare; evicting the
        coldest entries first mirrors what the LRU eviction would drop
        anyway). Partial tail blocks are excluded: the digest is
        block-aligned by construction, matching the router-side
        :func:`~sparkdl_torch.fabric.digest.prompt_block_hashes` grid.
        Call under the engine lock (same discipline as every other trie
        walk)."""
        if max_entries < 1:
            return []
        entries: "list[tuple[int, int]]" = []
        stack: "list[_Node]" = list(self._root.children.values())
        while stack:
            node = stack.pop()
            entries.append((node.stamp, node.digest_hash))
            stack.extend(node.children.values())
        entries.sort(reverse=True)
        return [h for _, h in entries[:max_entries]]

    # -- digest deltas --------------------------------------------
    def _journal_mutation(self, op: str, node: _Node) -> None:
        self.digest_version += 1
        self._journal.append((self.digest_version, op, node.digest_hash))

    def block_hash_delta(self, since_version: int,
                         max_entries: int = 1024) -> "Optional[Dict]":
        """Membership mutations since ``since_version``, coalesced into
        ``added``/``removed`` hash lists — what a router applies on top
        of its last wholesale :meth:`block_hashes` snapshot instead of
        re-shipping the whole digest every refresh.

        Returns ``None`` for a **gap**: the journal no longer covers
        ``(since_version, digest_version]`` (the caller fell too far
        behind its bounded tail), the caller claims a future version
        (restarted host), or the coalesced delta would exceed
        ``max_entries`` (wholesale is cheaper at that point). The
        caller answers a gap with a wholesale refresh — always correct,
        never required for correctness (digests are advisory).
        Call under the engine lock, like every other trie walk."""
        since = int(since_version)
        if since > self.digest_version:
            return None  # a future version: the host restarted
        delta = {"since": since, "version": self.digest_version,
                 "added": [], "removed": []}
        if since == self.digest_version:
            return delta  # caught up: the steady-state no-op
        if not self._journal or self._journal[0][0] > since + 1:
            return None  # journal tail truncated past the caller
        added: "set[int]" = set()
        removed: "set[int]" = set()
        for ver, op, h in self._journal:
            if ver <= since:
                continue
            if op == "+":
                removed.discard(h)
                added.add(h)
            else:
                # an add that never reached the caller nets to nothing
                if h in added:
                    added.discard(h)
                else:
                    removed.add(h)
        if len(added) + len(removed) > max_entries:
            return None
        delta["added"] = sorted(added)
        delta["removed"] = sorted(removed)
        return delta

    def record_lookup(self, hit_tokens: int, miss_tokens: int) -> None:
        """Land one admission's hit/miss split (prompt tokens) in the
        spine + the engine-local counters."""
        if hit_tokens:
            _M_HITS.inc(hit_tokens)
            self.hit_tokens += hit_tokens
        if miss_tokens:
            _M_MISSES.inc(miss_tokens)
            self.miss_tokens += miss_tokens

    # -- registration --------------------------------------------------------
    def register(self, tokens: "tuple[int, ...]",
                 block_ids: "list[int]") -> None:
        """Index a freshly prefilled prompt: ``block_ids[i]`` holds
        tokens ``[i*bs, (i+1)*bs)`` (the slot's table prefix — shared
        blocks walk existing nodes, owned blocks become new entries).
        A registered block survives refcount zero as an evictable
        cache entry instead of freeing. Spans whose trie node is
        *parked* are revived in place: the freshly prefilled block
        becomes the node's device block and the stale tier payload is
        dropped (the engine re-prefilled exactly because the bytes were
        a tier away). A block previously indexed as a partial tail that
        has since been decoded full is promoted to a full node, and a
        tail extending an existing partial on the same block grows that
        entry in place (turn-by-turn chat: the session's produced
        tokens become matchable prefix for its next turn)."""
        bs = self.block_size
        node = self._root
        n_full = len(tokens) // bs
        for i in range(n_full):
            key = tokens[i * bs:(i + 1) * bs]
            child = node.children.get(key)
            if child is None or child.tier != "device":
                bid = block_ids[i]
                prev = self._registered.get(bid)
                if isinstance(prev, _Node):
                    break  # block already a full node elsewhere
                if isinstance(prev, _Partial):
                    # decode grew the prompt's tail partial into a full
                    # block: promote (the partial entry would otherwise
                    # alias the same block with fewer tokens)
                    prev.parent.partials.remove(prev)
                    del self._registered[bid]
                if child is None:
                    child = _Node(key, bid, node, next(self._clock))
                    node.children[key] = child
                    self._journal_mutation("+", child)
                else:
                    # parked node, freshly re-prefilled span: revive
                    if self._tiers is not None:
                        self._tiers.drop(child)
                    child.block_id = bid
                    child.tier = "device"
                self._registered[bid] = child
            node = child
            node.stamp = next(self._clock)
        tail = tokens[n_full * bs:]
        if tail:
            bid = block_ids[n_full]
            prev = self._registered.get(bid)
            if (isinstance(prev, _Partial) and prev.parent is node
                    and len(prev.tokens) < len(tail)
                    and tail[:len(prev.tokens)] == prev.tokens):
                prev.tokens = tail
                prev.stamp = next(self._clock)
            elif bid not in self._registered and not any(
                    p.tokens == tail for p in node.partials):
                p = _Partial(tail, bid, node, next(self._clock))
                node.partials.append(p)
                self._registered[bid] = p

    # -- release / eviction --------------------------------------------------
    def release(self, block_ids: "list[int]") -> None:
        """Drop one reference per block; zero-ref blocks return to the
        free list unless trie-registered (those stay cached until
        evicted)."""
        free_now = [bid for bid in self.pool.deref(block_ids)
                    if bid not in self._registered]
        if free_now:
            self.pool.release(free_now)

    def _evictable(self, bid: int, entry: Any) -> bool:
        if self.pool.refcount(bid) != 0:
            return False
        if isinstance(entry, _Node) and (entry.children
                                         or entry.partials):
            return False  # interior node: children would dangle
        return True

    def evict(self, n: int) -> int:
        """Free up to ``n`` cached blocks, LRU over refcount-0 leaves;
        returns how many were freed. Evicting a leaf may expose its
        parent as the next candidate, so pressure drains whole cold
        paths tail-first. One candidate pass + a stamp heap: O(cached +
        n log cached), not a full rescan per freed block — this runs
        under the engine lock on the admission path."""
        import heapq

        heap = [(entry.stamp, bid)
                for bid, entry in self._registered.items()
                if self._evictable(bid, entry)]
        heapq.heapify(heap)
        freed = 0
        while freed < n and heap:
            stamp, bid = heapq.heappop(heap)
            entry = self._registered.get(bid)
            if entry is None or not self._evictable(bid, entry):
                continue  # resurrected by a match since the pass
            if entry.stamp != stamp:
                # touched since queued: re-queue at its fresh stamp so
                # LRU order stays honest (stamps only grow: terminates)
                heapq.heappush(heap, (entry.stamp, bid))
                continue
            parent = entry.parent
            self._evict_entry(bid, entry)
            freed += 1
            # the eviction may have exposed its parent as a new leaf
            if (parent is not self._root
                    and parent.block_id in self._registered
                    and self._evictable(parent.block_id, parent)):
                heapq.heappush(heap, (parent.stamp, parent.block_id))
        return freed

    # -- tiering --------------------------------------------
    def _parkable(self, bid: int, entry: Any) -> bool:
        """Device node whose block can page out: refcount zero (shares
        in live block tables never park), no device-tier children
        (children park before parents — the subtree invariant), and no
        partial entries (partials are copy-on-write donors; a reffed
        partial pins its node, a cold one is plain-evicted first)."""
        if not isinstance(entry, _Node) or entry.tier != "device":
            return False
        if self.pool.refcount(bid) != 0:
            return False
        if any(c.tier == "device" for c in entry.children.values()):
            return False
        if entry.partials:
            return False
        return True

    def demote(self, n: int,
               park_payload: "Callable[[int], Optional[Dict]]",
               evict_fallback: bool = True) -> int:
        """Free up to ``n`` device blocks by parking cold leaves into
        the tier store (host, cascading to disk), LRU-first — the
        tiered twin of :meth:`evict` and the single eviction policy of
        the hierarchy: device leaves page DOWN before anything is
        dropped, and only the disk tier's overflow discards state.

        ``park_payload(bid)`` performs the D2H fetch and returns the
        raw block payload, or ``None`` for a torn park (fault injected
        or transfer failure) — those blocks fall back to plain eviction
        when ``evict_fallback`` (re-prefill is always correct).
        Refcount-0 partials interleave in the same LRU order and are
        always plain-evicted (never parked). Returns device blocks
        freed."""
        import heapq

        if self._tiers is None:
            return self.evict(n)
        heap = [(entry.stamp, bid)
                for bid, entry in self._registered.items()
                if (self._parkable(bid, entry)
                    or self._evictable(bid, entry))]
        heapq.heapify(heap)
        freed = 0
        while freed < n and heap:
            stamp, bid = heapq.heappop(heap)
            entry = self._registered.get(bid)
            parkable = entry is not None and self._parkable(bid, entry)
            evictable = entry is not None and self._evictable(bid, entry)
            if not (parkable or evictable):
                continue  # resurrected by a match since queued
            if entry.stamp != stamp:
                heapq.heappush(heap, (entry.stamp, bid))
                continue
            parent = entry.parent
            if parkable:
                payload = park_payload(bid)
                if payload is not None:
                    del self._registered[bid]
                    entry.tier = "host"
                    entry.block_id = -1
                    self.pool.release([bid])
                    self.parks += 1
                    for lost in self._tiers.park(entry, payload):
                        self._prune_parked(lost)
                    freed += 1
                elif evict_fallback and evictable:
                    self._evict_entry(bid, entry)
                    freed += 1
                else:
                    continue  # torn park, not plainly evictable: skip
            else:
                self._evict_entry(bid, entry)
                freed += 1
            # parking/evicting may expose the parent as the next
            # candidate (its last device child / partial just left)
            if (parent is not self._root
                    and parent.block_id in self._registered
                    and (self._parkable(parent.block_id, parent)
                         or self._evictable(parent.block_id, parent))):
                heapq.heappush(heap, (parent.stamp, parent.block_id))
        return freed

    def _evict_entry(self, bid: int, entry: Any) -> None:
        parent = entry.parent
        if isinstance(entry, _Partial):
            parent.partials.remove(entry)
        else:
            del parent.children[entry.key]
            self._journal_mutation("-", entry)
        del self._registered[bid]
        self.pool.release([bid])
        _M_EVICTIONS.inc()
        self.evictions += 1

    def _prune_parked(self, node: _Node) -> None:
        """Remove a parked node and its (all-parked) subtree from the
        trie and the tier store — the session re-prefills next turn."""
        parent = node.parent
        if parent is not None and parent.children.get(node.key) is node:
            del parent.children[node.key]
        stack = [node]
        while stack:
            cur = stack.pop()
            if self._tiers is not None:
                self._tiers.drop(cur)
            self._journal_mutation("-", cur)
            stack.extend(cur.children.values())
            cur.children.clear()

    def restore_path(self, tokens: "tuple[int, ...]",
                     alloc_block: "Callable[[], Optional[int]]",
                     install: "Callable[[int, Dict], bool]") -> "list[int]":
        """Page a parked prefix of ``tokens`` back onto the device
        ahead of :meth:`match` — the turn-resume path: one H2D copy
        per parked block instead of re-prefilling the whole prefix.

        Walks the block-aligned path; device nodes pass through
        untouched, parked nodes are fetched from their tier, given a
        fresh pool block from ``alloc_block()`` (which may demote
        *other* cold leaves — just-restored blocks hold a reference so
        they can't be victims), and written back by ``install(bid,
        payload)``. The walk stops at the first miss: allocation
        shortfall re-parks the payload (MRU — it is about to be wanted
        again); a corrupt payload or failed install (``kv.unpark``
        fault) prunes that node's parked subtree so the suffix simply
        re-prefills — the request always completes.

        Returns the restored block ids, each holding one reference the
        caller must :meth:`release` after ``match()`` takes its own."""
        if self._tiers is None:
            return []
        bs = self.block_size
        node = self._root
        restored: "list[int]" = []
        i = 0
        while len(tokens) - i >= bs:
            child = node.children.get(tokens[i:i + bs])
            if child is None:
                break
            if child.tier != "device":
                payload = self._tiers.fetch(child)
                if payload is None:
                    # spill lost or corrupt: drop the whole parked
                    # subtree (all parked below a parked node)
                    self._prune_parked(child)
                    break
                bid = alloc_block()
                if bid is None:
                    # pool shortfall: put it back at the MRU end and
                    # let the suffix re-prefill this turn
                    for lost in self._tiers.park(child, payload):
                        self._prune_parked(lost)
                    break
                if not install(bid, payload):
                    self.pool.release(self.pool.deref([bid]))
                    self._prune_parked(child)
                    break
                child.block_id = bid
                child.tier = "device"
                self._registered[bid] = child
                self.unparks += 1
                restored.append(bid)
            node = child
            i += bs
        return restored

    def parked_leaf_paths(self) -> "List[Tuple[tuple, List[_Node]]]":
        """``(tokens, root→leaf node path)`` for every parked leaf —
        one entry per resumable idle session, the export side of
        parked-session migration. The path may start with
        device-resident ancestors (a session that parked only its
        tail); the caller serializes those too so the importing host
        can adopt the WHOLE prefix. Call under the engine lock."""
        if self._tiers is None:
            return []
        out: "List[Tuple[tuple, List[_Node]]]" = []
        for leaf in list(self._tiers.nodes()):
            if leaf.children:
                continue
            path: "List[_Node]" = []
            cur = leaf
            while cur is not None and cur is not self._root:
                if (cur.parent is None
                        or cur.parent.children.get(cur.key) is not cur):
                    break  # orphaned by a racing prune: skip the leaf
                path.append(cur)
                cur = cur.parent
            if cur is not self._root:
                continue
            path.reverse()
            tokens = tuple(t for n in path for t in n.key)
            out.append((tokens, path))
        return out

    def adopt_parked(self, tokens: "tuple[int, ...]",
                     payloads: "List[Dict]") -> int:
        """Graft a migrated session's block-aligned prefix into this
        trie as PARKED nodes: ``payloads[i]`` holds the raw
        storage bytes for tokens ``[i*bs, (i+1)*bs)``. Spans this trie
        already holds (device or parked) keep their existing state —
        the resident bytes are identical by construction (KV is a pure
        function of the prefix). Returns blocks newly parked. The next
        turn's :meth:`restore_path` pages the path back in exactly as
        if it had parked here — one H2D per block, no re-prefill."""
        if self._tiers is None:
            raise RuntimeError(
                "adopt_parked needs a tier store (host_kv_blocks)")
        bs = self.block_size
        node = self._root
        adopted = 0
        for i, payload in enumerate(payloads):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            if len(key) < bs:
                break  # ragged tail: the digest grid is block-aligned
            child = node.children.get(key)
            if child is None:
                child = _Node(key, -1, node, next(self._clock))
                child.tier = "host"
                node.children[key] = child
                self._journal_mutation("+", child)
                self.parks += 1
                for lost in self._tiers.park(child, payload):
                    self._prune_parked(lost)
                if self._tiers.tier_of(child) is None:
                    # the park cascade dropped the adopted node itself
                    # (tiers full of protected entries): the rest of
                    # the path would dangle unreachable — stop here
                    break
                adopted += 1
            node = child
        return adopted

    def cold_blocks(self) -> int:
        """Refcount-0 registered device blocks — pressure that is
        *parkable*, not live (fabric placement wants the split)."""
        return sum(1 for bid in self._registered
                   if self.pool.refcount(bid) == 0)

    def parked_sessions(self) -> int:
        """Parked trie leaves — each is the tail of one idle session's
        prefix path, the engine's proxy for resumable conversations."""
        if self._tiers is None:
            return 0
        return sum(1 for node in self._tiers.nodes()
                   if not node.children)

    def tier_stats(self) -> "Optional[Dict[str, int]]":
        if self._tiers is None:
            return None
        s = self._tiers.stats()
        s["parked_sessions"] = self.parked_sessions()
        s["parks"] = self.parks
        s["unparks"] = self.unparks
        return s


def _common_prefix(a: tuple, b: tuple) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n
