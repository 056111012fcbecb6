"""Host-DRAM + disk tiers under the paged KV pool.

The port of ``sparkdl_tpu.serving.kv_tiers`` (framework-free; only the
disk codec changed, :mod:`~sparkdl_torch.serving.kv_codec`). Production
chat traffic is mostly *idle* sessions: the user read the reply and will
come back in minutes. Keeping their KV blocks resident burns device pool
capacity; evicting them forces a full re-prefill on the next turn. This
module is the cheap middle ground:

* **host tier** — an LRU dict of raw per-block payloads fetched D2H on
  the engine's stream (:func:`~sparkdl_torch.runtime.completion.
  start_fetch`). Host DRAM is several times a card's memory, so parking
  a cold session here multiplies live sessions per card.
* **disk tier** — below the host tier, an LRU spill directory holding
  the same payloads through the raw-storage codec (base64 JSON,
  dtype-faithful). Bounded; overflow drops the coldest droppable entry
  entirely (that session re-prefills, which is exactly what would have
  happened without tiers).

Payloads are **storage-dtype raw** — for an int8 pool the parked bytes
are the int8 codes plus the per-column fp32 scales, never a dequantized
copy, and a bf16 pool's blocks travel as their bit patterns
(:class:`~sparkdl_torch.serving.kv_codec.BF16Bits`). That is both the
transfer saving the quantized layouts bought and the reason a
parked-then-resumed session is *bitwise* identical to one that never
parked: unpark writes back the exact bytes decode would have read.

The store is deliberately dumb bookkeeping keyed by opaque handles (the
radix-trie nodes of :mod:`~sparkdl_torch.serving.prefix_cache` own the
policy of *what* parks); it owns only LRU order, tier capacities, the
spill-file lifecycle, and the tier telemetry
(``sparkdl_kv_tier_blocks{tier}``, park/unpark counters). Like
``KVBlockPool`` it is not self-locking — callers serialize under the
engine lock.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import shutil
import tempfile
from typing import Callable, Dict, Hashable, List, Optional

from sparkdl_torch.observability.registry import GaugeShare, registry
from sparkdl_torch.serving import kv_codec


def _unlink_spill(path: str) -> None:
    """Remove a spill file and its tmp/sidecar companions (best
    effort): no publication artifact may outlive its disk-tier entry."""
    for p in (path, path + ".tmp", path + ".sha256"):
        try:
            os.unlink(p)
        except OSError:
            pass

_M_TIER = registry().gauge(
    "sparkdl_kv_tier_blocks",
    "KV blocks resident per cache tier (device = pool blocks_cached; "
    "host = parked in pinned DRAM; disk = spilled), all engines",
    labels=("tier",))
_M_PARKS = registry().counter(
    "sparkdl_kv_parks_total",
    "KV blocks demoted a tier (tier=host: device->host page-out; "
    "tier=disk: host->disk spill)", labels=("tier",))
_M_UNPARKS = registry().counter(
    "sparkdl_kv_unparks_total",
    "KV blocks paged back to the device on turn resume",
    labels=("tier",))
_M_FALLBACKS = registry().counter(
    "sparkdl_kv_park_fallbacks_total",
    "tiering operations abandoned for the plain path (op=park: torn "
    "page-out, blocks evicted instead; op=unpark: corrupt page-in, "
    "session re-prefills)", labels=("op",))
_M_MIGRATIONS = registry().counter(
    "sparkdl_kv_migrations_total",
    "parked sessions migrated between hosts on drain/scale-down "
    "(outcome=exported/imported: the two wire ends; export_failed/"
    "import_failed: torn migration, the session re-prefills instead)",
    labels=("outcome",))
_M_MIG_BLOCKS = registry().counter(
    "sparkdl_kv_migration_blocks_total",
    "KV blocks serialized onto the wire by parked-session migration")
_M_MIG_SEC = registry().histogram(
    "sparkdl_kv_migration_seconds",
    "wall seconds per parked-session migration call (one host's export "
    "or import batch)")
_M_PARK_SEC = registry().histogram(
    "sparkdl_kv_park_seconds",
    "wall seconds per park operation (D2H fetch + host insert, one "
    "session's cold blocks)")
_M_UNPARK_SEC = registry().histogram(
    "sparkdl_kv_unpark_seconds",
    "wall seconds per unpark operation (tier fetch + H2D install, one "
    "parked prefix path)")


def _set_tier(node: Hashable, tier: str) -> None:
    # Keep the owner's per-handle tier marker truthful across host->
    # disk demotion; tolerate handles without one (tests use tuples).
    try:
        node.tier = tier
    except (AttributeError, TypeError):
        pass


class TieredKVStore:
    """LRU host-DRAM tier with an LRU disk tier below it.

    ``park`` inserts at the MRU end of the host tier; host overflow
    demotes the LRU host entry to disk (when a disk tier is
    configured), disk overflow drops the LRU *droppable* entry (the
    ``is_droppable`` predicate lets the owner protect interior trie
    nodes whose children are still parked — dropping those would orphan
    reachable state). Dropped handles are returned so the owner can
    prune its index. ``fetch`` removes the entry from whichever tier
    holds it and returns the payload.

    Entries are one block each: a dict of numpy arrays in storage
    dtype (``k``/``v`` shaped ``[layers, block_size, H, D]`` plus
    ``k_scale``/``v_scale`` ``[layers, block_size]`` for quantized
    pools). The disk tier serializes through the raw codec so
    bf16/int8 round-trip exactly.
    """

    def __init__(self, host_blocks: int, disk_blocks: int = 0,
                 spill_dir: Optional[str] = None,
                 is_droppable: Optional[Callable[[Hashable], bool]] = None):
        if host_blocks <= 0:
            raise ValueError("host_blocks must be positive")
        if disk_blocks < 0:
            raise ValueError("disk_blocks must be >= 0")
        self.host_blocks = int(host_blocks)
        self.disk_blocks = int(disk_blocks)
        self._is_droppable = is_droppable or (lambda node: True)
        self._host: "collections.OrderedDict[Hashable, Dict]" = (
            collections.OrderedDict())
        self._disk: "collections.OrderedDict[Hashable, str]" = (
            collections.OrderedDict())
        self._owns_dir = spill_dir is None and disk_blocks > 0
        self._dir = (tempfile.mkdtemp(prefix="sparkdl-kv-spill-")
                     if self._owns_dir else spill_dir)
        if self._dir:
            os.makedirs(self._dir, exist_ok=True)
        self._seq = 0
        self._g_host = GaugeShare(_M_TIER.labels(tier="host"))
        self._g_disk = GaugeShare(_M_TIER.labels(tier="disk"))
        self._closed = False

    # -- occupancy -----------------------------------------------------------
    @property
    def host_used(self) -> int:
        return len(self._host)

    @property
    def disk_used(self) -> int:
        return len(self._disk)

    def __contains__(self, node: Hashable) -> bool:
        return node in self._host or node in self._disk

    def nodes(self):
        """All parked handles, host tier first (LRU -> MRU each)."""
        yield from self._host
        yield from self._disk

    def tier_of(self, node: Hashable) -> Optional[str]:
        if node in self._host:
            return "host"
        if node in self._disk:
            return "disk"
        return None

    def stats(self) -> Dict[str, int]:
        return {
            "host_blocks": len(self._host),
            "host_capacity": self.host_blocks,
            "disk_blocks": len(self._disk),
            "disk_capacity": self.disk_blocks,
        }

    # -- tier movement -------------------------------------------------------
    def park(self, node: Hashable, payload: Dict) -> List[Hashable]:
        """Insert one block at the host tier's MRU end.

        Returns the handles *dropped entirely* by the resulting
        cascade (host->disk demotions stay resident and are not
        reported). The caller prunes its index for each dropped
        handle — those sessions re-prefill on their next turn.
        """
        dropped: List[Hashable] = []
        self._host[node] = payload
        self._host.move_to_end(node)
        _set_tier(node, "host")
        _M_PARKS.inc(tier="host")
        while len(self._host) > self.host_blocks:
            lru, lru_payload = next(iter(self._host.items()))
            del self._host[lru]
            if self.disk_blocks > 0 and self._spill(lru, lru_payload):
                _set_tier(lru, "disk")
                _M_PARKS.inc(tier="disk")
                dropped.extend(self._trim_disk())
            else:
                dropped.append(lru)
        self._update_gauges()
        return dropped

    def fetch(self, node: Hashable) -> Optional[Dict]:
        """Remove ``node`` from its tier and return its payload.

        Returns ``None`` when the node is not resident (already
        dropped) or its spill file fails to load (corrupt unpark — the
        caller falls back to re-prefill either way).
        """
        payload = self._host.pop(node, None)
        if payload is not None:
            _M_UNPARKS.inc(tier="host")
            self._update_gauges()
            return payload
        path = self._disk.pop(node, None)
        if path is not None:
            self._update_gauges()
            try:
                payload = self._load(path)
            except Exception:
                payload = None  # torn/corrupt spill: prune, re-prefill
            finally:
                _unlink_spill(path)
            if payload is not None:
                _M_UNPARKS.inc(tier="disk")
            return payload
        return None

    def peek(self, node: Hashable) -> Optional[Dict]:
        """Read ``node``'s payload WITHOUT removing it from its tier —
        the migration-export read: the bytes go onto the
        wire while the local entry stays authoritative until the
        importing host confirms. No LRU touch, no unpark accounting
        (the block is not coming back to the device here). ``None``
        when not resident or the spill file fails to load."""
        payload = self._host.get(node)
        if payload is not None:
            return payload
        path = self._disk.get(node)
        if path is not None:
            try:
                return self._load(path)
            except Exception:
                return None
        return None

    def drop(self, node: Hashable) -> None:
        """Discard ``node`` from whichever tier holds it (no fetch)."""
        if self._host.pop(node, None) is None:
            path = self._disk.pop(node, None)
            if path is not None:
                _unlink_spill(path)
        self._update_gauges()

    def _trim_disk(self) -> List[Hashable]:
        dropped: List[Hashable] = []
        while len(self._disk) > self.disk_blocks:
            victim = next(
                (n for n in self._disk if self._is_droppable(n)), None)
            if victim is None:
                break  # only protected interior entries: soft-exceed
            self.drop(victim)
            dropped.append(victim)
        return dropped

    # -- disk codec ----------------------------------------------------------
    def _spill(self, node: Hashable, payload: Dict) -> bool:
        if not self._dir:
            return False
        self._seq += 1
        path = os.path.join(self._dir, f"kvblk-{self._seq:08d}.json")
        # Crash-safe publication (the checkpoint-integrity scheme): serialize once, write to a tmp file, fsync, then
        # os.replace into the final name with a sha256 sidecar — a
        # writer killed mid-spill leaves a *.tmp (never adopted) or a
        # digest mismatch, and _load turns either into the existing
        # corrupt-unpark fallback (prune + re-prefill) instead of a
        # json-decode crash on a torn file.
        blob = json.dumps({k: kv_codec.encode(v) for k, v in payload.items()})
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            with open(path + ".sha256", "w") as f:
                f.write(hashlib.sha256(blob.encode("utf-8")).hexdigest())
            os.replace(tmp, path)
        except OSError:
            _unlink_spill(path)
            return False
        self._disk[node] = path
        self._disk.move_to_end(node)
        return True

    def _load(self, path: str) -> Dict:
        with open(path + ".sha256") as f:
            want = f.read().strip()
        with open(path, "rb") as f:
            raw = f.read()
        got = hashlib.sha256(raw).hexdigest()
        if got != want:
            raise ValueError(
                f"torn spill file {path}: sha256 {got[:12]} != "
                f"sidecar {want[:12]}")
        blob = json.loads(raw.decode("utf-8"))
        return {k: kv_codec.decode(v) for k, v in blob.items()}

    def _update_gauges(self) -> None:
        if self._closed:
            return
        self._g_host.set(len(self._host))
        self._g_disk.set(len(self._disk))

    def close(self) -> None:
        """Retract gauge contributions and remove owned spill files."""
        if self._closed:
            return
        self._g_host.set(0)
        self._g_disk.set(0)
        self._closed = True
        self._host.clear()
        if self._owns_dir and self._dir:
            shutil.rmtree(self._dir, ignore_errors=True)
        else:
            for path in self._disk.values():
                _unlink_spill(path)
        self._disk.clear()
