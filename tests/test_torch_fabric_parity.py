"""The port's fabric against the JAX package's: a fleet may mix hosts
running either package, so both must hash a prompt to the same digest
grid and the same rendezvous weights, and two routers (one of each
package) fed the same hosts and the same traffic must place every
request on the same host.
"""

from concurrent.futures import Future

import numpy as np
import pytest

from sparkdl_torch.fabric import Router as TorchRouter
from sparkdl_torch.fabric import digest as tdig
from sparkdl_torch.fabric.host import HostHandle as TorchHandle
from sparkdl_torch.serving.kv_blocks import KVBlockPool as TorchPool
from sparkdl_torch.serving.prefix_cache import PrefixCache as TorchCache
from sparkdl_tpu.fabric import Router as JaxRouter
from sparkdl_tpu.fabric import digest as jdig
from sparkdl_tpu.fabric.host import HostHandle as JaxHandle
from sparkdl_tpu.serving.kv_blocks import KVBlockPool as JaxPool
from sparkdl_tpu.serving.prefix_cache import PrefixCache as JaxCache

BS = 4
HOSTS = ["host-a", "host-b", "host-c"]


def _prompts(n=60, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 500, 12).tolist()
    out = []
    for i in range(n):
        tail = rng.integers(1, 500, int(rng.integers(1, 14))).tolist()
        # a third share a 12-token prefix: real affinity structure
        out.append(base[:int(rng.integers(4, 13))] + tail if i % 3 == 0
                   else tail + [i])
    return out


# -- (a) the digest grid and the rendezvous weights ---------------------------

def test_hashes_keys_and_rendezvous_weights_are_the_references():
    for p in _prompts():
        assert tdig.placement_key(p, BS) == jdig.placement_key(p, BS)
        assert tdig.path_anchor(p, BS) == jdig.path_anchor(p, BS)
        assert (tdig.prompt_block_hashes(p, BS, max_blocks=3)
                == jdig.prompt_block_hashes(p, BS, max_blocks=3))
        assert tdig.prompt_block_hashes(p, BS) == \
            jdig.prompt_block_hashes(p, BS)
        key = tdig.placement_key(p, BS)
        for h in HOSTS:
            assert tdig.hrw_score(key, h) == jdig.hrw_score(key, h)
        assert (tdig.hrw_preferred_host(key, HOSTS)
                == jdig.hrw_preferred_host(key, HOSTS))
    for s in ("user-42", 42, "sess/ü"):
        assert tdig.session_key(s) == jdig.session_key(s)


def test_published_digests_and_deltas_are_the_references():
    """The same registrations give the same published digest and the
    same delta journal, and either package's router side folds the
    other's payload to the same membership."""
    caches = [TorchCache(TorchPool(64, BS)), JaxCache(JaxPool(64, BS))]
    prompts = _prompts(20, seed=3)
    snaps = []
    for cache in caches:
        marks = []
        for i, p in enumerate(prompts):
            if i == 10:
                marks.append((sorted(cache.block_hashes()),
                               cache.digest_version))
            nb = (len(p) - 1) // BS
            if nb:
                blocks = cache.pool.allocate(nb)
                cache.register(tuple(p[:nb * BS]), blocks)
                cache.release(blocks)
        cache.evict(3)  # removals ride the journal too
        (half, v_half), = marks
        snaps.append((half, v_half, sorted(cache.block_hashes()),
                      cache.digest_version,
                      cache.block_hash_delta(v_half)))
    assert snaps[0] == snaps[1]
    half, v_half, hashes, version, delta = snaps[0]
    assert delta["added"] and delta["removed"]
    for dig in (tdig, jdig):
        start = dig.HostDigest(host_id="h", block_size=BS,
                               hashes=frozenset(half), version=v_half)
        full = start.apply_delta({**delta, "block_size": BS})
        assert full.version == version and sorted(full.hashes) == hashes


# -- (b) the same placements over the same hosts and traffic ------------------

def _fake_host_cls(base):
    class Fake(base):
        def __init__(self, host_id, *, replica_count=1, digest=None):
            self.host_id = host_id
            self.replica_count = replica_count
            self.digest = digest
            self.futs = []

        def submit(self, payload, *, timeout_s=None):
            fut = Future()
            self.futs.append(fut)  # held: outstanding work until released
            return fut

        def snapshot(self):
            return {"host_id": self.host_id, "capacity": self.capacity()}

        def capacity(self):
            return {"host_id": self.host_id,
                    "replica_count": self.replica_count, "n_slots": 4,
                    "free_slots": 4, "kv_blocks_free": None,
                    "kv_blocks_total": None, "queue_depth": 0,
                    "max_queue_depth": 64, "draining": False}

        def health(self):
            return {"status": "ok", "host_id": self.host_id}

        def prefix_digest(self, max_entries=1024):
            if self.digest is None:
                return None
            return {"host_id": self.host_id, "block_size": BS,
                    "version": 1, "hashes": list(self.digest)}

        def drain(self):
            return []

        def close(self, *, timeout_s=30.0):
            pass

    return Fake


def _place(router, by_id, prompt, session=None):
    """Submit one request; the id of the host that took it."""
    before = {h: len(by_id[h].futs) for h in by_id}
    router.submit({"prompt": prompt, "max_new_tokens": 2}, session=session)
    (hid,) = [h for h in by_id if len(by_id[h].futs) > before[h]]
    return hid


@pytest.mark.parametrize("policy", ["affinity", "headroom", "round_robin"])
def test_routers_of_both_packages_place_alike(policy):
    prompts = _prompts(90, seed=5)
    shared = tdig.prompt_block_hashes(prompts[0], BS)
    placed = []
    for router_cls, base in ((TorchRouter, TorchHandle),
                             (JaxRouter, JaxHandle)):
        fake = _fake_host_cls(base)
        hosts = [fake("host-a", replica_count=2, digest=shared),
                 fake("host-b"), fake("host-c", digest=shared[:1])]
        by_id = {h.host_id: h for h in hosts}
        got = []
        with router_cls(hosts, auto_refresh=False, policy=policy,
                        placement_block_size=BS) as r:
            r.refresh()
            for i, p in enumerate(prompts):
                got.append(_place(r, by_id, p, session=(
                    f"s{i % 7}" if i % 4 == 0 else None)))
                if i % 5 == 4:
                    # release the oldest held work everywhere: the
                    # outstanding counts move as one engine's would
                    for h in hosts:
                        for f in h.futs:
                            if not f.done():
                                f.set_result(h.host_id)
                                break
            for h in hosts:
                for f in h.futs:
                    if not f.done():
                        f.set_result(h.host_id)
            placed.append((got, [(h["host"], h["routed"])
                                 for h in r.snapshot()["hosts"]]))
    assert placed[0] == placed[1]
    assert len(set(placed[0][0])) == 3  # every host took work


def test_drain_hand_off_counts_agree():
    """A host drained mid-stream: both routers stop placing there and
    spread the rest alike."""
    prompts = _prompts(30, seed=9)
    placed = []
    for router_cls, base in ((TorchRouter, TorchHandle),
                             (JaxRouter, JaxHandle)):
        fake = _fake_host_cls(base)
        hosts = [fake(h) for h in HOSTS]
        by_id = {h.host_id: h for h in hosts}
        got = []
        with router_cls(hosts, auto_refresh=False,
                        placement_block_size=BS) as r:
            for i, p in enumerate(prompts):
                if i == 12:
                    r.drain_host("host-b")
                got.append(_place(r, by_id, p))
                for f in by_id[got[-1]].futs:
                    if not f.done():
                        f.set_result(got[-1])
        placed.append(got)
    assert placed[0] == placed[1]
    assert "host-b" not in placed[0][12:]
