"""Consistent placement without shared state: rendezvous
hashing over the digest grid. The headline contract is CROSS-PROCESS
determinism — two router processes that have never exchanged a byte map
the same prompts and sessions to the same hosts — plus the minimal-
churn property that makes rendezvous the right hash (removing a host
remaps only that host's keys), and the derived-stickiness semantics
that replace the per-router LRU as the source of truth.
"""

import json
import subprocess
import sys

from sparkdl_torch.fabric.digest import (
    hrw_preferred_host,
    hrw_score,
    path_anchor,
    placement_key,
    session_key,
)

from torch_fabric_fakes import FakeHost, fast_postmortems  # noqa: F401
from torch_fabric_fakes import gpt_payload as _gpt_payload
from torch_fabric_fakes import make_router as _router
from torch_fabric_fakes import metric as _metric

HOSTS = ["host-a", "host-b", "host-c"]


# -- the hash itself ----------------------------------------------------------

def test_hrw_is_deterministic_and_covers_hosts():
    keys = [placement_key(list(range(i, i + 9)), 4) for i in range(50)]
    picks = [hrw_preferred_host(k, HOSTS) for k in keys]
    assert picks == [hrw_preferred_host(k, HOSTS) for k in keys]
    # host order must not matter (any router's dict order works)
    assert picks == [hrw_preferred_host(k, list(reversed(HOSTS)))
                     for k in keys]
    # 50 keys over 3 hosts: every host should own some
    assert set(picks) == set(HOSTS)
    assert hrw_preferred_host(1, []) is None


def test_hrw_minimal_churn_on_host_removal():
    """Removing one host remaps ONLY the keys it owned — the property
    that makes scale-down cheap (a modulo ring would reshuffle nearly
    everything)."""
    keys = [placement_key([i, i + 1, i + 2, i + 3, i + 4], 4)
            for i in range(200)]
    before = {k: hrw_preferred_host(k, HOSTS) for k in keys}
    survivors = [h for h in HOSTS if h != "host-b"]
    for k, owner in before.items():
        after = hrw_preferred_host(k, survivors)
        if owner != "host-b":
            assert after == owner


def test_placement_key_shares_first_block_across_turns():
    """Every continuation of a conversation hashes to the same key:
    the first block is the conversation's identity."""
    base = [7, 3, 9, 1, 5, 2, 8]  # >= one 4-token block usable
    k0 = placement_key(base, 4)
    assert placement_key(base + [11, 12], 4) == k0
    assert placement_key(base + list(range(20)), 4) == k0
    # and the migration anchor of the cached path equals it
    assert path_anchor(base[:4], 4) == k0
    # short prompts (no full block) still hash stably
    assert placement_key([1, 2], 4) == placement_key([1, 2], 4)


def test_session_key_is_stable_arithmetic():
    assert session_key("user-42") == session_key("user-42")
    assert session_key("user-42") != session_key("user-43")
    assert session_key(42) == session_key("42")  # str() canonical form


# -- cross-process determinism (the tentpole bar) -----------------------------

_SUBPROC = r"""
import json, sys
from concurrent.futures import Future
from sparkdl_torch.fabric import Router
from sparkdl_torch.fabric.host import HostHandle

class StubHost(HostHandle):
    def __init__(self, host_id):
        self.host_id = host_id
    def submit(self, payload, *, timeout_s=None):
        f = Future(); f.set_result(self.host_id); return f
    def snapshot(self):
        return {"host_id": self.host_id, "capacity": self.capacity()}
    def capacity(self):
        return {"replica_count": 1, "n_slots": 4,
                "max_queue_depth": 16}
    def health(self):
        return {"status": "ok"}
    def prefix_digest(self, max_entries=1024):
        return None
    def drain(self):
        return []
    def close(self, *, timeout_s=30.0):
        pass

hosts = [StubHost(h) for h in json.loads(sys.argv[1])]
prompts = json.loads(sys.argv[2])
r = Router(hosts, auto_refresh=False, placement_block_size=4)
try:
    print(json.dumps([r.preferred_host(p) for p in prompts]))
finally:
    r.close()
"""


def test_two_subprocess_routers_agree_on_200_prompts():
    """Two router processes (fresh interpreters, so PYTHONHASHSEED and
    import order genuinely differ) must produce identical preferred
    hosts for 200 prompts over the same host set — placement is
    arithmetic, not state."""
    prompts = [[(7 * i + j) % 97 + 1 for j in range(9)]
               for i in range(200)]
    argv = [sys.executable, "-c", _SUBPROC,
            json.dumps(HOSTS), json.dumps(prompts)]
    outs = []
    for _ in range(2):
        proc = subprocess.run(
            argv, capture_output=True, text=True, timeout=300,
            env={"PYTHONPATH": ".", "JAX_PLATFORMS": "cpu",
                 "PATH": "/usr/bin:/bin:/usr/local/bin"})
        assert proc.returncode == 0, proc.stderr
        outs.append(json.loads(proc.stdout))
    assert outs[0] == outs[1]
    assert len(outs[0]) == 200
    assert set(outs[0]) == set(HOSTS)  # real spread, not one winner
    # and the in-process router agrees with both subprocesses
    stubs = [FakeHost(h) for h in HOSTS]
    with _router(stubs, placement_block_size=4) as r:
        assert [r.preferred_host(p) for p in prompts] == outs[0]


# -- derived stickiness (the LRU is only a cache) -----------------------------

def test_sticky_survives_lru_eviction_and_restart():
    """Evicting the session LRU (capacity pressure) or restarting the
    router must re-derive the SAME session->host mapping from the hash
    — the fix for silent affinity loss under churn."""
    a, b = FakeHost("a"), FakeHost("b")
    with _router([a, b], session_capacity=2) as r:
        homes = {s: r.submit(_gpt_payload(), session=s).result(5)
                 for s in ("s1", "s2", "s3")}
        # s3+s2 evicted s1 from the 2-deep LRU; the hash re-derives it
        assert "s1" not in r._sessions
        assert r.submit(_gpt_payload(), session="s1").result(5) \
            == homes["s1"]
    with _router([FakeHost("a"), FakeHost("b")],
                 session_capacity=2) as r2:
        for s, home in homes.items():
            assert r2.submit(_gpt_payload(), session=s).result(5) \
                == home


def test_sticky_digest_evidence_outranks_the_hash():
    """A session whose history lives on a specific host (its digest
    matches the prompt) must follow the CACHE, not the hash — migration
    and cross-router handoff rely on scoring seeing the evidence."""
    from sparkdl_torch.fabric.digest import prompt_block_hashes

    prompt = list(range(1, 10))
    hashes = prompt_block_hashes(prompt, 4)
    for holder in ("a", "b"):
        a = FakeHost("a", digest_hashes=hashes if holder == "a" else [])
        b = FakeHost("b", digest_hashes=hashes if holder == "b" else [])
        with _router([a, b]) as r:
            got = r.submit(_gpt_payload(prompt),
                           session="fresh-session").result(5)
            assert got == holder
