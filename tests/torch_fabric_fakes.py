"""Shared fakes for the port's fabric tests: a scripted host (submits
resolve instantly or fail on demand; capacity, digest and health are
plain fields a test mutates) and the router factory the suites use.
"""

import threading
from concurrent.futures import Future

import pytest

from sparkdl_torch.fabric import HostHandle, Router
from sparkdl_torch.observability import flight
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.reliability.faults import fault_point

BS = 4


def metric(name, label=""):
    fam = registry().snapshot().get(name) or {}
    return (fam.get("values") or {}).get(label, 0)


@pytest.fixture(autouse=True)
def fast_postmortems():
    """Quarantine postmortems must not be coalesced away by an earlier
    test's dump (the production 10s rate limit) or settle for 0.25s."""
    rec = flight.flight_recorder()
    prev = (rec.settle_s, rec.min_interval_s)
    rec.configure(settle_s=0.01, min_interval_s=0.0)
    yield
    rec.configure(settle_s=prev[0], min_interval_s=prev[1])


class FakeHost(HostHandle):
    """A scripted host: submits resolve instantly (or fail via
    ``fail_with``); capacity/digest/health are plain dicts the test
    mutates."""

    def __init__(self, host_id, *, n_slots=4, replica_count=1,
                 max_queue_depth=16, digest_hashes=None, block_size=BS):
        self.host_id = host_id
        self.n_slots = n_slots
        self.replica_count = replica_count
        self.max_queue_depth = max_queue_depth
        self.digest_hashes = digest_hashes
        self.block_size = block_size
        self.fail_with = None
        self.status = "ok"
        self.submits = []
        self.hold = None  # threading.Event: submits resolve when set

    def submit(self, payload, *, timeout_s=None):
        fault_point("host.submit")  # the real handles' site, mirrored
        fut = Future()
        if self.fail_with is not None:
            fut.set_exception(self.fail_with)
            return fut
        self.submits.append(payload)
        if self.hold is not None:
            def waiter(fut=fut):
                self.hold.wait(5)
                fut.set_result(self.host_id)
            threading.Thread(target=waiter, daemon=True).start()
        else:
            fut.set_result(self.host_id)
        return fut

    def snapshot(self):
        return {"host_id": self.host_id, "capacity": self.capacity()}

    def capacity(self):
        return {"host_id": self.host_id,
                "replica_count": self.replica_count,
                "n_slots": self.n_slots, "free_slots": self.n_slots,
                "kv_blocks_free": None, "kv_blocks_total": None,
                "queue_depth": 0,
                "max_queue_depth": self.max_queue_depth,
                "draining": False}

    def health(self):
        return {"status": self.status, "host_id": self.host_id}

    def prefix_digest(self, max_entries=1024):
        if self.digest_hashes is None:
            return None
        return {"host_id": self.host_id, "block_size": self.block_size,
                "version": 1, "hashes": list(self.digest_hashes)}

    def drain(self):
        fault_point("host.drain")
        return []

    def close(self, *, timeout_s=30.0):
        pass


def make_router(hosts, **kw):
    kw.setdefault("auto_refresh", False)
    kw.setdefault("probation_s", 0.05)
    return Router(hosts, **kw)


def gpt_payload(prompt=(1, 2, 3)):
    return {"prompt": list(prompt), "max_new_tokens": 2}
