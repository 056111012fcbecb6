"""RouterGroup: the horizontally scaled router tier front.
Dispatch determinism, member failover (sync-dead and died-after-accept),
fleet-verdict propagation, and the chaos bar — kill one of two routers
mid-soak with zero lost accepted requests and the survivor's placements
agreeing with steady state.
"""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from sparkdl_torch.fabric import (
    AllRoutersUnavailableError,
    Router,
    RouterGroup,
    RouterHandle,
    RouterServer,
)
from sparkdl_torch.fabric.digest import prompt_block_hashes, session_key
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.serving import QueueFullError

from torch_fabric_fakes import FakeHost, fast_postmortems  # noqa: F401
from torch_fabric_fakes import gpt_payload as _gpt_payload
from torch_fabric_fakes import make_router as _router
from torch_fabric_fakes import metric as _metric


def _metric(name, label=""):
    fam = registry().snapshot().get(name) or {}
    return (fam.get("values") or {}).get(label, 0)


def _group(n_routers, hosts_fn, **router_kw):
    """N routers over N *independent but identically named* FakeHost
    fleets (each router owns its view, like real router processes over
    one physical fleet)."""
    routers = [_router(hosts_fn(), **router_kw) for _ in range(n_routers)]
    return RouterGroup(routers), routers


def test_group_dispatches_and_sessions_pin_to_one_member():
    g, routers = _group(2, lambda: [FakeHost("a"), FakeHost("b")])
    try:
        assert g.submit(_gpt_payload()).result(5) in ("a", "b")
        # a session always enters through the same member, so that
        # member's sticky LRU stays the single warm fast-path
        want = session_key("sess-7") % 2
        for _ in range(4):
            g.submit(_gpt_payload(), session="sess-7").result(5)
        other = routers[1 - want]
        assert "sess-7" not in other._sessions
        assert "sess-7" in routers[want]._sessions
    finally:
        g.close(close_members=True)


def test_group_skips_closed_member_and_propagates_fleet_verdicts():
    g, routers = _group(2, lambda: [FakeHost("a")])
    try:
        routers[0].close()
        for _ in range(4):  # every dispatch lands on the live member
            assert g.submit(_gpt_payload()).result(5) == "a"
        # a live router's QueueFullError speaks for the FLEET: the
        # group must NOT mask it as router death
        with routers[1]._lock:
            routers[1]._hosts["a"].outstanding = 10 ** 6
        with pytest.raises(QueueFullError):
            g.submit(_gpt_payload())
        routers[1].close()
        with pytest.raises(AllRoutersUnavailableError):
            g.submit(_gpt_payload())
    finally:
        g.close(close_members=True)


def test_member_killed_holding_requests_fails_over_not_loses():
    """The async leg: a member accepts, then its host fails with a
    router-level error (the kill-mid-flight shape). The group must
    re-dispatch the accepted request through the next member."""
    from sparkdl_torch.fabric.host import HostUnavailableError

    dead_host = FakeHost("a")
    dead_host.fail_with = HostUnavailableError("router process died")
    live_host = FakeHost("a")
    r_dead = _router([dead_host], max_failovers=0)
    r_live = _router([live_host], max_failovers=0)
    g = RouterGroup([r_dead, r_live])
    try:
        failovers0 = _metric("sparkdl_fabric_router_failovers_total")
        results = [g.submit(_gpt_payload()).result(5) for _ in range(4)]
        assert results == ["a"] * 4  # every request completed
        assert (_metric("sparkdl_fabric_router_failovers_total")
                - failovers0) >= 2  # the dead member's share walked on
    finally:
        g.close(close_members=True)


def test_router_kill_chaos_soak_zero_lost_and_placements_hold():
    """The router tier's chaos bar: N=2 routers, kill one mid-soak. Every
    accepted request resolves (zero lost), and the survivor's
    placements for the same prompts agree with steady state within 10%
    — deterministic placement means a dead router changes WHO routes,
    not WHERE traffic lands."""
    prompts = [[(13 * i + j) % 89 + 1 for j in range(9)]
               for i in range(40)]
    hashes = {i: prompt_block_hashes(p, 4)
              for i, p in enumerate(prompts)}

    def fleet():
        # both routers see hosts with identical ids AND digests, the
        # cross-process shape (one physical fleet, two views)
        return [FakeHost("a", digest_hashes=[h[0] for h in
                                             hashes.values()][:20]),
                FakeHost("b")]

    g, routers = _group(2, fleet)
    try:
        # steady state: both members live
        steady = {}
        futs = []
        for i, p in enumerate(prompts):
            futs.append((i, g.submit({"prompt": p,
                                      "max_new_tokens": 2})))
        for i, f in futs:
            steady[i] = f.result(5)
        # soak with a mid-stream kill on a background thread
        results: "dict[int, str]" = {}
        errors: "list[BaseException]" = []
        killed = threading.Event()

        def killer():
            time.sleep(0.01)
            routers[0].close()
            killed.set()

        t = threading.Thread(target=killer)
        t.start()
        futs = []
        for rnd in range(5):  # 200 submits spanning the kill
            for i, p in enumerate(prompts):
                try:
                    futs.append((i, g.submit(
                        {"prompt": p, "max_new_tokens": 2})))
                except Exception as e:  # NEVER expected
                    errors.append(e)
        for i, f in futs:
            try:
                results[i] = f.result(10)
            except Exception as e:
                errors.append(e)
        t.join()
        assert killed.is_set() and routers[0].closed
        assert not errors, f"lost accepted requests: {errors[:3]}"
        assert len(futs) == 200
        # survivor placements match steady state within 10%
        agree = sum(results[i] == steady[i] for i in steady)
        assert agree >= 0.9 * len(steady), (agree, len(steady))
    finally:
        g.close(close_members=True)


# -- the HTTP member ----------------------------------------------------------

class TokenHost(FakeHost):
    """Resolves with token arrays (the wire shape) instead of host
    ids."""

    def submit(self, payload, *, timeout_s=None):
        fut = Future()
        if self.fail_with is not None:
            fut.set_exception(self.fail_with)
        else:
            self.submits.append(payload)
            fut.set_result(np.asarray([1, 2, 3], np.int32))
        return fut


def test_http_router_member_round_trip_and_death_detection():
    """A RouterServer/RouterHandle pair behaves as a group member: the
    wire round-trips tokens and sessions, and transport death flips
    ``closed`` so the group stops offering it work."""
    inner = _router([TokenHost("a"), TokenHost("b")])
    srv = RouterServer(inner)
    try:
        handle = RouterHandle(srv.url, connect_timeout_s=5,
                              result_timeout_s=10)
        g = RouterGroup([handle])
        got = g.submit(_gpt_payload([5, 6, 7]),
                       session="s-http").result(10)
        assert got.tolist() == [1, 2, 3]
        assert "s-http" in inner._sessions  # the session crossed the wire
        snap = handle.snapshot()
        assert snap["replica_count"] == 2
        # kill the server: the member marks itself closed on the next
        # failed call and the group walks on (here: group exhausts)
        srv.close()
        fut = g.submit(_gpt_payload())
        with pytest.raises(Exception):
            fut.result(10)
        assert handle.closed
        with pytest.raises(AllRoutersUnavailableError):
            g.submit(_gpt_payload())
        g.close()
    finally:
        srv.close()
        inner.close()
