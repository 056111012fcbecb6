"""Cross-tier failure surfaces: the zero-loss contract must
survive the tier crossing.

Covered here: the ``handoff.export`` site (prefill-side teardown —
blocks released, victim re-queued at the HEAD, ahead of later
arrivals), the ``handoff.install`` site (typed
:class:`HandoffInstallError` the PhaseRouter answers with a
prefill-tier requeue), identity preservation across the crossing
(request id, deadline, enqueue stamp), deadline expiry mid-handoff
(no block leaks on either tier), malformed handoffs (refused before
admission takes a block, in process and over HTTP; an install that
raises hands its blocks back), and a chaos soak that kills a prefill
host mid-stream under install faults — zero accepted requests lost,
counters reconciled."""

import dataclasses
import time

import numpy as np
import pytest

from sparkdl_torch.disagg import (
    DecodeWorker,
    HandoffInstallError,
    PhaseRouter,
    PrefillWorker,
)
from sparkdl_torch.fabric import HostServer, HttpHostHandle
from sparkdl_torch.fabric.host import InProcessHost
from sparkdl_torch.reliability import faults
from sparkdl_torch.reliability.faults import inject
from sparkdl_torch.serving.queue import DeadlineExceededError

MAX_LEN = 40


@pytest.fixture(scope="module")
def bundle():
    from torch_parity import gpt_pair

    _, _, module = gpt_pair(0)
    return module.config, module


def setup_function(_fn):
    faults.disarm()


def _kw(**over):
    kw = dict(n_slots=2, max_len=MAX_LEN, auto_start=False,
              kv_block_size=4, prefill_chunk=8)
    kw.update(over)
    return kw


def _drain(engine, futs):
    while not all(f.done() for f in futs):
        engine.tick()
    return [f.result(timeout=0) for f in futs]


def _tick_until(engines, futs, timeout_s=30.0):
    t0 = time.monotonic()
    while not all(f.done() for f in futs):
        for e in engines:
            e.tick()
        assert time.monotonic() - t0 < timeout_s, "stalled"
    return futs


# -- export-side faults -------------------------------------------------------

def test_export_fault_releases_blocks_and_requeues_at_head(bundle):
    """An injected ``handoff.export`` fault tears down like _sp_abort:
    every pool block released, the victim back at the QUEUE HEAD, and
    the re-run succeeds — zero loss, no leak."""
    cfg, module = bundle
    pre = PrefillWorker(cfg, module, **_kw(n_slots=1))
    try:
        free0 = pre._pool.free_count
        with inject("handoff.export@1"):
            fut = pre.submit(list(range(1, 10)), 4)
            # first attempt aborts; the SAME engine retries from the
            # queue head and succeeds on the second pass
            (h,) = _drain(pre, [fut])
        assert h.first_token >= 0
        assert pre._export_aborts == 1
        assert pre._handoffs == 1
        # abort released everything; the success holds only the cached
        # prompt blocks — evicting them returns the pool to baseline
        pre._prefix.evict(pre._pool.n_blocks)
        assert pre._pool.free_count == free0
    finally:
        pre.close()


def test_export_abort_requeues_ahead_of_later_arrivals(bundle):
    """The faulted victim is OWED its place: with one slot, the abort
    puts it back ahead of requests that arrived after it."""
    cfg, module = bundle
    pre = PrefillWorker(cfg, module, **_kw(n_slots=1))
    try:
        with inject("handoff.export@1"):
            fa = pre.submit(list(range(1, 9)), 4)    # victim
            fb = pre.submit(list(range(11, 19)), 4)  # later arrival
            pre.tick()  # admits A; prefill + export fault -> requeue
            ids = [r.request_id for r in pre.queue._dq]
            assert ids == sorted(ids) and len(ids) == 2
            assert ids[0] == fa.request_id  # victim ahead of B
            _drain(pre, [fa, fb])
        assert fa.result(timeout=0).request_id == fa.request_id
        assert fb.result(timeout=0).request_id == fb.request_id
    finally:
        pre.close()


# -- install-side faults ------------------------------------------------------

def test_install_fault_raises_typed_error_and_leaks_nothing(bundle):
    cfg, module = bundle
    pre = PrefillWorker(cfg, module, **_kw())
    dec = DecodeWorker(cfg, module, **_kw())
    try:
        (h,) = _drain(pre, [pre.submit(list(range(1, 10)), 4)])
        free0 = dec._pool.free_count
        with inject("handoff.install@1"):
            fut = dec.submit_handoff(h)
            while not fut.done():
                dec.tick()
        with pytest.raises(HandoffInstallError):
            fut.result(timeout=0)
        assert dec._install_faults == 1
        assert dec._pool.free_count == free0  # fault fired pre-alloc
        # the same handoff installs cleanly afterwards
        (r,) = _drain(dec, [dec.submit_handoff(h)])
        assert len(np.asarray(r)) == 4
    finally:
        pre.close()
        dec.close()


def test_phase_router_requeues_install_victim_ahead_of_later_arrivals(
        bundle):
    """The cross-tier half of the requeue-ordering contract: a handoff
    lost at the DECODE tier re-enters the PREFILL tier's queue head —
    ahead of requests that arrived while it was crossing."""
    cfg, module = bundle
    pre = PrefillWorker(cfg, module, **_kw(n_slots=1))
    dec = DecodeWorker(cfg, module, **_kw())
    pr = PhaseRouter([InProcessHost(pre, host_id="p0")],
                     [InProcessHost(dec, host_id="d0")],
                     auto_refresh=False)
    try:
        with inject("handoff.install@1"):
            fa = pr.submit(list(range(1, 10)), 4)  # the victim
            while dec.queue.depth == 0:  # A crosses to the decode tier
                pre.tick()
            fb = pr.submit(list(range(11, 20)), 4)  # later arrivals
            fc = pr.submit(list(range(21, 30)), 4)
            depth0 = pre.queue.depth
            assert depth0 == 2  # B, C waiting
            dec.tick()  # install fault -> victim back at prefill HEAD
            ids = [r.request_id for r in pre.queue._dq]
            assert len(ids) == 3
            assert ids[0] == min(ids)  # A (earliest id) leads the queue
            _tick_until([pre, dec], [fa, fb, fc])
        snap = pr.snapshot()["disagg"]
        assert snap["requeues"] == 1
        assert snap["failed"] == 0
        assert snap["completed"] == 3
        for f in (fa, fb, fc):
            assert len(np.asarray(f.result(timeout=0))) == 4
    finally:
        pr.close()
        pre.close()
        dec.close()


def test_identity_survives_the_tier_crossing(bundle):
    """One request, one identity: the decode-side Future carries the
    PREFILL-side request id, and the handoff's deadline still binds."""
    cfg, module = bundle
    pre = PrefillWorker(cfg, module, **_kw())
    dec = DecodeWorker(cfg, module, **_kw())
    try:
        fut = pre.submit(list(range(1, 8)), 5, timeout_s=60.0)
        (h,) = _drain(pre, [fut])
        assert h.request_id == fut.request_id
        assert h.deadline is not None
        dfut = dec.submit_handoff(h)
        assert dfut.request_id == h.request_id
        (r,) = _drain(dec, [dfut])
        assert len(np.asarray(r)) == 5
    finally:
        pre.close()
        dec.close()


def test_deadline_expiry_mid_handoff_leaks_no_blocks(bundle):
    """A handoff whose deadline lapses while queued at the decode tier
    fails typed and allocates NOTHING: the staging copy lives on the
    wire object, not in either pool, so expiry cannot leak."""
    cfg, module = bundle
    pre = PrefillWorker(cfg, module, **_kw())
    dec = DecodeWorker(cfg, module, **_kw())
    try:
        (h,) = _drain(pre, [pre.submit(list(range(1, 10)), 4)])
        h.deadline = time.monotonic() - 0.01  # lapsed in transit
        free0 = dec._pool.free_count
        fut = dec.submit_handoff(h)
        while not fut.done():
            dec.tick()
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=0)
        assert dec._pool.free_count == free0
        assert dec._installs == 0
        # prefill side released its holds at export: evicting the
        # cached prompt blocks returns that pool to full too
        pre._prefix.evict(pre._pool.n_blocks)
        assert pre._pool.free_count == pre._pool.n_blocks
    finally:
        pre.close()
        dec.close()


# -- malformed handoffs -------------------------------------------------------

@pytest.fixture(scope="module")
def tiers(bundle):
    """Per pool dtype: an idle DecodeWorker and a well-formed handoff of
    a 9-token prompt (3 blocks of 4) from a PrefillWorker."""
    cfg, module = bundle
    out = {}
    for dt in ("fp32", "int8"):
        pre = PrefillWorker(cfg, module, **_kw(kv_dtype=dt))
        (h,) = _drain(pre, [pre.submit(list(range(1, 10)), 4)])
        pre.close()
        out[dt] = (DecodeWorker(cfg, module, **_kw(kv_dtype=dt)), h)
    yield out
    for dec, _ in out.values():
        dec.close()


def _ones(a):
    return np.ones_like(a, dtype=np.float32)


MALFORMED = {
    "one-block-short": ("fp32", lambda h, c: dict(k=h.k[:, :-1],
                                                  v=h.v[:, :-1])),
    "one-block-over": ("int8", lambda h, c: dict(
        k=np.concatenate([h.k, h.k[:, :1]], 1))),
    "wrong-head-count": ("fp32", lambda h, c: dict(k=h.k[..., :1, :])),
    "wrong-block-size": ("fp32", lambda h, c: dict(k=h.k[:, :, :2],
                                                   v=h.v[:, :, :2])),
    "scales-on-a-float-wire": ("fp32", lambda h, c: dict(
        k_scale=_ones(h.k[..., 0, 0]), v_scale=_ones(h.v[..., 0, 0]))),
    "scales-missing": ("int8", lambda h, c: dict(k_scale=None,
                                                 v_scale=None)),
    "scale-one-block-short": ("int8", lambda h, c: dict(
        v_scale=h.v_scale[:, :-1])),
    "float-codes-on-an-int8-wire": ("int8", lambda h, c: dict(
        k=h.k.astype(np.float32))),
    "first-token-outside-vocab": ("fp32", lambda h, c: dict(
        first_token=c.vocab_size)),
    "empty-prompt": ("fp32", lambda h, c: dict(prompt=[])),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_handoff_is_refused_before_admission(bundle, tiers, case):
    """A handoff whose arrays do not hold the prompt's blocks in the
    tier's pool geometry (or whose scales do not match its dtype) raises
    ValueError at ``submit_handoff``: nothing is queued and no block is
    taken. Before this check such a wire raised mid-install, after the
    blocks were allocated."""
    cfg, _ = bundle
    dt, change = MALFORMED[case]
    dec, h = tiers[dt]
    free0, depth0 = dec._pool.free_count, dec.queue.depth
    bad = dataclasses.replace(h, **change(h, cfg))
    with pytest.raises(ValueError, match="handoff"):
        dec.submit_handoff(bad)
    assert (dec._pool.free_count, dec.queue.depth) == (free0, depth0)


def test_install_that_raises_hands_its_blocks_back(tiers, monkeypatch):
    """An install that fails after admission allocated (here: the pool
    write raises) fails THAT request and releases its owned and shared
    blocks; the next handoff installs cleanly."""
    dec, h = tiers["int8"]
    free0 = dec._pool.free_count

    def broken(*_a, **_k):
        raise RuntimeError("pool write failed")

    monkeypatch.setattr(dec, "_q_write", broken)
    fut = dec.submit_handoff(dataclasses.replace(h))
    while not fut.done():
        dec.tick()
    with pytest.raises(RuntimeError, match="pool write failed"):
        fut.result(timeout=0)
    assert dec._pool.free_count == free0
    monkeypatch.undo()
    (r,) = _drain(dec, [dec.submit_handoff(dataclasses.replace(h))])
    assert len(np.asarray(r)) == 4


def test_malformed_wire_over_http_is_a_value_error(bundle):
    """The same refusal from outside: a malformed handoff POSTed to a
    decode tier's ``HostServer`` comes back as HTTP 400, re-raised as
    ValueError by ``HttpHostHandle``, and the tier's pool is untouched."""
    cfg, module = bundle
    pre = PrefillWorker(cfg, module, **_kw(kv_dtype="int8"))
    (h,) = _drain(pre, [pre.submit(list(range(1, 10)), 4)])
    pre.close()
    dec = DecodeWorker(cfg, module, **_kw(kv_dtype="int8", auto_start=True,
                                          host_id="http-dec"))
    try:
        with HostServer(dec) as server:
            handle = HttpHostHandle(server.url)
            free0 = dec._pool.free_count
            bad = dataclasses.replace(h, k=h.k[:, :-1], k_scale=None)
            with pytest.raises(ValueError, match="handoff k has shape"):
                handle.submit({"handoff": bad}).result(timeout=60)
            assert dec._pool.free_count == free0
            out = handle.submit({"handoff": h}).result(timeout=60)
            assert len(np.asarray(out)) == 4
            handle.close()
    finally:
        dec.close()


# -- chaos soak ---------------------------------------------------------------

def test_soak_prefill_host_kill_and_install_faults_lose_nothing(bundle):
    """The acceptance bar: a stream of requests through a 2-prefill /
    2-decode fabric, one prefill host killed mid-soak, install faults
    throughout — every accepted request completes with correct-length
    output and the PhaseRouter's counters reconcile.

    The faults are counted (the 3rd to 6th install hits fail), not
    drawn: two decode threads hit the site in an order the scheduler
    picks, so a probability plan would draw a different fault set under
    every load — the count of faults, and so of requeues, is fixed."""
    cfg, module = bundle
    pres = [PrefillWorker(cfg, module, host_id=f"p{i}",
                          **_kw(auto_start=True)) for i in range(2)]
    decs = [DecodeWorker(cfg, module, host_id=f"d{i}",
                         **_kw(auto_start=True)) for i in range(2)]
    pr = PhaseRouter([InProcessHost(e, host_id=e.host_id) for e in pres],
                     [InProcessHost(e, host_id=e.host_id) for e in decs],
                     auto_refresh=False, max_handoff_retries=4)
    rng = np.random.RandomState(7)
    try:
        with inject("handoff.install@3*4"):
            futs = []
            for i in range(24):
                p = rng.randint(0, 50, size=rng.randint(4, 14)).tolist()
                futs.append((pr.submit(p, 4), 4))
                if i == 11:
                    # kill one prefill host mid-soak: drain re-queues
                    # its unstarted work on the survivor
                    pr.prefill.remove_host("p0", drain=True)
            for f, m in futs:
                out = np.asarray(f.result(timeout=300))
                assert len(out) == m
        snap = pr.snapshot()["disagg"]
        assert snap["submitted"] == 24
        assert snap["completed"] == 24
        assert snap["failed"] == 0
        assert snap["requeues"] == 4  # every injected fault, requeued
    finally:
        pr.close()
        for e in pres + decs:
            e.close()
