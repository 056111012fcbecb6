"""Cross-host identity for disaggregated requests: fleet-unique
host-qualified trace ids survive adoption without collision, span
contexts and incident ids ride the handoff wire, and both tiers'
postmortem bundles join on one incident, and a split request resolves
to ONE stitched fleet trace whose phase breakdown telescopes to its
end-to-end latency."""

import json
import time

import numpy as np
import pytest

from sparkdl_torch.disagg import DecodeWorker, PhaseRouter, PrefillWorker
from sparkdl_torch.disagg.handoff import KVHandoff
from sparkdl_torch.fabric.host import InProcessHost
from sparkdl_torch.observability import flight, tracing
from sparkdl_torch.observability.fleet import FleetScraper
from sparkdl_torch.reliability import faults
from sparkdl_torch.reliability.faults import inject

MAX_LEN = 40


@pytest.fixture(scope="module")
def bundle():
    from torch_parity import gpt_pair

    _, _, module = gpt_pair(0)
    return module.config, module


@pytest.fixture
def traced():
    tracing.clear_trace()
    tracing.enable_tracing()
    try:
        yield
    finally:
        tracing.disable_tracing()
        tracing.clear_trace()


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


def _tick_until(engines, futs, timeout_s=60.0):
    t0 = time.monotonic()
    while not all(f.done() for f in futs):
        for e in engines:
            e.tick()
        assert time.monotonic() - t0 < timeout_s, "stalled"
    return futs


def _foreign_id(n=1):
    """An id minted by a DIFFERENT host: same layout, different hash."""
    other = (tracing.host_hash() ^ 0x2AAAAAAA) & 0x7FFFFFFF or 1
    assert other != tracing.host_hash()
    return (other << tracing.HOST_ID_SHIFT) | n


# -- host-qualified id space --------------------------------------------------

def test_request_ids_carry_this_hosts_hash():
    rid = tracing.next_request_id()
    assert tracing.host_of_id(rid) == tracing.host_hash()
    assert tracing.host_hash() > 0  # 31-bit, never 0


def test_set_trace_host_moves_the_id_space():
    h0 = tracing.host_hash()
    try:
        h1 = tracing.set_trace_host("some-other-host:424242")
        assert h1 != h0
        assert tracing.host_of_id(tracing.next_request_id()) == h1
    finally:
        assert tracing.set_trace_host(
            tracing._default_host_identity()) == h0


def test_adopted_foreign_id_is_preserved_and_collision_free(bundle):
    """A DecodeWorker adopting a handoff minted on
    another host keeps the FOREIGN id verbatim, and no local mint can
    ever equal it — the host hash in the high bits partitions the id
    space, so the old small-int collision window is structurally
    closed."""
    cfg, module = bundle
    pre = PrefillWorker(cfg, module, **_kw())
    dec = DecodeWorker(cfg, module, **_kw())
    try:
        (h,) = _drain(pre, [pre.submit(list(range(1, 10)), 4)])
        h.request_id = _foreign_id(1)
        h.trace_ctx = None  # the id alone must carry identity
        fut = dec.submit_handoff(h)
        assert fut.request_id == h.request_id
        assert tracing.host_of_id(fut.request_id) != tracing.host_hash()
        # the local counter keeps minting in ITS half of the space:
        # even the same low 32 bits cannot collide with the adoptee
        mints = [tracing.next_request_id() for _ in range(2000)]
        assert h.request_id not in mints
        assert all(tracing.host_of_id(m) == tracing.host_hash()
                   for m in mints)
        (r,) = _drain(dec, [fut])
        assert len(np.asarray(r)) == 4
    finally:
        pre.close()
        dec.close()


def test_links_fan_in_mixes_local_and_foreign_riders(traced):
    """A batch span serving a LOCAL request and an ADOPTED foreign one
    fans into both traces via ``links`` — host-qualified ids keep the
    two riders distinct inside one links list."""
    local = tracing.next_request_id()
    foreign = _foreign_id(7)
    with tracing.span("serving.queue_wait",
                      parent=tracing.request_context(local),
                      request_id=local):
        pass
    with tracing.span("disagg.handoff_install",
                      parent=tracing.request_context(foreign),
                      request_id=foreign):
        pass
    batch = tracing.new_trace_context()
    with tracing.span("serving.device_step", parent=batch,
                      links=[local, foreign]):
        pass
    for rid, own in ((local, "serving.queue_wait"),
                     (foreign, "disagg.handoff_install")):
        names = [e["name"] for e in tracing.spans_for_trace(rid)]
        assert own in names
        assert "serving.device_step" in names
    # the fan-in does NOT bleed the riders into each other's traces
    assert "disagg.handoff_install" not in [
        e["name"] for e in tracing.spans_for_trace(local)]


# -- span context + incident id on the wire -----------------------------------

def test_span_context_rides_the_handoff_wire(traced):
    rid = tracing.next_request_id()
    ctx = tracing.request_context(rid)
    h = KVHandoff(
        prompt=np.asarray([1, 2], np.int32), max_new_tokens=2,
        first_token=3, kv_dtype="float32", block_size=4,
        k=np.zeros((1, 1, 4, 1, 2), np.float32),
        v=np.zeros((1, 1, 4, 1, 2), np.float32),
        request_id=rid, trace_ctx=ctx)
    h2 = KVHandoff.from_wire(json.loads(json.dumps(h.to_wire())))
    assert h2.trace_ctx is not None
    assert h2.trace_ctx.trace_id == rid
    assert h2.trace_ctx.span_id == ctx.span_id
    assert h2.arrived_at is not None


def test_span_context_wire_is_zero_with_tracing_off():
    assert not tracing.tracing_enabled()
    assert tracing.context_to_wire(None) is None
    # a traced sender's context reaches an untraced receiver as None —
    # the receiver pays nothing, matching request_context's convention
    assert tracing.context_from_wire(
        {"trace_id": 1, "span_id": 2}) is None


def test_incident_id_rides_wire_and_adoption_is_first_writer_wins(
        bundle):
    """The wire half: a live incident at export time crosses
    inside the handoff; a second recorder adopting it joins the SAME
    incident, and a later adoption cannot overwrite a live one."""
    cfg, module = bundle
    rec = flight.flight_recorder()
    rec.reset_incident()
    pre = PrefillWorker(cfg, module, **_kw())
    try:
        # no incident live: the wire stays clean
        (h0,) = _drain(pre, [pre.submit(list(range(1, 8)), 2)])
        assert h0.incident_id is None
        assert "incident_id" not in h0.to_wire()
        # mid-incident: the export stamps the live id
        rec.adopt_incident("inc-test-cafe")
        (h1,) = _drain(pre, [pre.submit(list(range(11, 18)), 2)])
        assert h1.incident_id == "inc-test-cafe"
        h2 = KVHandoff.from_wire(json.loads(json.dumps(h1.to_wire())))
        assert h2.incident_id == "inc-test-cafe"
        # the receiving tier (a SEPARATE recorder = separate process)
        # adopts: its bundles now join the sender's
        peer = flight.FlightRecorder(capacity=64)
        peer.adopt_incident(h2.incident_id)
        assert peer.dump("probe")["incident_id"] == "inc-test-cafe"
        # first writer wins while the incident is live
        peer.adopt_incident("inc-usurper")
        assert peer.current_incident_id() == "inc-test-cafe"
        # TTL expiry opens the window again
        peer.incident_ttl_s = 0.02
        time.sleep(0.05)
        assert peer.current_incident_id() is None
        peer.adopt_incident("inc-next-week")
        assert peer.current_incident_id() == "inc-next-week"
    finally:
        rec.reset_incident()
        pre.close()


def test_prefill_kill_chaos_bundles_share_one_incident(
        bundle, tmp_path):
    """The chaos half: kill a prefill host mid-stream AND
    fault an install — the router's ``host_failover`` postmortem and
    the PhaseRouter's ``disagg.handoff_lost`` postmortem carry ONE
    incident id, so the two tiers' bundles join at the postmortem
    desk."""
    cfg, module = bundle
    rec = flight.flight_recorder()
    rec.reset_incident()
    old = (rec.directory, rec.settle_s, rec.min_interval_s)
    rec.configure(directory=str(tmp_path), settle_s=0, min_interval_s=0)
    pres = [PrefillWorker(cfg, module, host_id=f"p{i}",
                          **_kw(auto_start=True)) for i in range(2)]
    dec = DecodeWorker(cfg, module, host_id="d0",
                       **_kw(auto_start=True))
    pr = PhaseRouter([InProcessHost(e, host_id=e.host_id) for e in pres],
                     [InProcessHost(dec, host_id="d0")],
                     auto_refresh=False, max_failures=1,
                     max_handoff_retries=4)
    rng = np.random.RandomState(3)
    try:
        with inject("handoff.install@2"):
            futs = []
            for i in range(10):
                p = rng.randint(0, 50, size=rng.randint(4, 12)).tolist()
                futs.append(pr.submit(p, 3))
                if i == 4:
                    # hard-kill p0: its engine dies under the router,
                    # whose next placement there quarantines the host
                    # and fires the host_failover postmortem
                    pres[0].close(timeout_s=30)
            for f in futs:
                assert len(np.asarray(f.result(timeout=60))) == 3
        bundles = sorted(tmp_path.glob("flight-*.json"))
        assert bundles, "no postmortem written"
        docs = [json.loads(b.read_text()) for b in bundles]
        reasons = {d["reason"] for d in docs}
        assert "disagg.handoff_lost" in reasons
        incidents = {d["incident_id"] for d in docs}
        assert len(incidents) == 1
        (incident,) = incidents
        assert incident  # joined, and not on a null id
    finally:
        rec.configure(directory=old[0], settle_s=old[1],
                      min_interval_s=old[2])
        rec.reset_incident()
        pr.close()
        for e in pres + [dec]:
            e.close()


# -- one stitched trace for one split request ---------------------------------

def test_split_request_resolves_to_one_stitched_trace(bundle, traced):
    """The acceptance path: prefill tier -> handoff -> decode tier,
    stitched by a FleetScraper registered off the PhaseRouter — BOTH
    tiers' spans, exactly one ``handoff.wire``, and a five-phase
    breakdown that telescopes to the measured end-to-end latency."""
    cfg, variables = bundle
    pre = PrefillWorker(cfg, variables, host_id="p0", **_kw())
    dec = DecodeWorker(cfg, variables, host_id="d0", **_kw())
    pr = PhaseRouter([InProcessHost(pre, host_id="p0")],
                     [InProcessHost(dec, host_id="d0")],
                     auto_refresh=False)
    try:
        t0 = time.monotonic()
        fut = pr.submit(list(range(1, 11)), 4)
        _tick_until([pre, dec], [fut])
        assert len(np.asarray(fut.result(timeout=0))) == 4
        e2e = time.monotonic() - t0

        wire = [e for e in tracing.trace_events()
                if e["name"] == "handoff.wire"]
        assert len(wire) == 1
        rid = wire[0]["args"]["request_id"]
        assert tracing.host_of_id(rid) == tracing.host_hash()

        scraper = FleetScraper.from_phase_router(pr)
        assert scraper.tier_of("p0") == "prefill"
        assert scraper.tier_of("d0") == "decode"
        out = scraper.fleet_trace(rid)
        names = [e["name"] for e in out["spans"]]
        assert names.count("handoff.wire") == 1
        assert "disagg.handoff_export" in names   # prefill tier worked
        assert "disagg.handoff_install" in names  # decode tier worked
        assert "serving.queue_wait" in names
        # stitched order: export ends before the wire span closes
        assert names.index("disagg.handoff_export") \
            < names.index("handoff.wire")
        # phases telescope to the measured end-to-end latency
        total = sum(p["seconds"] for p in out["phases"])
        assert total > 0
        assert abs(total - e2e) < 0.25 * e2e + 0.1, (total, e2e)
    finally:
        pr.close()
        pre.close()
        dec.close()
