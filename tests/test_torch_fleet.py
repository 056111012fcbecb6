"""The port's fleet observability plane against the JAX package's:
clock-offset estimation, skew-corrected cross-host trace stitching,
phase attribution and the ``/fleet/*`` endpoints — against duck-typed
fake hosts with RIGGED clocks (the reference's tests, ported), then
``stitch_phase_breakdown`` held exactly to the reference's on the same
span lists, and the clock probe over the port's real transports
(``InProcessHost`` and ``HttpHostHandle``).
"""

import json
import urllib.request

import pytest

from sparkdl_torch.observability import tracing
from sparkdl_torch.observability.fleet import (
    PHASES,
    FleetScraper,
    FleetServer,
    stitch_phase_breakdown,
)

#: true-timeline layout of one split request (seconds): submit 0.0,
#: take 0.1, export 0.65, arrive 0.9, admit 1.0, done 1.4 — five phases
#: 0.1 / 0.55 / 0.25 / 0.1 / 0.4 telescoping to a 1.4 s e2e.
E2E_S = 1.4


def _span(name, ts_s, dur_s, host_offset_us, trace_id, span_id, **attrs):
    """One finished-span event as a host with ``host_offset_us`` clock
    skew would report it (its ``ts`` runs AHEAD by the offset)."""
    args = {"trace_id": trace_id, "span_id": span_id}
    args.update(attrs)
    return {"name": name, "ph": "X",
            "ts": ts_s * 1e6 + host_offset_us, "dur": dur_s * 1e6,
            "pid": 1, "tid": 1, "args": args}


class _SkewHost:
    """Duck-typed HostHandle: fixed clock offset, canned spans."""

    def __init__(self, host_id, offset_us, spans=(), *, status="ok",
                 clock=tracing.trace_clock_us):
        self.host_id = host_id
        self.offset_us = offset_us
        self.spans = list(spans)
        self.status = status
        self.trace_calls = 0
        self._clock = clock

    def trace(self, request_id):
        self.trace_calls += 1
        rid = int(request_id)
        return {
            "host_id": self.host_id,
            "now_us": self._clock() + self.offset_us,
            "spans": [s for s in self.spans
                      if s["args"].get("trace_id") == rid],
        }

    def capacity(self):
        return {"host_id": self.host_id, "free_slots": 1}

    def health(self):
        return {"status": self.status, "host_id": self.host_id}

    def snapshot(self):
        return {"host_id": self.host_id, "slo": {"name": self.host_id}}


def _split_spans(rid):
    """The canned split request: prefill host 'pA' runs 5 s AHEAD of
    the scraper clock, decode host 'dB' 3 s BEHIND — uncorrected, dB's
    spans would sort before pA's."""
    pre = [
        _span("serving.queue_wait", 0.0, 0.1, +5_000_000.0, rid, rid + 1,
              request_id=rid),
        _span("disagg.handoff_export", 0.6, 0.05, +5_000_000.0,
              rid, rid + 2, request_id=rid),
    ]
    dec = [
        _span("handoff.wire", 0.65, 0.45, -3_000_000.0, rid, rid + 3,
              request_id=rid, wire_s=0.25, decode_queue_s=0.1,
              queue_wait_s=0.1, prefill_s=0.55),
        _span("serving.request", 1.0, 0.4, -3_000_000.0, rid, rid + 4,
              request_id=rid),
    ]
    return pre, dec


def _split_request_fleet(rid, scraper_cls=FleetScraper,
                         clock=tracing.trace_clock_us):
    pre_spans, dec_spans = _split_spans(rid)
    pre = _SkewHost("pA", +5_000_000.0, pre_spans, clock=clock)
    dec = _SkewHost("dB", -3_000_000.0, dec_spans, clock=clock)
    scraper = scraper_cls(probes=2)
    scraper.add_host(pre, tier="prefill")
    scraper.add_host(dec, tier="decode")
    return scraper, pre, dec


RID = (7 << 32) | 1  # a host-qualified id minted "elsewhere"


# -- the reference's tests, ported ---------------------------------------------

def test_clock_offsets_recover_known_skew():
    scraper, pre, dec = _split_request_fleet(RID)
    offsets = scraper.clock_offsets()
    # in-process RPC round trips are microseconds; the rigged offsets
    # are seconds — recovery to 50 ms is orders of magnitude of margin
    assert offsets["pA"] == pytest.approx(5_000_000.0, abs=50_000)
    assert offsets["dB"] == pytest.approx(-3_000_000.0, abs=50_000)
    # cached: another call fires no new probe RPCs
    calls = pre.trace_calls
    scraper.clock_offsets()
    assert pre.trace_calls == calls
    scraper.clock_offsets(refresh=True)
    assert pre.trace_calls > calls


def test_fleet_trace_stitches_in_skew_corrected_order():
    scraper, _, _ = _split_request_fleet(RID)
    out = scraper.fleet_trace(RID)
    names = [e["name"] for e in out["spans"]]
    # uncorrected, dB (-3 s) would lead; corrected, true wall order:
    assert names == ["serving.queue_wait", "disagg.handoff_export",
                     "handoff.wire", "serving.request"]
    hosts = [e["host"] for e in out["spans"]]
    assert hosts == ["pA", "pA", "dB", "dB"]
    # corrected timeline spans exactly the true e2e window
    t0 = out["spans"][0]["ts"]
    t1 = max(e["ts"] + e["dur"] for e in out["spans"])
    assert (t1 - t0) / 1e6 == pytest.approx(E2E_S, abs=0.05)
    assert out["hosts"]["pA"]["tier"] == "prefill"
    assert out["hosts"]["dB"]["clock_offset_us"] == pytest.approx(
        -3_000_000.0, abs=50_000)


def test_stitched_phases_telescope_to_corrected_e2e():
    scraper, _, _ = _split_request_fleet(RID)
    out = scraper.fleet_trace(RID)
    phases = out["phases"]
    assert [(p["phase"], p["tier"]) for p in phases] == list(PHASES)
    by = {(p["phase"], p["tier"]): p["seconds"] for p in phases}
    assert by[("queue", "prefill")] == pytest.approx(0.1)
    assert by[("compute", "prefill")] == pytest.approx(0.55)
    assert by[("wire", "handoff")] == pytest.approx(0.25)
    assert by[("queue", "decode")] == pytest.approx(0.1)
    assert by[("compute", "decode")] == pytest.approx(0.4, abs=0.06)
    assert sum(by.values()) == pytest.approx(E2E_S, abs=0.06)


def test_stitch_dedups_spans_shared_by_hosts_in_one_process():
    scraper, pre, dec = _split_request_fleet(RID)
    # both hosts report the SAME span (one process, one tracing ring)
    shared = dict(pre.spans[0])
    dec.spans.append(shared)
    out = scraper.fleet_trace(RID)
    span_ids = [e["args"]["span_id"] for e in out["spans"]]
    assert len(span_ids) == len(set(span_ids)) == 4


def test_fleet_trace_survives_a_dead_host():
    scraper, pre, _ = _split_request_fleet(RID)

    class _Dead:
        host_id = "gone"

        def trace(self, rid):
            raise ConnectionError("unreachable")

    scraper.add_host(_Dead())
    out = scraper.fleet_trace(RID)
    assert "error" in out["hosts"]["gone"]
    assert len(out["spans"]) == 4  # the live fragments still stitch


def test_stitch_phase_breakdown_none_without_a_crossing():
    assert stitch_phase_breakdown(
        [_span("serving.request", 0.0, 1.0, 0.0, 5, 6)]) is None


def test_export_fleet_trace_writes_perfetto_json(tmp_path):
    scraper, _, _ = _split_request_fleet(RID)
    path = tmp_path / "fleet.json"
    n = scraper.export_fleet_trace(path, RID)
    assert n == 4
    doc = json.loads(path.read_text())
    rows = {e["host"]: e["pid"] for e in doc["traceEvents"]}
    assert rows["pA"] != rows["dB"]  # one perfetto row per host


def test_fleet_healthz_is_worst_of():
    scraper, _, dec = _split_request_fleet(RID)
    assert scraper.fleet_healthz()["status"] == "ok"
    dec.status = "degraded"
    assert scraper.fleet_healthz()["status"] == "degraded"
    dec.status = "unhealthy"
    report = scraper.fleet_healthz()
    assert report["status"] == "unhealthy"
    assert report["hosts"]["dB"]["status"] == "unhealthy"
    assert report["hosts"]["pA"]["status"] == "ok"


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_fleet_server_endpoints():
    scraper, _, dec = _split_request_fleet(RID)
    with FleetServer(scraper, port=0, host="127.0.0.1") as srv:
        status, body = _get(srv.port, "/fleet/metrics")
        assert status == 200
        assert "sparkdl_fleet_hosts" in body
        status, body = _get(srv.port, "/fleet/slo.json")
        assert status == 200
        doc = json.loads(body)
        assert set(doc["hosts"]) == {"pA", "dB"}
        status, body = _get(srv.port, "/fleet/healthz")
        assert status == 200
        assert json.loads(body)["status"] == "ok"
        status, body = _get(srv.port, f"/fleet/trace/{RID}")
        assert status == 200
        doc = json.loads(body)
        assert [e["name"] for e in doc["spans"]][0] == "serving.queue_wait"
        assert doc["phases"] is not None
        # the HTTP payload is the in-process call's
        assert doc == json.loads(json.dumps(scraper.fleet_trace(RID),
                                            default=repr))
        status, _ = _get(srv.port, "/fleet/trace/not-a-number")
        assert status == 400
        status, _ = _get(srv.port, "/fleet/nowhere")
        assert status == 404
        dec.status = "unhealthy"
        status, _ = _get(srv.port, "/fleet/healthz")
        assert status == 503


def test_add_and_remove_host_keep_the_fleet_gauge():
    from sparkdl_torch.observability.registry import registry

    scraper, pre, _ = _split_request_fleet(RID)
    fam = registry().get("sparkdl_fleet_hosts")
    assert fam.snapshot_values()[""] == 2.0
    scraper.clock_offsets()
    scraper.remove_host("pA")
    assert fam.snapshot_values()[""] == 1.0
    assert "pA" not in scraper.clock_offsets() and scraper.tier_of("pA") is None
    with pytest.raises(ValueError, match="probes"):
        FleetScraper(probes=0)


# -- against the JAX package's scraper ------------------------------------------

def _breakdown_cases():
    pre, dec = _split_spans(RID)
    spans = sorted(pre + dec, key=lambda e: e["ts"])
    requeued = spans + [dict(dec[0], ts=dec[0]["ts"] + 2e6,
                             args=dict(dec[0]["args"], wire_s=0.3,
                                       decode_queue_s=0.05))]
    no_attrs = [dict(dec[0], args={"span_id": 1})] + pre
    return {
        "split": spans,
        "requeued": requeued,  # two crossings: the last one counts
        "wire_only": [dec[0]],
        "attributes_missing": no_attrs,
        "colocated": [e for e in spans if e["name"] != "handoff.wire"],
        "empty": [],
    }


@pytest.mark.parametrize("case", sorted(_breakdown_cases()))
def test_stitch_phase_breakdown_equals_the_references(case):
    from sparkdl_tpu.observability.fleet import (
        stitch_phase_breakdown as ref_breakdown,
    )

    spans = _breakdown_cases()[case]
    assert stitch_phase_breakdown(spans) == ref_breakdown(spans)


def test_fleet_trace_equals_the_references_under_one_clock():
    """Both scrapers over the same rigged hosts, with one frozen clock
    for the probes: the same offsets, stitched spans, fragments and
    phases."""
    from sparkdl_tpu.observability import tracing as ref_tracing
    from sparkdl_tpu.observability.fleet import FleetScraper as RefScraper

    frozen = lambda: 1_000_000.0  # noqa: E731
    outs = []
    for cls, mod in ((RefScraper, ref_tracing), (FleetScraper, tracing)):
        saved = mod.trace_clock_us
        mod.trace_clock_us = frozen
        try:
            scraper, _, _ = _split_request_fleet(RID, cls, clock=frozen)
            outs.append((scraper.clock_offsets(), scraper.fleet_trace(RID),
                         scraper.fleet_healthz()))
        finally:
            mod.trace_clock_us = saved
    assert outs[1] == outs[0]


# -- the clock probe over the port's real transports ---------------------------

@pytest.fixture(scope="module")
def engine():
    from torch_parity import gpt_pair

    from sparkdl_torch.serving import ContinuousGPTEngine

    _, _, module = gpt_pair(0)
    eng = ContinuousGPTEngine(module.config, module, device="cpu",
                              n_slots=2, max_len=32, kv_layout="paged",
                              kv_block_size=4, idle_wait_s=0.001,
                              host_id="probe-0")
    yield eng
    eng.close(drain=False)


def test_clock_probe_over_in_process_and_http_handles(engine):
    """``handle.trace(0)`` answers the probe on both transports: the
    host shares this process's trace clock, so each offset is within
    half a round trip of 0, and a traced request stitches to the same
    spans through either handle."""
    from sparkdl_torch.fabric import HostServer, HttpHostHandle, InProcessHost

    tracing.clear_trace()
    tracing.enable_tracing()
    try:
        fut = engine.submit([1, 2, 3, 4], 2)
        fut.result(30)
        rid = next(e["args"]["request_id"] for e in tracing.trace_events()
                   if e["name"] == "serving.request")
        with HostServer(engine, host="127.0.0.1") as server:
            local = InProcessHost(engine)
            remote = HttpHostHandle(server.url)
            try:
                for handle in (local, remote):
                    scraper = FleetScraper(probes=3)
                    scraper.add_host(handle)
                    off = scraper.clock_offsets()[handle.host_id]
                    assert abs(off) < 250_000, (handle, off)  # µs
                    assert handle.trace(0)["spans"] == []
                local_out = FleetScraper(probes=1)
                local_out.add_host(local)
                remote_out = FleetScraper(probes=1)
                remote_out.add_host(remote)
                a = local_out.fleet_trace(rid)
                b = remote_out.fleet_trace(rid)
                assert [e["name"] for e in a["spans"]] == \
                    [e["name"] for e in b["spans"]]
                assert "serving.request" in [e["name"] for e in a["spans"]]
                assert a["phases"] is None  # a colocated request
            finally:
                remote.close()
    finally:
        tracing.disable_tracing()
        tracing.clear_trace()


def test_from_router_registers_every_fleet_host(engine):
    from sparkdl_torch.fabric import InProcessHost, Router

    router = Router([InProcessHost(engine)], auto_refresh=False)
    try:
        scraper = FleetScraper.from_router(router)
        assert list(scraper.hosts()) == ["probe-0"]
        assert scraper.fleet_healthz()["hosts"]["probe-0"]["status"] in (
            "ok", "degraded")
        text = scraper.fleet_metrics()
        assert 'sparkdl_fleet_host_up{host="probe-0"} 1' in text
    finally:
        router.close()
