"""Fleet-wide observability plane: cross-host scraping and trace
stitching.

Per-host observability stops at the process boundary: each serving host
has its own ``/metrics``, its own SLO trackers, and its own tracing ring
whose timestamps are microseconds since *that process's* monotonic
epoch — three hosts are three unrelated clocks. A disaggregated request
(prefill on host A, KV handoff over the wire, decode on host B) leaves
span fragments on every host it touched; answering "where did THIS
request's time go" needs all of them on ONE timeline.

:class:`FleetScraper` is that plane. It polls every registered
:class:`~sparkdl_torch.fabric.host.HostHandle` over the SAME surface the
router routes over (``capacity()``/``snapshot()``/``health()`` plus the
``trace()`` RPC), so anything the fabric can route to, the
observability plane can observe — in-process handles and HTTP
transports alike.

Clock-skew correction: every ``trace()`` RPC returns the remote host's
trace-clock reading (``now_us``, µs since its epoch) taken while
serving the call. The scraper brackets the RPC with its own clock and
estimates the remote offset as ``remote_now − round-trip midpoint`` —
the classic NTP offset estimate, best-of-N probes keeping the
minimum-RTT sample (the midpoint assumption degrades with asymmetric
latency, so the tightest round trip wins). ``fleet_trace`` subtracts
each host's offset from its fragments' timestamps, deduplicates by
span id (hosts sharing one process share one ring), and returns a
single ordered timeline that loads in ui.perfetto.dev via
:meth:`~FleetScraper.export_fleet_trace`. Offset error is bounded by
RTT/2 — sub-millisecond on a LAN, which is the resolution caveat to
keep in mind when reading µs-level gaps across hosts.

Phase attribution: the decode tier's ``handoff.wire`` span carries the
request's measured phase durations as attributes, so
:func:`stitch_phase_breakdown` reads the five-phase breakdown (queue
wait → prefill compute → handoff wire → decode queue → decode compute)
straight off the stitched trace; the phases telescope, so their sum is
the request's end-to-end latency.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from sparkdl_torch.observability.registry import registry

__all__ = [
    "FleetScraper",
    "FleetServer",
    "stitch_phase_breakdown",
]

_log = logging.getLogger(__name__)

_M_SCRAPES = registry().counter(
    "sparkdl_fleet_scrapes_total",
    "fleet-aggregator scrapes served, by endpoint "
    "(metrics/slo/healthz/trace)",
    labels=("endpoint",))
_M_FLEET_HOSTS = registry().gauge(
    "sparkdl_fleet_hosts",
    "hosts registered with the fleet scraper")
_M_HOST_UP = registry().gauge(
    "sparkdl_fleet_host_up",
    "1 if the host answered the last fleet poll, 0 if it errored",
    labels=("host",))
_M_CLOCK_OFFSET = registry().gauge(
    "sparkdl_fleet_clock_offset_seconds",
    "estimated trace-clock offset of each host relative to the "
    "scraper (RPC round-trip midpoint method; error bounded by RTT/2)",
    labels=("host",))
_M_STITCHED = registry().counter(
    "sparkdl_fleet_stitched_traces_total",
    "cross-host trace stitches served by fleet_trace()")

#: The five telescoping request phases, in wall order: one tuple that
#: every sum-equals-end-to-end check reads, so no check and this module
#: can disagree about what "all phases" means.
PHASES = (
    ("queue", "prefill"),
    ("compute", "prefill"),
    ("wire", "handoff"),
    ("queue", "decode"),
    ("compute", "decode"),
)


def stitch_phase_breakdown(spans: "list[dict]") -> "list[dict] | None":
    """Five-phase latency attribution from one stitched span timeline.

    Anchors on the ``handoff.wire`` span (recorded on the decode host,
    carrying the measured phase durations as attributes — see
    ``DecodeWorker._admit_handoff``); decode compute is the remainder
    of the timeline after the derived admit instant, i.e. exactly the
    engine's admit→done interval on the decode host's own clock. None
    for a trace with no tier crossing (a colocated request has no
    phases to split)."""
    wire = [e for e in spans if e.get("name") == "handoff.wire"]
    if not wire:
        return None
    w = wire[-1]  # a re-crossed (requeued) request: the final crossing
    a = w.get("args") or {}
    end_us = max(
        (float(e.get("ts", 0.0)) + float(e.get("dur", 0.0))
         for e in spans),
        default=float(w.get("ts", 0.0)))
    wire_s = float(a.get("wire_s", 0.0))
    dq_s = float(a.get("decode_queue_s", 0.0))
    # admit instant on the stitched timeline: wire start + wire + queue
    t_adm_us = float(w.get("ts", 0.0)) + (wire_s + dq_s) * 1e6
    seconds = {
        ("queue", "prefill"): float(a.get("queue_wait_s", 0.0)),
        ("compute", "prefill"): float(a.get("prefill_s", 0.0)),
        ("wire", "handoff"): wire_s,
        ("queue", "decode"): dq_s,
        ("compute", "decode"): max(0.0, (end_us - t_adm_us) / 1e6),
    }
    return [{"phase": p, "tier": t, "seconds": seconds[(p, t)]}
            for p, t in PHASES]


class FleetScraper:
    """Poll a fleet of :class:`HostHandle`-shaped hosts and aggregate
    (see module docstring). Hosts register with :meth:`add_host` (or
    wholesale via :meth:`from_router` / :meth:`from_phase_router`);
    anything with ``host_id``/``capacity()``/``health()``/``trace()``
    qualifies — tests duck-type fake hosts with rigged clocks.

    ``probes`` is the per-host clock-probe count (best of N by minimum
    RTT); offsets cache until :meth:`clock_offsets` is asked to
    refresh, since monotonic-clock *rates* agree even when epochs
    don't."""

    def __init__(self, *, probes: int = 3):
        if probes < 1:
            raise ValueError(f"probes must be >= 1, got {probes}")
        self.probes = probes
        self._lock = threading.Lock()
        self._hosts: "dict[str, Any]" = {}
        self._tiers: "dict[str, str]" = {}
        self._offsets_us: "dict[str, float]" = {}

    # -- registration ---------------------------------------------------------
    def add_host(self, handle: Any, *, tier: "str | None" = None) -> str:
        host_id = str(handle.host_id)
        with self._lock:
            self._hosts[host_id] = handle
            if tier is not None:
                self._tiers[host_id] = tier
            _M_FLEET_HOSTS.set(len(self._hosts))
        return host_id

    def remove_host(self, host_id: str) -> None:
        with self._lock:
            self._hosts.pop(host_id, None)
            self._tiers.pop(host_id, None)
            self._offsets_us.pop(host_id, None)
            _M_FLEET_HOSTS.set(len(self._hosts))

    def hosts(self) -> "dict[str, Any]":
        with self._lock:
            return dict(self._hosts)

    def tier_of(self, host_id: str) -> "str | None":
        with self._lock:
            return self._tiers.get(host_id)

    @classmethod
    def from_router(cls, router: Any, **kwargs) -> "FleetScraper":
        """One scraper over everything a
        :class:`~sparkdl_torch.fabric.router.Router` routes to."""
        scraper = cls(**kwargs)
        for handle in router.fleet_hosts().values():
            scraper.add_host(handle)
        return scraper

    @classmethod
    def from_phase_router(cls, phase_router: Any, **kwargs) -> "FleetScraper":
        """One scraper over a disaggregated deployment's BOTH tiers,
        host→tier mapping included (feeds per-tier aggregation)."""
        scraper = cls(**kwargs)
        for tier, router in (("prefill", phase_router.prefill),
                             ("decode", phase_router.decode)):
            for handle in router.fleet_hosts().values():
                scraper.add_host(handle, tier=tier)
        return scraper

    # -- clock-offset estimation ----------------------------------------------
    def _probe_offset_us(self, handle: Any) -> float:
        """Best-of-N offset estimate for one host (see module
        docstring): each probe brackets a ``trace()`` RPC with the
        local trace clock and keeps the minimum-RTT sample's
        ``remote_now − midpoint``."""
        from sparkdl_torch.observability import tracing

        best_rtt = None
        best_offset = 0.0
        for _ in range(self.probes):
            t0 = tracing.trace_clock_us()
            out = handle.trace(0)  # an id no host ever mints: [] spans
            t1 = tracing.trace_clock_us()
            remote_now = out.get("now_us")
            if remote_now is None:
                continue
            rtt = t1 - t0
            if best_rtt is None or rtt < best_rtt:
                best_rtt = rtt
                best_offset = float(remote_now) - (t0 + t1) / 2.0
        return best_offset

    def clock_offsets(self, *, refresh: bool = False) -> "dict[str, float]":
        """Per-host trace-clock offsets in µs (``host clock − scraper
        clock``). Cached after first estimation — pass ``refresh=True``
        to re-probe (e.g. after a host restart changed its epoch)."""
        for host_id, handle in self.hosts().items():
            with self._lock:
                if not refresh and host_id in self._offsets_us:
                    continue
            try:
                off = self._probe_offset_us(handle)
            except Exception:
                _log.debug("fleet: clock probe failed for %s", host_id,
                           exc_info=True)
                continue
            with self._lock:
                self._offsets_us[host_id] = off
            _M_CLOCK_OFFSET.set(off / 1e6, host=host_id)
        with self._lock:
            return dict(self._offsets_us)

    # -- trace stitching ------------------------------------------------------
    def fleet_trace(self, request_id: int) -> "dict[str, Any]":
        """ONE skew-corrected timeline for one request, stitched from
        every host's span fragments.

        Fetches ``trace(request_id)`` from all hosts, shifts each
        fragment by its host's estimated clock offset, deduplicates by
        span id (in-process hosts sharing a ring report the same
        spans), tags every span with the host it came from, and sorts.
        The ``phases`` key is :func:`stitch_phase_breakdown` over the
        result (None for a non-disaggregated request)."""
        _M_SCRAPES.inc(endpoint="trace")
        rid = int(request_id)
        offsets = self.clock_offsets()
        spans: "list[dict]" = []
        seen_span_ids: set = set()
        fragments: "dict[str, dict]" = {}
        for host_id, handle in self.hosts().items():
            try:
                out = handle.trace(rid)
            except Exception as e:
                _M_HOST_UP.set(0, host=host_id)
                fragments[host_id] = {"error": repr(e)}
                continue
            _M_HOST_UP.set(1, host=host_id)
            off = offsets.get(host_id, 0.0)
            host_spans = out.get("spans") or []
            fragments[host_id] = {
                "spans": len(host_spans),
                "clock_offset_us": off,
                "tier": self.tier_of(host_id),
            }
            for ev in host_spans:
                sid = (ev.get("args") or {}).get("span_id")
                if sid is not None:
                    if sid in seen_span_ids:
                        continue
                    seen_span_ids.add(sid)
                ev = dict(ev)
                ev["ts"] = float(ev.get("ts", 0.0)) - off
                ev["host"] = host_id
                spans.append(ev)
        spans.sort(key=lambda e: e["ts"])
        _M_STITCHED.inc()
        return {
            "request_id": rid,
            "spans": spans,
            "hosts": fragments,
            "phases": stitch_phase_breakdown(spans),
        }

    def export_fleet_trace(self, path: Any, request_id: int) -> int:
        """Write one stitched trace as Chrome ``trace_event`` JSON —
        the multi-host counterpart of ``tracing.export_chrome_trace``
        (loads in ui.perfetto.dev; one row per host via ``pid``).
        Returns the span count."""
        stitched = self.fleet_trace(request_id)
        events = []
        host_row = {h: i + 1
                    for i, h in enumerate(sorted(stitched["hosts"]))}
        for ev in stitched["spans"]:
            ev = dict(ev)
            # one timeline row per HOST, not per origin pid: the whole
            # point of stitching is reading the crossing at a glance
            ev["pid"] = host_row.get(ev.get("host"), 0)
            events.append(ev)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f, separators=(",", ":"), default=repr)
        return len(events)

    # -- fleet aggregation ----------------------------------------------------
    def fleet_metrics(self) -> str:
        """Prometheus text for the fleet: polls every host's
        ``capacity()`` into the ``sparkdl_fleet_*`` gauges, then
        renders this process's registry (the fleet families ride next
        to whatever else the aggregator process observes)."""
        _M_SCRAPES.inc(endpoint="metrics")
        for host_id, handle in self.hosts().items():
            try:
                handle.capacity()
            except Exception:
                _M_HOST_UP.set(0, host=host_id)
                continue
            _M_HOST_UP.set(1, host=host_id)
        return registry().to_prometheus()

    def fleet_slo(self) -> "dict[str, Any]":
        """Every host's SLO section plus this process's registered
        trackers — the ``/fleet/slo.json`` payload. Per-host sections
        come from ``snapshot()["slo"]`` where engines publish them;
        hosts without one report null rather than erroring the poll."""
        from sparkdl_torch.observability import slo as slo_mod

        _M_SCRAPES.inc(endpoint="slo")
        hosts: "dict[str, Any]" = {}
        for host_id, handle in self.hosts().items():
            try:
                snap = handle.snapshot() or {}
            except Exception as e:
                _M_HOST_UP.set(0, host=host_id)
                hosts[host_id] = {"error": repr(e)}
                continue
            _M_HOST_UP.set(1, host=host_id)
            hosts[host_id] = {"slo": snap.get("slo"),
                              "tier": self.tier_of(host_id)}
        return {"slos": slo_mod.slo_report(), "hosts": hosts}

    def fleet_healthz(self) -> "dict[str, Any]":
        """Worst-of aggregation over every host's ``health()``:
        unhealthy if ANY host is unhealthy or unreachable, degraded if
        any is degraded, else ok — the strict grain a fleet-level pager
        wants (per-host state included for the triage that follows)."""
        _M_SCRAPES.inc(endpoint="healthz")
        rank = {"ok": 0, "degraded": 1, "unhealthy": 2}
        worst = "ok"
        hosts: "dict[str, Any]" = {}
        for host_id, handle in self.hosts().items():
            try:
                h = handle.health() or {}
            except Exception as e:
                h = {"status": "unhealthy", "error": repr(e)}
            _M_HOST_UP.set(
                0 if h.get("status") == "unhealthy" else 1,
                host=host_id)
            hosts[host_id] = h
            status = str(h.get("status", "unhealthy"))
            if rank.get(status, 2) > rank[worst]:
                worst = status if status in rank else "unhealthy"
        return {"status": worst, "hosts": hosts}


class _FleetHandler(BaseHTTPRequestHandler):
    scraper: FleetScraper  # set on the per-instance subclass

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0]
        status = 200
        try:
            if path == "/fleet/metrics":
                body = self.scraper.fleet_metrics().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/fleet/slo.json":
                body = json.dumps(self.scraper.fleet_slo(),
                                  default=repr).encode()
                ctype = "application/json"
            elif path == "/fleet/healthz":
                report = self.scraper.fleet_healthz()
                status = 503 if report["status"] == "unhealthy" else 200
                body = json.dumps(report, default=repr).encode()
                ctype = "application/json"
            elif path.startswith("/fleet/trace/"):
                try:
                    rid = int(path.rsplit("/", 1)[1])
                except ValueError:
                    self.send_error(
                        400, "request id must be an integer")
                    return
                body = json.dumps(self.scraper.fleet_trace(rid),
                                  default=repr).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
        except Exception:
            _log.exception("fleet: %s handler failed", path)
            self.send_error(500)
            return
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes must not spam stdout
        _log.debug("fleet scrape: " + fmt, *args)


class FleetServer:
    """Serve one :class:`FleetScraper` over HTTP (daemon threads, same
    stdlib machinery as :class:`~sparkdl_torch.observability.exporters.
    MetricsServer`): ``/fleet/metrics``, ``/fleet/slo.json``,
    ``/fleet/healthz``, ``/fleet/trace/<request_id>``."""

    def __init__(self, scraper: FleetScraper, *, port: int = 0,
                 host: str = ""):
        self.scraper = scraper
        handler = type("_BoundFleetHandler", (_FleetHandler,),
                       {"scraper": scraper})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            name="sparkdl-fleet-http", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)

    def __enter__(self) -> "FleetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
