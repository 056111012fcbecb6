"""Thin HTTP/json transport for fabric hosts.

Real deployments put one serving process per host behind the router
tier; this module is the wire between them, built on the SAME stdlib
``http.server`` machinery as the metrics exporter (zero dependencies,
daemon threads, ThreadingHTTPServer). It is deliberately *thin*: one
blocking POST per request (the client side wraps it in a small thread
pool to give the router Futures), json bodies, no streaming — the
fabric's contracts (affinity, spillover, drain, failover) live in the
router and are transport-agnostic, which is why the in-process handle
and this one are interchangeable in every test.

Server endpoints (:class:`HostServer`, wrapping one engine):

* ``POST /fabric/submit``  ``{"prompt": [...], "max_new_tokens": n,
  "timeout_s": t|null}`` → ``{"tokens": [...], "request_id": id}``;
  errors answer non-200 with ``{"error": <type>, "message": ...}`` and
  map back to typed exceptions client-side (429 QueueFull, 503
  closed/draining, 504 deadline). Disaggregated tiers ride
  the same endpoint: a ``{"handoff": <KVHandoff wire dict>}`` body
  installs on a decode-tier engine, and a prefill-tier engine answers
  ``{"handoff": ...}`` instead of tokens — the quantized KV blocks
  cross hosts base64-encoded in their RAW pool storage, so an int8
  tier's wire cost stays ~4× under fp32's.
* ``GET /fabric/snapshot`` → ``engine.snapshot()`` (host_id + capacity
  included — the router's weighting input).
* ``GET /fabric/digest`` → ``engine.prefix_digest()`` (null for dense).
* ``GET /fabric/digest_delta?since=N`` → ``{"delta": ...}`` — the
  block-hash journal since version N, null when the host
  cannot produce one (gap, dense, no journal): the router re-syncs
  with one wholesale ``/fabric/digest``.
* ``POST /fabric/migrate_out`` → ``{"bundle": ...}`` (the host's
  parked sessions, serialized through the handoff raw-storage codec)
  and ``POST /fabric/migrate_in`` ``{"bundle": ...}`` →
  ``{"imported": n}`` — the two wire ends of parked-session migration
  on drain/scale-down.
* ``GET /fabric/trace?request_id=N`` → this host's span fragments for
  one trace plus its trace-clock reading (``now_us``) — the
  :class:`~sparkdl_torch.observability.fleet.FleetScraper`'s stitching
  RPC. Submit bodies may carry a serialized ``"trace"``
  span context; the server attaches it so host-side spans parent into
  the CALLER's trace instead of starting an orphan.
* ``GET /fabric/healthz`` → the process ``healthz_report()`` (one
  engine per process in real deployments, so process grain == host
  grain here).
* ``POST /fabric/drain`` → stops admission, fails every unstarted
  request with :class:`~sparkdl_torch.fabric.host.HostDrainingError` so
  the blocked client submits return and the router's failover path
  re-places them on surviving hosts. The drain is NOT a request
  failure: nothing lands in ``sparkdl_requests_failed_total`` (the
  no-double-count contract — the re-routed request is counted, once,
  by whatever finally happens to it on its new host).
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from sparkdl_torch.observability import flight, tracing
from sparkdl_torch.reliability.faults import fault_point
from sparkdl_torch.serving.queue import (
    DeadlineExceededError,
    EngineClosedError,
    QueueFullError,
)

from sparkdl_torch.fabric.host import (
    HostDrainingError,
    HostHandle,
    HostUnavailableError,
)

__all__ = ["HostServer", "HttpHostHandle"]

_log = logging.getLogger(__name__)

#: error-name → (exception type, HTTP status) map shared by both ends
#: of the wire so a remote failure re-raises as the SAME type the
#: in-process engine would have raised (the router's retry classes must
#: not care which transport a host sits behind)
_ERROR_TYPES = {
    "QueueFullError": (QueueFullError, 429),
    "EngineClosedError": (EngineClosedError, 503),
    "HostDrainingError": (HostDrainingError, 503),
    "DeadlineExceededError": (DeadlineExceededError, 504),
    "ValueError": (ValueError, 400),
}


def _register_handoff_errors() -> None:
    """Add the disagg tier's typed error to the wire map on first
    handoff use — not at import, so the transport never drags the
    disagg package (and the model stack behind it) into processes that
    only route plain prompts. The PhaseRouter's zero-loss requeue keys
    on the typed re-raise, so it must survive the wire."""
    if "HandoffInstallError" not in _ERROR_TYPES:
        from sparkdl_torch.disagg.handoff import HandoffInstallError

        _ERROR_TYPES["HandoffInstallError"] = (HandoffInstallError, 409)


def _status_for(exc: BaseException) -> "tuple[str, int]":
    for name, (typ, status) in _ERROR_TYPES.items():
        if isinstance(exc, typ):
            return name, status
    return type(exc).__name__, 500


class _FabricHandler(BaseHTTPRequestHandler):
    server_owner: "HostServer"  # set on the per-instance subclass

    def _reply(self, status: int, body: dict) -> None:
        data = json.dumps(body, default=repr).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _reply_error(self, exc: BaseException) -> None:
        name, status = _status_for(exc)
        self._reply(status, {"error": name, "message": str(exc)})

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path, _, query = self.path.partition("?")
        owner = self.server_owner
        try:
            if path == "/fabric/snapshot":
                self._reply(200, owner.engine.snapshot())
            elif path == "/fabric/digest":
                params = urllib.parse.parse_qs(query)
                n = int(params.get("max_entries", ["1024"])[0])
                dig = owner.engine.prefix_digest(n)
                self._reply(200, {"digest": dig})
            elif path == "/fabric/digest_delta":
                params = urllib.parse.parse_qs(query)
                since = int(params.get("since", ["0"])[0])
                n = int(params.get("max_entries", ["1024"])[0])
                fn = getattr(owner.engine, "prefix_digest_delta", None)
                delta = fn(since, n) if callable(fn) else None
                self._reply(200, {"delta": delta})
            elif path == "/fabric/trace":
                params = urllib.parse.parse_qs(query)
                rid = int(params.get("request_id", ["0"])[0])
                self._reply(200, {
                    "host_id": owner.engine.host_id,
                    # trace-clock reading WHILE serving: pairs with the
                    # caller's RPC round-trip midpoint for clock-offset
                    # estimation (fleet stitching)
                    "now_us": tracing.trace_clock_us(),
                    "spans": owner.handle_trace(rid),
                })
            elif path == "/fabric/healthz":
                from sparkdl_torch.observability.flight import healthz_report

                report = healthz_report()
                report["host_id"] = owner.engine.host_id
                report["draining"] = owner.draining
                self._reply(
                    503 if report["status"] == "unhealthy" else 200,
                    report)
            else:
                self.send_error(404)
        except Exception as e:  # transport must answer, never hang
            _log.exception("fabric: %s handler failed", path)
            self._reply_error(e)

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0]
        owner = self.server_owner
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": "ValueError", "message": str(e)})
            return
        try:
            if path == "/fabric/submit":
                self._reply(200, owner.handle_submit(body))
            elif path == "/fabric/drain":
                self._reply(200, owner.handle_drain())
            elif path == "/fabric/migrate_out":
                fn = getattr(owner.engine, "export_parked_sessions",
                             None)
                bundle = fn() if callable(fn) else None
                self._reply(200, {"bundle": bundle})
            elif path == "/fabric/migrate_in":
                fn = getattr(owner.engine, "import_parked_sessions",
                             None)
                n = (int(fn(body.get("bundle")))
                     if callable(fn) else 0)
                self._reply(200, {"imported": n})
            else:
                self.send_error(404)
        except Exception as e:
            self._reply_error(e)

    def log_message(self, fmt, *args):  # no stdout spam per request
        _log.debug("fabric: " + fmt, *args)


class HostServer:
    """Serve one engine's fabric surface over HTTP (daemon threads).

    ``result_timeout_s`` bounds how long one submit's worker thread
    blocks on the engine before answering 504 — the transport-level
    backstop under a caller that sent no ``timeout_s``."""

    def __init__(self, engine: Any, *, port: int = 0, host: str = "",
                 result_timeout_s: float = 120.0):
        self.engine = engine
        self.result_timeout_s = result_timeout_s
        self.draining = False
        handler = type("_BoundFabricHandler", (_FabricHandler,),
                       {"server_owner": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            name=f"sparkdl-fabric-host-{engine.host_id}", daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # -- request handling (called from handler threads) ----------------------
    def handle_submit(self, body: dict) -> dict:
        if self.draining:
            raise HostDrainingError(
                f"host {self.engine.host_id} is draining")
        timeout_s = body.get("timeout_s")
        timeout = float(timeout_s) if timeout_s is not None else None
        if "handoff" in body:
            # decode-tier admission: install the transferred
            # blocks, no re-prefill
            _register_handoff_errors()
            from sparkdl_torch.disagg.handoff import KVHandoff

            fut = self.engine.submit_handoff(
                KVHandoff.from_wire(body["handoff"]), timeout_s=timeout)
        else:
            prompt = np.asarray(body["prompt"], np.int32)
            # a shipped span context parents this host's
            # request trace into the CALLER's — the submit span the
            # queue records links back across the process boundary
            with tracing.attach(
                    tracing.context_from_wire(body.get("trace"))):
                fut = self.engine.submit(
                    prompt, int(body["max_new_tokens"]),
                    timeout_s=timeout)
        try:
            result = fut.result(timeout=self.result_timeout_s)
        except FuturesTimeoutError:
            # map the backstop to the documented 504/DeadlineExceeded —
            # the raw futures TimeoutError would cross the wire as a
            # 500 and read as a DEAD HOST, re-routing (and duplicating)
            # a generation that is merely slow
            raise DeadlineExceededError(
                f"generation exceeded the host result backstop "
                f"({self.result_timeout_s}s)") from None
        rid = getattr(fut, "request_id", None)
        if hasattr(result, "to_wire"):
            # a prefill-tier engine resolves to a KVHandoff: ship it
            return {"handoff": result.to_wire(), "request_id": rid}
        return {
            "tokens": [int(t) for t in np.asarray(result).ravel()],
            "request_id": rid,
        }

    def handle_trace(self, request_id: int) -> "list[dict]":
        """This host's finished spans for one trace (the stitching RPC's
        payload half; the handler adds the clock reading)."""
        fn = getattr(self.engine, "trace", None)
        if callable(fn):
            return fn(int(request_id))
        return tracing.spans_for_trace(int(request_id))

    def handle_drain(self) -> dict:
        self.draining = True
        reqs = self.engine.begin_drain()
        # fail the extracted requests' LOCAL futures with the typed
        # draining error: their callers are the router's blocked submit
        # threads, whose failover re-places the payloads on surviving
        # hosts. Deliberately NOT record_request_failure: a drained
        # request is moving, not dying (the no-double-count contract).
        exc = HostDrainingError(
            f"host {self.engine.host_id} drained this request before "
            "placement; the fabric re-routes it")
        for r in reqs:
            if r.started or r.future.set_running_or_notify_cancel():
                r.future.set_exception(exc)
        flight.record_event(
            "host.drain", host=self.engine.host_id, requeued=len(reqs),
            transport="http")
        return {"host_id": self.engine.host_id, "requeued": len(reqs)}

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)

    def __enter__(self) -> "HostServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _raise_remote(name: "str | None", message: str) -> None:
    """Re-raise a remote error client-side. A parsed error body is the
    REQUEST's own outcome: known names re-raise typed, unknown names
    (a model RuntimeError, a KeyError from a bad payload) re-raise as
    a plain RuntimeError — deliberately NOT HostUnavailableError, which
    would promote a poison request into the host-level retry class and
    let it quarantine every healthy host it touches. Only a response
    with no parseable error body (``name=None``: a crashed handler, a
    proxy page) indicts the transport."""
    if name is None:
        raise HostUnavailableError(f"remote host error: {message}")
    typ = _ERROR_TYPES.get(name, (None, 0))[0]
    if typ is None:
        raise RuntimeError(f"remote {name}: {message}")
    raise typ(message)


class HttpHostHandle(HostHandle):
    """Router-side handle over a :class:`HostServer`.

    ``submit`` returns a Future backed by a bounded worker pool (one
    blocking POST per in-flight request — the thin-transport trade;
    ``max_inflight`` sizes the pool). Transport failures surface as
    :class:`HostUnavailableError` (a host-level error: the router
    re-routes); typed engine errors re-raise as themselves.
    """

    def __init__(self, base_url: str, *, host_id: "str | None" = None,
                 max_inflight: int = 32, connect_timeout_s: float = 10.0,
                 result_timeout_s: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.connect_timeout_s = connect_timeout_s
        #: client-side cap on a deadline-less generation POST — matches
        #: the server's own result backstop, NOT connect_timeout_s: a
        #: 15s generation is a slow success, not a dead host
        self.result_timeout_s = result_timeout_s
        if host_id is None:
            host_id = str(self._get("/fabric/snapshot").get("host_id"))
        self.host_id = host_id
        self._pool = ThreadPoolExecutor(
            max_workers=max_inflight,
            thread_name_prefix=f"sparkdl-fabric-{host_id}")

    # -- wire helpers --------------------------------------------------------
    def _request(self, path: str, body: "dict | None" = None,
                 timeout_s: "float | None" = None) -> dict:
        url = self.base_url + path
        data = (json.dumps(body).encode()
                if body is not None else None)
        req = urllib.request.Request(
            url, data=data,
            headers={"Content-Type": "application/json"},
            method="POST" if body is not None else "GET")
        try:
            with urllib.request.urlopen(
                    req, timeout=(timeout_s if timeout_s is not None
                                  else self.connect_timeout_s)) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read() or b"{}")
            except (ValueError, json.JSONDecodeError):
                payload = {}
            _raise_remote(payload.get("error"),
                          payload.get("message", str(e)))
        except urllib.error.URLError as e:
            raise HostUnavailableError(
                f"host {self.host_id} unreachable at {url}: {e.reason}"
            ) from e

    def _get(self, path: str) -> dict:
        return self._request(path)

    # -- HostHandle surface --------------------------------------------------
    def submit(self, payload: "dict[str, Any]", *,
               timeout_s: "float | None" = None) -> Future:
        fault_point("host.submit")
        if isinstance(payload, dict) and "handoff" in payload:
            # cross-tier KV transfer: serialize the handoff
            # for the wire; the install failure must re-raise typed
            _register_handoff_errors()
            body: dict = {"handoff": payload["handoff"].to_wire(),
                          "timeout_s": timeout_s}
        else:
            body = {
                "prompt": [int(t) for t in payload["prompt"]],
                "max_new_tokens": int(payload["max_new_tokens"]),
                "timeout_s": timeout_s,
            }
            # capture the ambient span HERE (the caller's thread) — the
            # pool thread that sends the POST has no contextvar state
            trace = tracing.context_to_wire(tracing.current_context())
            if trace is not None:
                body["trace"] = trace

        def call():
            out = self._request(
                "/fabric/submit", body,
                # the POST blocks for the full generation: give it the
                # request's own deadline (or the result backstop) plus
                # transport headroom — never the bare connect timeout,
                # which would misread a long generation as a dead host
                timeout_s=((timeout_s if timeout_s is not None
                            else self.result_timeout_s)
                           + self.connect_timeout_s))
            if "handoff" in out:
                # a prefill-tier host answered with the exported blocks
                from sparkdl_torch.disagg.handoff import KVHandoff

                return KVHandoff.from_wire(out["handoff"])
            return np.asarray(out["tokens"], np.int32)

        return self._pool.submit(call)

    def snapshot(self) -> "dict[str, Any]":
        return self._get("/fabric/snapshot")

    def capacity(self) -> "dict[str, Any]":
        return self.snapshot().get("capacity") or {}

    def health(self) -> "dict[str, Any]":
        try:
            return self._get("/fabric/healthz")
        except HostUnavailableError:
            # an unhealthy remote answers 503 WITH a body (handled in
            # _request via the HTTPError branch); no answer at all is
            # this stronger verdict
            return {"status": "unhealthy", "host_id": self.host_id,
                    "unreachable": True}

    def prefix_digest(self, max_entries: int = 1024) -> "dict | None":
        return self._get(
            f"/fabric/digest?max_entries={int(max_entries)}"
        ).get("digest")

    def prefix_digest_delta(self, since_version: int,
                            max_entries: int = 1024) -> "dict | None":
        return self._get(
            f"/fabric/digest_delta?since={int(since_version)}"
            f"&max_entries={int(max_entries)}"
        ).get("delta")

    def export_parked_sessions(self) -> "dict | None":
        # migration can ship many blocks: give it the result budget,
        # not the bare connect timeout
        return self._request(
            "/fabric/migrate_out", {},
            timeout_s=self.result_timeout_s).get("bundle")

    def import_parked_sessions(self, bundle: "dict | None") -> int:
        if not bundle:
            return 0
        return int(self._request(
            "/fabric/migrate_in", {"bundle": bundle},
            timeout_s=self.result_timeout_s).get("imported") or 0)

    def trace(self, request_id: int) -> "dict[str, Any]":
        out = self._get(f"/fabric/trace?request_id={int(request_id)}")
        out.setdefault("host_id", self.host_id)
        return out

    def drain(self) -> list:
        fault_point("host.drain")
        out = self._request("/fabric/drain", {})
        flight.record_event(
            "host.drain_requested", host=self.host_id,
            requeued=out.get("requeued"))
        return []  # remote futures fail with HostDrainingError instead

    def close(self, *, timeout_s: "float | None" = 30.0) -> None:
        self._pool.shutdown(wait=False)
