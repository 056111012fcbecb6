"""Horizontally scaled router tier: N routers, zero shared state.

One :class:`~sparkdl_torch.fabric.router.Router` process is the fleet's
throughput ceiling and single point of failure — the coordinator
bottleneck the distributed-TF lineage warns about (arXiv 1603.04467).
The answer is N routers that AGREE without coordinating:

* **Placement agreement is arithmetic, not state.** Every router hashes
  a prompt's first prefix block (``placement_key``) and every host id
  through the same rendezvous function (``hrw_score``); sticky sessions
  hash the session id (``session_key``). Two routers with the same host
  set therefore break every score tie — and derive every session home —
  identically, in any process, with no messages between them.
* **Disagreement windows degrade affinity, never correctness.** Each
  router still keeps its own probation/quarantine/outstanding view
  (health is a local observation, not consensus). While views differ,
  the routers may pick different hosts for the same prompt — costing at
  most one cold prefill on the "wrong" host, exactly what a digest-less
  router pays — and the deterministic tie-break re-converges them as
  soon as the views match again.
* **A dead router loses nothing.** Routers are stateless by
  construction (the LRU is a cache over the hash, digests re-sync from
  the hosts), so :class:`RouterGroup` just skips closed members and
  fails a dispatch over to the next — the chaos bar is kill-one-
  mid-soak with zero lost accepted requests.

:class:`RouterGroup` is the in-process front (tests, single-process
deployments with thread-per-router); :class:`RouterServer` /
:class:`RouterHandle` put one router behind the same stdlib-HTTP
machinery the host tier uses, so a real deployment runs N router
processes behind any dumb TCP balancer.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Iterable

import numpy as np

from sparkdl_torch.observability import flight
from sparkdl_torch.observability.registry import GaugeShare, registry
from sparkdl_torch.serving.queue import QueueFullError

from sparkdl_torch.fabric.digest import session_key
from sparkdl_torch.fabric.host import HostUnavailableError
from sparkdl_torch.fabric.http import _raise_remote, _status_for
from sparkdl_torch.fabric.router import AllHostsUnavailableError, Router

__all__ = [
    "AllRoutersUnavailableError",
    "RouterGroup",
    "RouterHandle",
    "RouterServer",
]

_log = logging.getLogger(__name__)

_M_ROUTERS = registry().gauge(
    "sparkdl_fabric_routers",
    "live routers in the horizontally scaled router tier")
_M_DISPATCH = registry().counter(
    "sparkdl_fabric_router_dispatch_total",
    "requests the router-tier front dispatched, by receiving router",
    labels=("router",))
_M_ROUTER_FAILOVERS = registry().counter(
    "sparkdl_fabric_router_failovers_total",
    "dispatches retried on another router after a router died "
    "mid-dispatch (the kill-one-mid-soak path; host-level failover "
    "inside a live router is sparkdl_fabric_failovers_total)")


class AllRoutersUnavailableError(RuntimeError):
    """Every router in the group is closed or failing; the tier cannot
    dispatch. (Host saturation is NOT this — a healthy router that
    answers :class:`QueueFullError` speaks for the whole fleet.)"""


#: errors that indict the ROUTER (dead process, closed instance, dead
#: transport) rather than the request or the host fleet — the group
#: fails these over to the next member. AllHostsUnavailableError and
#: QueueFullError are deliberately absent: a live router's verdict
#: about the FLEET holds on every other router too.
_ROUTER_LEVEL_ERRORS = (HostUnavailableError, ConnectionError, OSError)


class RouterGroup:
    """Thin stateless front over N routers sharing one host fleet.

    Dispatch picks a deterministic start member — ``session_key(session)
    % n`` for sessions (every front instance starts a session on the
    same router, whose sticky LRU then stays warm), round-robin
    otherwise — and walks the group until a member accepts. A member
    raising a router-level error (closed mid-soak, dead transport) is
    skipped and the dispatch retries on the next; fleet-level verdicts
    (``QueueFullError``, ``AllHostsUnavailableError``) propagate
    immediately, because every live router would say the same thing.

    The group owns no routing state — members stay independently
    usable, and ``close()`` closes only what the caller asks
    (``close_members=True``) since tests often own the routers.
    """

    def __init__(self, routers: "Iterable[Router | Any]"):
        self._routers = list(routers)
        if not self._routers:
            raise ValueError("a RouterGroup needs at least one router")
        self._rr = 0
        self._lock = threading.Lock()
        self._closed = False
        self._g_routers = GaugeShare(_M_ROUTERS)
        self._g_routers.set(len(self._routers))
        flight.record_event(
            "fabric.router_group_start", routers=len(self._routers))

    # -- membership ----------------------------------------------------------
    def routers(self) -> "list[Any]":
        return list(self._routers)

    def live_routers(self) -> "list[Any]":
        return [r for r in self._routers
                if not getattr(r, "closed", False)]

    def _name(self, idx: int) -> str:
        return f"router-{idx}"

    # -- dispatch ------------------------------------------------------------
    def submit(self, payload: Any, *, timeout_s: "float | None" = None,
               session: Any = None) -> Future:
        """Dispatch one request through the first live member willing
        to take it. A member that dies AFTER accepting (killed
        mid-soak: its Future fails with a router-level error) is
        failed over too — the accepted request re-dispatches through
        the next member, which is the zero-lost-requests contract.
        Raises :class:`AllRoutersUnavailableError` only when every
        member is router-level dead."""
        if self._closed:
            raise RuntimeError("RouterGroup is closed")
        n = len(self._routers)
        if session is not None:
            start = session_key(session) % n
        else:
            with self._lock:
                start = self._rr % n
                self._rr += 1
        caller: Future = Future()
        self._dispatch(payload, timeout_s, session, caller, start, 0,
                       None)
        return caller

    def _dispatch(self, payload: Any, timeout_s: "float | None",
                  session: Any, caller: Future, start: int, k0: int,
                  last: "BaseException | None") -> None:
        """Walk members from group offset ``k0`` until one accepts,
        chaining its Future into ``caller``. Raises when none can —
        the sync leg (``submit``) lets that propagate; the async
        failover leg catches it onto ``caller``."""
        n = len(self._routers)
        for k in range(k0, n):
            idx = (start + k) % n
            router = self._routers[idx]
            if getattr(router, "closed", False):
                continue
            try:
                fut = router.submit(payload, timeout_s=timeout_s,
                                    session=session)
            except (QueueFullError, AllHostsUnavailableError):
                # the FLEET's verdict, not this router's: every live
                # member routes over the same hosts
                raise
            except _ROUTER_LEVEL_ERRORS as e:
                last = e
                continue
            except RuntimeError as e:
                if getattr(router, "closed", False):
                    # closed between the check and the call (the
                    # kill-mid-soak race): this member is gone, walk on
                    last = e
                    continue
                raise
            _M_DISPATCH.inc(router=self._name(idx))
            fut.add_done_callback(
                lambda f, k=k: self._on_result(
                    f, payload, timeout_s, session, caller, start, k))
            return
        raise AllRoutersUnavailableError(
            f"none of the {n} routers can dispatch"
            + (f" (last: {type(last).__name__}: {last})" if last else ""))

    def _on_result(self, fut: Future, payload: Any,
                   timeout_s: "float | None", session: Any,
                   caller: Future, start: int, k: int) -> None:
        if fut.cancelled():
            caller.cancel()
            return
        exc = fut.exception()
        if exc is None:
            try:
                caller.set_result(fut.result())
            except InvalidStateError:
                pass  # the caller cancelled; the result is dropped
            return
        if isinstance(exc, _ROUTER_LEVEL_ERRORS):
            # the ROUTER died holding the request (kill-mid-soak): the
            # accepted request walks on to the next member — zero lost
            _M_ROUTER_FAILOVERS.inc()
            flight.record_event(
                "fabric.router_failover",
                router=self._name((start + k) % len(self._routers)))
            try:
                self._dispatch(payload, timeout_s, session, caller,
                               start, k + 1, exc)
                return
            except Exception as e:
                exc = e
        try:
            caller.set_exception(exc)
        except InvalidStateError:
            pass

    # -- maintenance ---------------------------------------------------------
    def refresh(self) -> None:
        """Refresh every live member's fleet view (tests drive this
        manually; production members run their own refresh threads)."""
        for r in self.live_routers():
            r.refresh()

    def snapshot(self) -> "dict[str, Any]":
        members = []
        for i, r in enumerate(self._routers):
            closed = getattr(r, "closed", False)
            entry: "dict[str, Any]" = {
                "router": self._name(i), "closed": closed}
            if not closed:
                try:
                    entry.update(r.snapshot())
                except Exception as e:
                    entry["error"] = type(e).__name__
            members.append(entry)
        live = sum(not m["closed"] for m in members)
        return {"routers": len(members), "live": live,
                "members": members}

    def close(self, *, close_members: bool = False) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if close_members:
            for r in self._routers:
                try:
                    r.close()
                except Exception:  # pragma: no cover - shutdown guard
                    pass
        self._g_routers.set(0)
        flight.record_event("fabric.router_group_close")

    def __enter__(self) -> "RouterGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- HTTP front (one router per process) -------------------
class _RouterHandler(BaseHTTPRequestHandler):
    server_owner: "RouterServer"  # set on the per-instance subclass

    def _reply(self, status: int, body: dict) -> None:
        data = json.dumps(body, default=repr).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0]
        try:
            if path == "/router/snapshot":
                self._reply(200, self.server_owner.router.snapshot())
            else:
                self.send_error(404)
        except Exception as e:  # transport must answer, never hang
            name, status = _status_for(e)
            self._reply(status, {"error": name, "message": str(e)})

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0]
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": "ValueError", "message": str(e)})
            return
        try:
            if path == "/router/submit":
                self._reply(200, self.server_owner.handle_submit(body))
            else:
                self.send_error(404)
        except Exception as e:
            name, status = _status_for(e)
            self._reply(status, {"error": name, "message": str(e)})

    def log_message(self, fmt, *args):  # no stdout spam per request
        _log.debug("fabric-router: " + fmt, *args)


class RouterServer:
    """Serve one :class:`Router` over HTTP — the process form of a
    router-tier member. ``POST /router/submit`` blocks for the
    generation (same thin-transport trade as the host tier);
    ``GET /router/snapshot`` is the operator view."""

    def __init__(self, router: Router, *, port: int = 0, host: str = "",
                 result_timeout_s: float = 120.0):
        self.router = router
        self.result_timeout_s = result_timeout_s
        handler = type("_BoundRouterHandler", (_RouterHandler,),
                       {"server_owner": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            name="sparkdl-fabric-router-http", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def handle_submit(self, body: dict) -> dict:
        timeout_s = body.get("timeout_s")
        timeout = float(timeout_s) if timeout_s is not None else None
        payload = {"prompt": np.asarray(body["prompt"], np.int32),
                   "max_new_tokens": int(body["max_new_tokens"])}
        fut = self.router.submit(payload, timeout_s=timeout,
                                 session=body.get("session"))
        result = fut.result(timeout=self.result_timeout_s)
        return {"tokens": [int(t) for t in np.asarray(result).ravel()]}

    def close(self, *, close_router: bool = False) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2)
        if close_router:
            self.router.close()

    def __enter__(self) -> "RouterServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RouterHandle:
    """Client side of :class:`RouterServer`, shaped like a router for
    :class:`RouterGroup` membership: ``submit`` returns a Future backed
    by a small thread pool, transport death raises
    :class:`HostUnavailableError` (a router-level error — the group
    walks on), and ``closed`` turns True once the remote stops
    answering so the group stops offering it work."""

    def __init__(self, base_url: str, *, max_inflight: int = 32,
                 connect_timeout_s: float = 10.0,
                 result_timeout_s: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.connect_timeout_s = connect_timeout_s
        self.result_timeout_s = result_timeout_s
        self._closed = False
        self._pool = ThreadPoolExecutor(
            max_workers=max_inflight,
            thread_name_prefix="sparkdl-fabric-router-client")

    @property
    def closed(self) -> bool:
        return self._closed

    def _request(self, path: str, body: "dict | None" = None,
                 timeout_s: "float | None" = None) -> dict:
        url = self.base_url + path
        data = json.dumps(body).encode() if body is not None else None
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
            # the remote router process is gone: mark this member dead
            # so the group skips it without a connect round-trip
            self._closed = True
            raise HostUnavailableError(
                f"router unreachable at {url}: {e.reason}") from e

    def submit(self, payload: Any, *, timeout_s: "float | None" = None,
               session: Any = None) -> Future:
        if self._closed:
            raise RuntimeError("RouterHandle is closed")
        body = {
            "prompt": [int(t) for t in payload["prompt"]],
            "max_new_tokens": int(payload["max_new_tokens"]),
            "timeout_s": timeout_s,
        }
        if session is not None:
            body["session"] = session

        # a dead remote fails the Future with HostUnavailableError —
        # the group's ASYNC failover leg re-dispatches the request
        def call():
            out = self._request(
                "/router/submit", body,
                timeout_s=((timeout_s if timeout_s is not None
                            else self.result_timeout_s)
                           + self.connect_timeout_s))
            return np.asarray(out["tokens"], np.int32)

        return self._pool.submit(call)

    def snapshot(self) -> "dict[str, Any]":
        return self._request("/router/snapshot")

    def refresh(self) -> None:
        """Remote members refresh on their own thread; nothing to do."""

    def close(self) -> None:
        self._closed = True
        self._pool.shutdown(wait=False)
