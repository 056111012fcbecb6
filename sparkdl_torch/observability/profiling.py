"""Profiler hookup: device traces (torch.profiler) + host stack sampling.

The port of ``sparkdl_tpu.observability.profiling``. Device side:

* :func:`trace` — capture a ``torch.profiler`` trace of a code block
  (CPU ops and, on the card, CUDA kernels and copies through CUPTI),
  written into ``logdir`` as a Chrome trace JSON (Perfetto and
  ``chrome://tracing`` load it);
* :func:`annotate` — a named range (``torch.profiler.record_function``)
  that shows on that timeline, so the trace maps back to framework stages;
* :func:`start_trace_server` — a long-lived localhost HTTP endpoint an
  operator asks for a capture window of a live process
  (``GET /trace?seconds=S``); each request writes one trace into the
  server's logdir and answers with its path.

Host side: the device trace shows what the card did, not what the *host*
threads were doing while it starved — :func:`profile_block` samples every
Python thread's stack at a fixed cadence (``sys._current_frames``, no
instrumentation, a few µs per sample) and writes a **collapsed-stack**
file (``stack;frames;leaf count`` lines, the format flamegraph.pl /
speedscope / inferno eat directly). :func:`maybe_profile` runs a block
under it when ``SPARKDL_TORCH_PROFILE=1``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator
from urllib.parse import parse_qs, urlparse

import torch

__all__ = [
    "StackProfile",
    "TraceCapture",
    "annotate",
    "maybe_profile",
    "profile_block",
    "start_trace_server",
    "trace",
]

#: Truthy -> maybe_profile samples the block under profile_block.
PROFILE_ENV = "SPARKDL_TORCH_PROFILE"
#: Where maybe_profile writes its .folded files (default: cwd).
PROFILE_DIR_ENV = "SPARKDL_TORCH_PROFILE_DIR"
#: Sampling cadence override, Hz (default 99 — deliberately not a round
#: 100 so the sampler cannot alias against 10ms-periodic work).
PROFILE_HZ_ENV = "SPARKDL_TORCH_PROFILE_HZ"

#: Frames kept per stack (deeper tails are truncated at the root end).
_MAX_DEPTH = 128

#: One torch.profiler session at a time per process (the profiler is
#: process-wide): trace() blocks and server captures take turns.
_TRACE_LOCK = threading.Lock()
_TRACE_SEQ = itertools.count()

#: The longest window one trace-server request may ask for, seconds.
MAX_TRACE_SECONDS = 60.0


class TraceCapture:
    """What :func:`trace` captured: ``path`` of the Chrome trace JSON
    (set when the block exits) and the ``profiler`` itself, whose
    ``key_averages()`` tabulate the window."""

    __slots__ = ("path", "profiler")

    def __init__(self):
        self.path: "str | None" = None
        self.profiler: "torch.profiler.profile | None" = None


@contextlib.contextmanager
def trace(logdir: "str | os.PathLike",
          create_perfetto_trace: bool = False) -> Iterator[TraceCapture]:
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``logdir`` (created if missing) as
    ``sparkdl-trace-<pid>-<n>.json``. CUDA activity is recorded where a
    card is present, and the block's device work is waited for before
    the window closes, so kernels the block enqueued land in it.
    ``create_perfetto_trace`` keeps the reference's signature: the
    Chrome trace is already what Perfetto loads."""
    del create_perfetto_trace
    logdir = os.fspath(logdir)
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    cap = TraceCapture()
    with _TRACE_LOCK:
        with torch.profiler.profile(activities=activities) as prof:
            cap.profiler = prof
            try:
                yield cap
            finally:
                if cuda:
                    torch.cuda.synchronize()
        cap.path = os.path.join(
            logdir, f"sparkdl-trace-{os.getpid()}-{next(_TRACE_SEQ)}.json")
        prof.export_chrome_trace(cap.path)


def annotate(name: str):
    """Named region that shows up on the trace timeline (host ops and the
    kernels they launch).

    Use around logical phases of a step (decode / infeed / apply) so the
    trace view maps back to framework stages.
    """
    return torch.profiler.record_function(name)


class _TraceRequestHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (http.server's name)
        url = urlparse(self.path)
        if url.path != "/trace":
            self.send_error(404, "GET /trace?seconds=S")
            return
        try:
            seconds = float(parse_qs(url.query).get("seconds", ["1"])[0])
            if not 0 < seconds <= MAX_TRACE_SECONDS:
                raise ValueError(f"seconds must be in (0, {MAX_TRACE_SECONDS}]")
        except ValueError as e:
            self.send_error(400, str(e))
            return
        with trace(self.server.logdir) as cap:
            time.sleep(seconds)
        body = json.dumps({"path": cap.path, "seconds": seconds}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # requests are not the process's log
        pass


class TraceServer(ThreadingHTTPServer):
    """The live profiling endpoint (see :func:`start_trace_server`):
    ``port`` is the bound port, ``logdir`` where captures land;
    :meth:`close` stops it."""

    daemon_threads = True

    def __init__(self, port: int, logdir: str):
        super().__init__(("127.0.0.1", port), _TraceRequestHandler)
        self.port = self.server_address[1]
        self.logdir = logdir
        self._thread = threading.Thread(
            target=self.serve_forever, name="sparkdl-trace-server",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.shutdown()
        self.server_close()
        self._thread.join(timeout=5)


def start_trace_server(port: int = 9999, *,
                       logdir: "str | os.PathLike | None" = None
                       ) -> TraceServer:
    """Start the live profiling server on this host: an HTTP endpoint on
    ``127.0.0.1:port`` (0 = any free port) where ``GET
    /trace?seconds=S`` (at most :data:`MAX_TRACE_SECONDS`) captures a
    :func:`trace` window of ``S`` seconds of the whole process into
    ``logdir`` (a new temporary directory by default) and answers
    ``{"path": ..., "seconds": S}``."""
    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="sparkdl-traces-")
    return TraceServer(port, os.fspath(logdir))


class StackProfile:
    """Wall-clock sampler of every Python thread's stack.

    A daemon thread wakes every ``interval_s`` and snapshots
    ``sys._current_frames()`` — sampling, not tracing: zero cost between
    samples, a few µs per live thread per sample, and the result is a
    statistical flame graph of where host threads actually sit (queue
    waits, decode loops, GIL-held numpy stacking, ...). The sampler
    excludes itself.
    """

    def __init__(self, interval_s: float = 0.0101):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = interval_s
        #: collapsed stack (root-first, ';'-joined) -> sample count
        self.samples: "collections.Counter[str]" = collections.Counter()
        self.n_samples = 0
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def start(self) -> "StackProfile":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="sparkdl-stack-sampler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def _loop(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.interval_s):
            self.sample_once(_skip_ident=me)

    def sample_once(self, _skip_ident: "int | None" = None) -> None:
        """Take one sample of every live thread (public for tests)."""
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            if ident == _skip_ident:
                continue
            stack = []
            f = frame
            while f is not None and len(stack) < _MAX_DEPTH:
                co = f.f_code
                stack.append(
                    f"{os.path.basename(co.co_filename)}:{co.co_name}"
                )
                f = f.f_back
            stack.append(names.get(ident, f"thread-{ident}"))
            self.samples[";".join(reversed(stack))] += 1
        self.n_samples += 1

    def write_collapsed(self, path: "str | os.PathLike") -> int:
        """Write the ``stack count`` lines flamegraph.pl / speedscope /
        inferno consume. Returns the number of distinct stacks."""
        with open(path, "w") as f:
            for stack, count in sorted(self.samples.items()):
                f.write(f"{stack} {count}\n")
        return len(self.samples)


@contextlib.contextmanager
def profile_block(path: "str | os.PathLike | None" = None, *,
                  interval_s: float = 0.0101) -> Iterator[StackProfile]:
    """Sample thread stacks for the duration of the block; write the
    collapsed-stack file to ``path`` on exit (skip the write with
    ``path=None`` and read ``.samples`` directly)."""
    prof = StackProfile(interval_s=interval_s).start()
    try:
        yield prof
    finally:
        prof.stop()
        if path is not None:
            prof.write_collapsed(path)


def maybe_profile(name: str):
    """The bench hook: a no-op context unless ``SPARKDL_TORCH_PROFILE`` is
    truthy, in which case the block runs under :func:`profile_block`
    writing ``sparkdl-profile-<name>-<pid>.folded`` into
    ``SPARKDL_TORCH_PROFILE_DIR`` (default cwd). The path is announced on
    stderr — bench stdout must stay one JSON line."""
    if os.environ.get(PROFILE_ENV, "") in ("", "0"):
        return contextlib.nullcontext(None)
    directory = os.environ.get(PROFILE_DIR_ENV) or "."
    path = os.path.join(
        directory, f"sparkdl-profile-{name}-{os.getpid()}.folded"
    )
    hz = float(os.environ.get(PROFILE_HZ_ENV, "99"))
    if hz <= 0:
        raise ValueError(
            f"{PROFILE_HZ_ENV} must be > 0, got {hz} (unset "
            f"{PROFILE_ENV} to disable profiling instead)"
        )

    @contextlib.contextmanager
    def _ctx():
        t0 = time.perf_counter()
        with profile_block(path, interval_s=1.0 / hz) as prof:
            yield prof
        print(
            f"[profile] {prof.n_samples} samples over "
            f"{time.perf_counter() - t0:.1f}s -> {path} "
            "(flamegraph.pl / speedscope-compatible collapsed stacks)",
            file=sys.stderr,
        )

    return _ctx()
