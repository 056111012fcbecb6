"""Cluster backends for TorchRunner: local processes and Spark barrier
jobs. The port of ``sparkdl_tpu.runner.backends``.

HorovodRunner's two regimes, ``np < 0`` local debug processes and
``np > 0`` Spark barrier tasks with a rendezvous, map to
:class:`LocalProcessBackend` (subprocesses on this host, one card each)
and :class:`SparkBarrierBackend` (barrier tasks, rendezvous through
``BarrierTaskContext.allGather``). Both end in
``torch.distributed.init_process_group`` (NCCL on cards, gloo on the
CPU): the in-step collectives are the partitioner's, so the runner only
bootstraps the group.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
from typing import Any, Callable

logger = logging.getLogger(__name__)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _pickler():
    """cloudpickle where it is installed (closures and lambdas travel by
    value), else the standard pickle (module-level functions only)."""
    try:
        import cloudpickle as pickler
    except ImportError:
        import pickle as pickler
    return pickler


def visible_cards() -> "list[str]":
    """The card ids this process may hand out, one per local rank:
    ``CUDA_VISIBLE_DEVICES`` where set, else every card (none without
    CUDA)."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        ids = [x.strip() for x in env.split(",") if x.strip()]
        # a negative id hides that card and every later one
        out = []
        for x in ids:
            if x.startswith("-"):
                break
            out.append(x)
        return out
    import torch

    return ([str(i) for i in range(torch.cuda.device_count())]
            if torch.cuda.is_available() else [])


def process_group_backend(platform: str) -> str:
    """``nccl`` for ``cuda`` ranks, ``gloo`` for ``cpu`` ones."""
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"platform must be 'cuda' or 'cpu', got {platform!r}")
    return "nccl" if platform == "cuda" else "gloo"


def init_rank(coordinator: str, nprocs: int, rank: int,
              platform: str) -> None:
    """Join the job's process group as ``rank`` of ``nprocs``: the
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` variables
    set, then ``init_process_group`` over ``tcp://coordinator`` (on a
    card: the card this process sees first, connected eagerly)."""
    import torch
    import torch.distributed as dist

    host, port = coordinator.rsplit(":", 1)
    os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, RANK=str(rank),
                      WORLD_SIZE=str(nprocs))
    kw = {}
    if platform == "cuda":
        torch.cuda.set_device(0)
        kw["device_id"] = torch.device("cuda", 0)
    dist.init_process_group(process_group_backend(platform),
                            init_method=f"tcp://{coordinator}",
                            world_size=nprocs, rank=rank, **kw)


class LocalProcessBackend:
    """Run n ranks as subprocesses of this host (HorovodRunner np<0 mode).

    Each rank is a fresh interpreter that joins one process group: on
    ``platform="cuda"`` each rank sees one card (``CUDA_VISIBLE_DEVICES``
    pinned to a card of its own, so NCCL never puts two ranks on one);
    on ``"cpu"`` the ranks see no card and talk over gloo.
    """

    def __init__(self, devices_per_process: int = 1,
                 platform: str = "cuda", timeout_s: float = 600.0,
                 straggler_grace_s: "float | None" = None):
        if devices_per_process != 1:
            raise ValueError(
                "devices_per_process must be 1: a rank drives one card")
        process_group_backend(platform)
        self.devices_per_process = devices_per_process
        self.platform = platform
        self.timeout_s = timeout_s
        #: Rank watchdog: once the FIRST rank exits, surviving ranks get
        #: this many extra seconds before they are torn down as hung (a
        #: rank wedged in a collective its peers already left). None
        #: disables it.
        self.straggler_grace_s = straggler_grace_s

    def run(self, nprocs: int, fn: Callable, kwargs: dict,
            verbosity: str = "all") -> Any:
        pickler = _pickler()
        pins: "list[dict]" = [{} for _ in range(nprocs)]
        if self.platform == "cuda":
            cards = visible_cards()
            if nprocs > len(cards):
                raise RuntimeError(
                    f"np=-{nprocs} on local_platform='cuda' needs {nprocs} "
                    f"cards, one a rank (NCCL refuses two ranks on one "
                    f"card), and this host shows {len(cards)}")
            pins = [{"CUDA_VISIBLE_DEVICES": cards[r]} for r in range(nprocs)]
        else:
            pins = [{"CUDA_VISIBLE_DEVICES": ""} for _ in range(nprocs)]
        workdir = tempfile.mkdtemp(prefix="sparkdl_torch_run_")
        payload_path = os.path.join(workdir, "payload.pkl")
        result_path = os.path.join(workdir, "result.pkl")
        with open(payload_path, "wb") as f:
            pickler.dump({"fn": fn, "kwargs": kwargs}, f)
        coordinator = f"localhost:{free_port()}"
        # children must resolve the same modules as the parent (the user
        # fn may be pickled by reference to a module only on its path)
        child_env = os.environ.copy()
        child_env["PYTHONPATH"] = os.pathsep.join(
            [p for p in sys.path if p] + [child_env.get("PYTHONPATH", "")]
        ).rstrip(os.pathsep)
        procs: list[subprocess.Popen] = []
        streams: list[threading.Thread] = []
        try:
            for rank in range(nprocs):
                env = dict(child_env, **pins[rank], LOCAL_RANK=str(rank),
                           LOCAL_WORLD_SIZE=str(nprocs))
                p = subprocess.Popen(
                    [
                        sys.executable, "-m", "sparkdl_torch.runner._worker",
                        payload_path, str(rank), str(nprocs), coordinator,
                        result_path, self.platform,
                    ],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                    env=env,
                )
                procs.append(p)
                t = threading.Thread(
                    target=_stream_output, args=(p, rank, verbosity),
                    daemon=True)
                t.start()
                streams.append(t)

            failed = _wait_all(procs, self.timeout_s,
                               self.straggler_grace_s)
            for t in streams:
                t.join(timeout=5)
            if failed:
                ranks = ", ".join(str(r) for r in failed)
                raise RuntimeError(
                    f"TorchRunner local job failed on rank(s) {ranks} "
                    f"(barrier semantics: whole job aborted)"
                )
            return _load_result(result_path)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    pass
            shutil.rmtree(workdir, ignore_errors=True)


def _stream_output(proc: subprocess.Popen, rank: int, verbosity: str) -> None:
    assert proc.stdout is not None
    for line in proc.stdout:
        if verbosity == "all":
            print(f"[rank {rank}] {line}", end="", flush=True)
        else:
            logger.debug("[rank %d] %s", rank, line.rstrip())


def _wait_all(procs: list[subprocess.Popen], timeout_s: float,
              straggler_grace_s: "float | None" = None) -> list[int]:
    """Wait for every rank; on first failure or timeout kill the rest.

    ``straggler_grace_s`` is the rank watchdog: once the first rank has
    exited (cleanly), ranks still running past the grace window are
    declared hung and torn down — without it a single wedged rank holds
    the job until the global ``timeout_s``.

    Returns the list of failed ranks (empty on success).
    """
    import time

    deadline = time.monotonic() + timeout_s
    pending = dict(enumerate(procs))
    failed: list[int] = []
    first_exit_at: "float | None" = None
    while pending and not failed:
        for rank, p in list(pending.items()):
            rc = p.poll()
            if rc is None:
                continue
            del pending[rank]
            if rc != 0:
                failed.append(rank)
        now = time.monotonic()
        if (pending and first_exit_at is None
                and len(pending) < len(procs)):
            first_exit_at = now
        if (pending and not failed
                and straggler_grace_s is not None
                and first_exit_at is not None
                and now > first_exit_at + straggler_grace_s):
            logger.error(
                "rank watchdog: rank(s) %s still running %.1fs after "
                "the first rank exited; tearing down as hung",
                sorted(pending), straggler_grace_s,
            )
            failed.extend(pending.keys())
            break
        if now > deadline:
            failed.extend(pending.keys())
            break
        time.sleep(0.05)
    for p in pending.values():
        p.kill()
    return sorted(failed)


def _load_result(result_path: str) -> Any:
    if not os.path.exists(result_path):
        raise RuntimeError("rank 0 produced no result file")
    with open(result_path, "rb") as f:
        status, value = pickle.load(f)
    if status == "unpicklable":
        raise RuntimeError(
            f"rank 0's return value could not be pickled: {value}"
        )
    return value


def _host_sort_key(hostname: str) -> tuple:
    """Natural sort key: digit runs compare numerically.

    Cluster worker hostnames carry the worker index as a trailing integer
    (``...-w-0``, ``...-w-1``, ... ``...-w-10``); natural order makes
    rank assignment follow the hosts' order, and plain string sort would
    put ``-w-10`` before ``-w-2``.
    """
    import re

    return tuple(
        int(part) if part.isdigit() else part
        for part in re.split(r"(\d+)", hostname)
    )


def resolve_ranks(addrs: list[str]) -> tuple[list[int], str]:
    """Map barrier-task rendezvous addresses to stable process ranks.

    ``addrs[i]`` is partition *i*'s ``host:port``. Returns
    ``(rank_of_partition, coordinator_address)``: ranks follow the
    natural-sorted hostname, NOT the Spark partition id, so a stage retry
    that lands partitions on other executors keeps each host's ranks as
    long as the host set is unchanged. The coordinator is whichever task
    sorts first.

    A GPU host runs one task per card: tasks on one host take
    consecutive ranks (in partition order) and, on the host, local ranks
    0, 1, ... (:func:`local_rank_of`), each its own card.
    """
    hosts = [a.rsplit(":", 1)[0] for a in addrs]
    order = sorted(range(len(addrs)),
                   key=lambda i: (_host_sort_key(hosts[i]), i))
    rank_of_partition = [0] * len(addrs)
    for rank, part in enumerate(order):
        rank_of_partition[part] = rank
    return rank_of_partition, addrs[order[0]]


def local_rank_of(addrs: list[str], partition: int) -> int:
    """The index of ``partition``'s task among the tasks of its host, in
    rank order: its card on that host."""
    ranks, _ = resolve_ranks(addrs)
    host = addrs[partition].rsplit(":", 1)[0]
    return sum(1 for i, a in enumerate(addrs)
               if a.rsplit(":", 1)[0] == host and ranks[i] < ranks[partition])


def run_barrier_task(
    ctx,
    payload: bytes,
    nprocs: int,
    preflight_opts: dict,
    log_addr: "str | None" = None,
    hostname: "str | None" = None,
    distributed_init: "Callable | None" = None,
    platform: str = "cuda",
) -> bytes:
    """Body of one Spark barrier task, extracted so a faked
    BarrierTaskContext (``partitionId()`` + ``allGather(str)``) can drive
    it without pyspark.

    ``distributed_init(coordinator, nprocs, rank)`` defaults to
    :func:`init_rank` on ``platform``: on ``"cuda"`` this task's card
    (NCCL, its local rank pinned through ``CUDA_VISIBLE_DEVICES``),
    raising on a host without one; on ``"cpu"`` gloo. Tests inject a
    recorder. Returns rank 0's pickled result (b"" on other ranks).
    """
    if platform not in ("cuda", "cpu"):
        raise ValueError(
            f"platform must be 'cuda' or 'cpu', got {platform!r}")
    pickler = _pickler()
    hostname = hostname or socket.gethostname()
    port = free_port()
    addrs = list(ctx.allGather(f"{hostname}:{port}"))
    if len(addrs) != nprocs:
        raise RuntimeError(
            f"rendezvous returned {len(addrs)} addresses for {nprocs} tasks"
        )
    rank_of_partition, coordinator = resolve_ranks(addrs)
    rank = rank_of_partition[ctx.partitionId()]

    with _ShipOutput(log_addr, rank):
        if distributed_init is None:
            cards = visible_cards() if platform == "cuda" else []
            if platform == "cuda" and not cards:
                raise RuntimeError(
                    f"barrier task on host {hostname} sees no CUDA card; "
                    "TorchRunner needs one card per task (the CPU only "
                    "when asked for: platform='cpu')")
            if cards:
                local = local_rank_of(addrs, ctx.partitionId())
                if local >= len(cards):
                    raise RuntimeError(
                        f"barrier placement error: {local + 1} tasks on "
                        f"host {hostname} and {len(cards)} cards: "
                        "TorchRunner needs one card per task")
                os.environ["CUDA_VISIBLE_DEVICES"] = cards[local]
            try:
                init_rank(coordinator, nprocs, rank, platform)
            except Exception as e:
                # most likely the coordinator port advertised at the
                # rendezvous was taken before the bind: failing the task
                # makes Spark retry the stage with a fresh port
                raise RuntimeError(
                    f"init_process_group failed on rank {rank} "
                    f"(coordinator {coordinator}): {e}. If this is a port "
                    f"collision the stage retry re-rendezvouses cleanly."
                ) from e
        else:
            distributed_init(coordinator, nprocs, rank)
        # health probe before the user fn builds anything: a bad card
        # fails this barrier task now, and the stage retry plus the
        # checkpoint resume (sparkdl_torch.checkpoint) handle the rest
        from sparkdl_torch.observability.health import preflight

        preflight(rank=rank, **preflight_opts)
        p = pickler.loads(payload)
        out = p["fn"](**p["kwargs"])
    return pickle.dumps(out) if rank == 0 else b""


def _get_barrier_context():
    """Executor-side hook returning the live barrier context; module-level
    so suites without pyspark can monkeypatch a fake in under the REAL
    ``SparkBarrierBackend.run`` body."""
    from pyspark import BarrierTaskContext

    return BarrierTaskContext.get()


class _LogRelay:
    """Driver-side TCP line sink for executor stdout (HorovodRunner's
    ``driver_log_verbosity`` equivalent, SURVEY.md 2.13).

    Executors already need driver connectivity in Spark (block manager,
    barrier coordination), so a plain listening socket on the driver is
    reachable wherever Spark itself works. Each task connects once and
    streams ``[rank N] ...`` lines; the relay prints them into the driver
    log as they arrive.
    """

    def __init__(self, sink: "Callable[[str], None] | None" = None,
                 keep_lines: int = 10_000):
        import collections

        self._sink = sink or (lambda line: print(line, flush=True))
        #: bounded tail of forwarded lines (test/inspection hook; the full
        #: stream goes to the sink) — unbounded would leak driver memory
        #: over a long job's worth of executor output.
        self.lines: "collections.deque[str]" = collections.deque(
            maxlen=keep_lines)
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("", 0))
        self._srv.listen(64)
        self._srv.settimeout(0.2)
        self.address = f"{socket.gethostname()}:{self._srv.getsockname()[1]}"
        self._closing = threading.Event()
        #: live pump threads only — each pump removes itself on disconnect,
        #: so a long job's worth of short-lived connections does not
        #: accumulate one dead Thread object per connection
        self._pumps: "set[threading.Thread]" = set()
        self._pumps_lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._accept_thread.start()

    @property
    def live_pumps(self) -> int:
        """Number of currently-connected executor streams."""
        with self._pumps_lock:
            return len(self._pumps)

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(
                target=self._pump, args=(conn,), daemon=True
            )
            with self._pumps_lock:
                self._pumps.add(t)
            t.start()

    def _pump(self, conn: socket.socket) -> None:
        try:
            with conn, conn.makefile("r", errors="replace") as f:
                for line in f:
                    line = line.rstrip("\n")
                    self.lines.append(line)
                    self._sink(line)
        finally:
            with self._pumps_lock:
                self._pumps.discard(threading.current_thread())

    def close(self) -> None:
        self._closing.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2)
        with self._pumps_lock:
            pumps = list(self._pumps)
        for t in pumps:
            t.join(timeout=2)


class _ShipOutput:
    """Executor-side context manager: tee this process's stdout/stderr to
    the driver's :class:`_LogRelay` while the user fn runs.

    File-descriptor level (dup2), so native prints (NCCL, C++ bridge) ship
    too, not just Python ``print``. Lines still reach the executor's own
    log via the tee. No-op when ``addr`` is None (verbosity 'none') or the
    relay is unreachable — log forwarding must never fail the job.
    """

    def __init__(self, addr: "str | None", rank: int):
        self.addr = addr
        self.rank = rank
        self._sock = None
        self._saved: list[tuple[int, int]] = []
        self._pump_thread = None

    def __enter__(self):
        if self.addr is None:
            return self
        try:
            host, port = self.addr.rsplit(":", 1)
            self._sock = socket.create_connection((host, int(port)), timeout=5)
        except OSError:
            self._sock = None
            return self
        r, w = os.pipe()
        self._saved = [(1, os.dup(1)), (2, os.dup(2))]
        os.dup2(w, 1)
        os.dup2(w, 2)
        os.close(w)
        self._pump_thread = threading.Thread(
            target=self._pump, args=(r,), daemon=True
        )
        self._pump_thread.start()
        return self

    def _pump(self, rfd: int) -> None:
        orig_out = self._saved[0][1]
        buf = b""
        with os.fdopen(rfd, "rb", closefd=True) as r:
            while True:
                chunk = r.read1(65536)
                if not chunk:
                    break
                os.write(orig_out, chunk)  # tee to the executor's own log
                buf += chunk
                *lines, buf = buf.split(b"\n")
                for line in lines:
                    self._send(line)
        if buf:
            self._send(buf)

    def _send(self, line: bytes) -> None:
        if self._sock is None:
            return
        try:
            self._sock.sendall(b"[rank %d] %s\n" % (self.rank, line))
        except OSError:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __exit__(self, *exc):
        if not self._saved:
            if self._sock is not None:
                self._sock.close()
            return False
        sys.stdout.flush()
        sys.stderr.flush()
        # Restore first: dropping the last write-end refs of the pipe EOFs
        # the pump; only close the saved duplicates after the pump (which
        # tees through one of them) has drained.
        for fd, saved in self._saved:
            os.dup2(saved, fd)
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5)
        for _, saved in self._saved:
            os.close(saved)
        self._saved = []
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        return False


class SparkBarrierBackend:
    """np>0 mode: barrier tasks via a live SparkSession, one per card.

    The task body (:func:`run_barrier_task`) rendezvouses through
    ``BarrierTaskContext.allGather`` (each task publishes ``host:port``),
    resolves stable hostname-ordered ranks, joins the process group with
    the first task as coordinator, runs the user fn with stdout teed to
    the driver, and returns rank 0's result: the reference's mpirun
    bootstrap replaced by an address exchange.
    """

    def __init__(self, spark_session=None, platform: str = "cuda"):
        self.platform = platform
        if spark_session is None:
            from pyspark.sql import SparkSession

            spark_session = SparkSession.getActiveSession()
        if spark_session is None:
            raise RuntimeError(
                "no active SparkSession; np>0 needs a cluster (or use np<0 "
                "local mode)"
            )
        self.spark = spark_session

    def run(self, nprocs: int, fn: Callable, kwargs: dict,
            verbosity: str = "all") -> Any:
        payload = _pickler().dumps({"fn": fn, "kwargs": kwargs})
        sc = self.spark.sparkContext
        # preflight knobs resolve on the DRIVER (executor environments
        # don't inherit the driver's) and ride the task closure
        from sparkdl_torch.observability.health import preflight_env_opts

        preflight_opts = preflight_env_opts()
        relay = _LogRelay() if verbosity == "all" else None
        log_addr = relay.address if relay is not None else None
        platform = self.platform

        def barrier_task(it):
            ctx = _get_barrier_context()
            yield run_barrier_task(
                ctx, payload, nprocs, preflight_opts, log_addr=log_addr,
                platform=platform)

        try:
            results = (
                sc.parallelize(range(nprocs), nprocs)
                .barrier()
                .mapPartitions(barrier_task)
                .collect()
            )
        finally:
            if relay is not None:
                relay.close()
        ranked = [r for r in results if r]
        if not ranked:
            raise RuntimeError("no rank returned a result")
        return pickle.loads(ranked[0])
