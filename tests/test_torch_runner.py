"""TorchRunner / HorovodRunner (sparkdl_torch/runner) through the cases of
the reference's tests/runner/test_tpu_runner.py, test_barrier_body.py and
test_rank_watchdog.py, plus the cross-rank metrics roll-up
(``snapshot_across_hosts``) on two ranks and the card-count check of
``local_platform="cuda"``.

Local mode really launches worker processes (gloo on the CPU; the job
bodies live in tests/torch_dist_jobs.py, which imports no jax). The
barrier-task body runs on threads against a faked BarrierTaskContext
with ``distributed_init`` injected, as the reference's tests do.
"""

from __future__ import annotations

import json
import logging
import pickle
import socket
import subprocess
import sys
import threading
import time

import cloudpickle
import pytest

import torch_dist_jobs as jobs
from sparkdl_torch import HorovodRunner, TorchRunner
from sparkdl_torch.runner.backends import (
    _LogRelay,
    _ShipOutput,
    _wait_all,
    local_rank_of,
    resolve_ranks,
    run_barrier_task,
)

CPU = dict(local_platform="cpu", timeout_s=120)


# -- local mode ------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_rank_job():
    return TorchRunner(np=-2, **CPU).run(jobs.rank_info, scale=2.0)


def test_local_mode_two_processes(two_rank_job):
    out = two_rank_job
    assert out["rank"] == 0 and out["nprocs"] == 2  # rank 0's result
    assert out["backend"] == "gloo" and out["cuda_visible"] == ""
    assert out["sum"] == pytest.approx(18.0)  # (1+2) * 3 elements * scale 2


def test_workers_import_no_jax():
    out = TorchRunner(np=-1, **CPU).run(jobs.imported_modules)
    assert not [m for m in out if m == "jax" or m.startswith(("jax.", "flax",
                                                              "sparkdl_tpu"))]


def test_failure_aborts_job():
    with pytest.raises(RuntimeError, match="rank"):
        TorchRunner(np=-2, driver_log_verbosity="none", **CPU).run(jobs.boom)


def test_snapshot_across_hosts_on_two_ranks():
    """Each rank's registry rolls up over the process group; a series
    only rank 1 has rides as a missing value on rank 0 (the key sets are
    unioned first)."""
    agg = TorchRunner(np=-2, driver_log_verbosity="none", **CPU).run(
        jobs.snapshot_job)
    assert agg["sparkdl_rollup_probe_total"] == {"mean": 1.5, "min": 1.0,
                                                 "max": 2.0}
    assert agg["sparkdl_rank1_only_total"] == {"mean": 5.0, "min": 5.0,
                                               "max": 5.0}


def test_cuda_ranks_need_a_card_each(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "-1")
    with pytest.raises(RuntimeError, match="needs 2 cards.*shows 0"):
        TorchRunner(np=-2, local_platform="cuda").run(jobs.rank_info)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    with pytest.raises(RuntimeError, match="needs 2 cards.*shows 1"):
        TorchRunner(np=-2).run(jobs.rank_info)  # "cuda" is the default


def test_horovod_runner_alias_and_argument_checks():
    assert HorovodRunner is TorchRunner
    with pytest.raises(ValueError):
        TorchRunner(np=0)
    with pytest.raises(RuntimeError, match="cluster"):
        TorchRunner(np=4).run(lambda: None)
    with pytest.raises(ValueError):
        TorchRunner(np=-1, driver_log_verbosity="loud")
    with pytest.raises(ValueError, match="platform"):
        TorchRunner(np=-1, local_platform="tpu").run(jobs.rank_info)
    with pytest.raises(ValueError, match="devices_per_process"):
        TorchRunner(np=-1, devices_per_process=2).run(jobs.rank_info)


class _InlineBackend:
    """Runs the (possibly wrapped) fn in-process."""

    def run(self, nprocs, fn, kwargs, verbosity="all"):
        return fn(**kwargs)


def test_metrics_summary_logs_cross_host_rollup(caplog):
    from sparkdl_torch.observability.registry import registry

    registry().reset()

    def main(n):
        registry().counter("sparkdl_rollup_probe_total").inc(n)
        return n * 2

    runner = TorchRunner(np=-1, backend=_InlineBackend(), metrics_summary=True)
    with caplog.at_level(logging.INFO, logger="sparkdl_torch.metrics"):
        assert runner.run(main, n=3) == 6
    recs = [r for r in caplog.records if "all-host metrics" in r.message]
    assert recs, caplog.records
    agg = json.loads(recs[0].message.split("all-host metrics ", 1)[1])
    assert agg["sparkdl_rollup_probe_total"] == {"mean": 3.0, "min": 3.0,
                                                 "max": 3.0}
    caplog.clear()
    registry().reset()
    with caplog.at_level(logging.INFO, logger="sparkdl_torch.metrics"):
        TorchRunner(np=-1, backend=_InlineBackend()).run(main, n=1)
    assert not [r for r in caplog.records if "all-host metrics" in r.message]


# -- the Spark barrier task body --------------------------------------------------

class FakeBarrierTaskContext:
    """allGather + partitionId, semantics-matched to pyspark's barrier
    context: every task calls allGather; messages come back in partition
    order."""

    def __init__(self, partition_id: int, shared: dict):
        self._pid = partition_id
        self._shared = shared

    def partitionId(self) -> int:
        return self._pid

    def allGather(self, message: str) -> list:
        self._shared["msgs"][self._pid] = message
        self._shared["barrier"].wait(timeout=30)
        return [self._shared["msgs"][i] for i in sorted(self._shared["msgs"])]


def _drive(nprocs, fn, kwargs=None, hostnames=None, log_addr=None):
    """Run the real barrier task body on nprocs threads; return
    (results_by_partition, errors, init_records)."""
    payload = cloudpickle.dumps({"fn": fn, "kwargs": kwargs or {}})
    shared = {"msgs": {}, "barrier": threading.Barrier(nprocs)}
    results, errors, records = [None] * nprocs, [None] * nprocs, [None] * nprocs

    def task(i):
        def init(coordinator, n, rank):
            records[i] = (coordinator, n, rank)

        try:
            results[i] = run_barrier_task(
                FakeBarrierTaskContext(i, shared), payload, nprocs,
                {"skip": True}, log_addr=log_addr,
                hostname=(hostnames[i] if hostnames else f"fake-w-{i}"),
                distributed_init=init)
        except BaseException as e:  # noqa: BLE001 - surfaced to the test
            errors[i] = e

    threads = [threading.Thread(target=task, args=(i,)) for i in range(nprocs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return results, errors, records


def test_barrier_task_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """Without ``distributed_init`` a barrier task joins on its card and
    raises on a host with none; gloo on the CPU only when asked for."""
    from sparkdl_torch.runner import backends

    inits = []
    monkeypatch.setattr(backends, "visible_cards", lambda: [])
    monkeypatch.setattr(backends, "init_rank", lambda *a: inits.append(a))
    payload = cloudpickle.dumps({"fn": lambda: "ran", "kwargs": {}})

    def task(**kw):
        ctx = FakeBarrierTaskContext(
            0, {"msgs": {}, "barrier": threading.Barrier(1)})
        return run_barrier_task(ctx, payload, 1, {"skip": True},
                                hostname="fake-w-0", **kw)

    with pytest.raises(RuntimeError, match="sees no CUDA card"):
        task()
    assert inits == []
    assert pickle.loads(task(platform="cpu")) == "ran"
    assert [a[-1] for a in inits] == ["cpu"]


def test_rank0_result_comes_back_and_others_empty():
    results, errors, records = _drive(3, lambda x: {"got": x}, {"x": 7})
    assert errors == [None, None, None]
    non_empty = [r for r in results if r]
    assert len(non_empty) == 1 and pickle.loads(non_empty[0]) == {"got": 7}
    assert len({c for c, _, _ in records}) == 1
    assert sorted(r for _, _, r in records) == [0, 1, 2]


def test_ranks_follow_natural_hostname_order_not_partition_order():
    hostnames = ["t1v-x-w-10", "t1v-x-w-2", "t1v-x-w-0"]
    results, errors, records = _drive(3, lambda: "hi", hostnames=hostnames)
    assert errors == [None, None, None]
    assert [r for _, _, r in records] == [2, 1, 0]
    assert results[2] and not results[0] and not results[1]
    assert all(c.startswith("t1v-x-w-0:") for c, _, _ in records)


def test_rank_assignment_stable_across_retry_with_shuffled_partitions():
    hosts = ["h-3", "h-1", "h-2"]
    _, _, first = _drive(3, lambda: None, hostnames=hosts)
    shuffled = ["h-2", "h-3", "h-1"]
    _, _, second = _drive(3, lambda: None, hostnames=shuffled)
    assert ({h: r for h, (_, _, r) in zip(hosts, first)}
            == {h: r for h, (_, _, r) in zip(shuffled, second)})


def test_tasks_sharing_a_host_take_consecutive_ranks_and_local_cards():
    """A GPU host runs one task per card (the reference's TPU host runs
    one task): two tasks on one host take consecutive ranks, local
    ranks 0 and 1."""
    results, errors, records = _drive(
        3, lambda: None, hostnames=["b-host", "a-host", "b-host"])
    assert errors == [None, None, None]
    assert [r for _, _, r in records] == [1, 0, 2]
    addrs = ["b-host:1", "a-host:2", "b-host:3"]
    assert [local_rank_of(addrs, i) for i in range(3)] == [0, 0, 1]


def test_resolve_ranks_direct():
    ranks, coord = resolve_ranks(["b:1", "a:2", "c:3"])
    assert ranks == [1, 0, 2] and coord == "a:2"


def test_stdout_forwarded_to_driver_relay():
    captured: list[str] = []
    relay = _LogRelay(sink=captured.append)
    try:
        def chatty():
            import os as _os

            _os.write(1, b"hello from the worker\n")
            return 1

        _, errors, _ = _drive(1, chatty, log_addr=relay.address)
        assert errors == [None]
        deadline = time.monotonic() + 5
        while not relay.lines and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        relay.close()
    tagged = [line for line in relay.lines if "hello from the worker" in line]
    assert tagged and tagged[0].startswith("[rank 0] ")
    assert captured == list(relay.lines)


def test_ship_output_tags_ranks_and_relay_reaps_pumps():
    relay = _LogRelay(sink=lambda line: None)
    port = int(relay.address.rsplit(":", 1)[1])
    try:
        import os as _os

        for rank in (0, 1):
            with _ShipOutput(relay.address, rank):
                _os.write(1, f"line from {rank}\n".encode())
        for i in range(50):
            with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
                s.sendall(f"line {i}\n".encode())
        deadline = time.monotonic() + 10
        while ((relay.live_pumps > 0 or len(relay.lines) < 52)
               and time.monotonic() < deadline):
            time.sleep(0.05)
    finally:
        relay.close()
    assert "[rank 0] line from 0" in relay.lines
    assert "[rank 1] line from 1" in relay.lines
    assert relay.live_pumps == 0 and len(relay._pumps) == 0


def test_verbosity_none_and_unreachable_relay_are_harmless():
    results, errors, _ = _drive(2, lambda: "quiet", log_addr=None)
    assert errors == [None, None]
    assert pickle.loads([r for r in results if r][0]) == "quiet"
    with socket.socket() as s:
        s.bind(("", 0))
        dead = f"localhost:{s.getsockname()[1]}"
    with _ShipOutput(dead, 0):
        print("still fine")


class FakeSparkSession:
    """Just enough of SparkSession.sparkContext.parallelize(...).barrier()
    .mapPartitions(...).collect() to drive the REAL SparkBarrierBackend.run
    body, each partition on its own thread."""

    def __init__(self, monkeypatch):
        self._mp = monkeypatch
        self.sparkContext = self

    def parallelize(self, data, n):
        self._n = len(list(data))
        return self

    def barrier(self):
        return self

    def mapPartitions(self, f):
        self._f = f
        return self

    def collect(self):
        from sparkdl_torch.runner import backends

        shared = {"msgs": {}, "barrier": threading.Barrier(self._n)}
        local = threading.local()
        self._mp.setattr(backends, "_get_barrier_context", lambda: local.ctx)
        out, errs = [None] * self._n, [None] * self._n

        def part(i):
            local.ctx = FakeBarrierTaskContext(i, shared)
            try:
                out[i] = list(self._f(iter(())))
            except BaseException as e:  # noqa: BLE001
                errs[i] = e

        threads = [threading.Thread(target=part, args=(i,))
                   for i in range(self._n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        if any(errs):
            raise next(e for e in errs if e)
        return [x for chunk in out for x in chunk]


def test_spark_backend_run_body_with_fake_session(monkeypatch):
    from sparkdl_torch.runner import backends

    inits: list = []
    real_run = backends.run_barrier_task

    def patched_run(ctx, payload, nprocs, opts, log_addr=None, **kw):
        return real_run(
            ctx, payload, nprocs, {"skip": True}, log_addr=log_addr,
            hostname=f"fake-host-{ctx.partitionId()}",
            distributed_init=lambda c, n, r: inits.append((c, n, r)))

    monkeypatch.setattr(backends, "run_barrier_task", patched_run)
    backend = backends.SparkBarrierBackend(
        spark_session=FakeSparkSession(monkeypatch))
    assert backend.run(3, lambda a, b: a + b, {"a": 2, "b": 40},
                       verbosity="none") == 42
    assert sorted(r for _, _, r in inits) == [0, 1, 2]


# -- the rank watchdog -------------------------------------------------------------

def _proc(code: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code])


@pytest.mark.parametrize("codes,grace,want", [
    (("pass", "import time; time.sleep(60)"), 0.3, [1]),      # hung rank
    (("pass", "import time; time.sleep(0.8)"), None, []),     # disabled
    (("pass", "import time; time.sleep(0.4)"), 5.0, []),      # within grace
    (("raise SystemExit(3)", "import time; time.sleep(60)"), 30.0, [0]),
])
def test_rank_watchdog(codes, grace, want):
    procs = [_proc(c) for c in codes]
    t0 = time.monotonic()
    failed = _wait_all(procs, timeout_s=60.0, straggler_grace_s=grace)
    assert failed == want
    assert time.monotonic() - t0 < 10.0  # never the global timeout
    for p in procs:
        p.wait(timeout=5)  # torn down, not left running
