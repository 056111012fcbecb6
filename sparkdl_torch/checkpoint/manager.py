"""Async checkpointing on ``torch.distributed.checkpoint`` (DCP): the
port of ``sparkdl_tpu.checkpoint.manager`` (which runs on Orbax).

Conventions, as the reference's:

* one item, the train state, a dict of tensors (``model``, ``optim``,
  ``step``), saved under ``<directory>/<step>/``;
* every save is asynchronous after a synchronous host snapshot: the
  tensors are copied to host memory in :meth:`CheckpointManager.save`
  (into pinned buffers reused from save to save), and DCP writes them
  from a background thread while the next steps run; :meth:`wait` and
  :meth:`close` drain. One save is in flight at a time;
* atomicity: a save is written to ``<step>.tmp`` and renamed to
  ``<step>`` once every rank's files landed; ``keep`` bounds disk usage
  (the oldest landed steps are removed);
* restore-into-template: the caller passes the live state (the module's
  parameters, the optimizer's state tensors, sharded ones as DTensors)
  and DCP loads the checkpoint INTO those tensors, resharding it when
  the layout (world size, ZeRO sharding) differs from the saving run's.

Integrity: each landed step gets a sha256 over its files in a sidecar
manifest (``sparkdl_integrity.json``, outside every step dir), recorded
at the ``wait()``/``restore()``/``close()`` barriers. ``restore()``
verifies the chosen step and **falls back to the newest intact step**
when the newest one is torn, quarantining it
(``sparkdl_checkpoint_corrupt_total`` /
``sparkdl_checkpoint_fallbacks_total``); a pinned step that fails raises
:class:`CheckpointCorruptError`. Queueing a save runs under a small
:class:`~sparkdl_torch.reliability.retry.RetryPolicy`.

Across ranks the writes are coordinated over a gloo process group of
their own, made at construction by every rank together, so the
background writer never shares a communicator with the train step's
collectives; rank 0 renames, collects garbage, hashes and writes the
manifest, and the ranks agree on every restore decision.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import queue
import shutil
import threading
import time
from typing import Any

from sparkdl_torch.observability import flight
from sparkdl_torch.observability.registry import registry
from sparkdl_torch.observability.tracing import record_span, span
from sparkdl_torch.reliability.faults import fault_point
from sparkdl_torch.reliability.retry import RetryPolicy
from sparkdl_torch.runtime.mesh import world_rank, world_size

_log = logging.getLogger(__name__)

#: Sidecar manifest (NOT inside any step dir, so GC never eats it).
MANIFEST_NAME = "sparkdl_integrity.json"

_METRICS = None


def _metrics() -> dict:
    global _METRICS
    if _METRICS is None:
        r = registry()
        _METRICS = {
            "saves": r.counter("sparkdl_checkpoint_saves_total",
                               "checkpoint saves queued"),
            "restores": r.counter("sparkdl_checkpoint_restores_total",
                                  "checkpoint restores"),
            "save_time": r.histogram(
                "sparkdl_checkpoint_save_seconds",
                "synchronous (host-snapshot) part of an async save"),
            "restore_time": r.histogram("sparkdl_checkpoint_restore_seconds",
                                        "restore wall time"),
            "wait_time": r.histogram(
                "sparkdl_checkpoint_wait_seconds",
                "time blocked draining queued async saves"),
            "corrupt": r.counter(
                "sparkdl_checkpoint_corrupt_total",
                "checkpoints that failed integrity verification"),
            "fallbacks": r.counter(
                "sparkdl_checkpoint_fallbacks_total",
                "restores that fell back past a corrupt newest step"),
        }
    return _METRICS


class CheckpointCorruptError(RuntimeError):
    """The requested checkpoint failed integrity verification (and, for
    latest-step restores, so did every older candidate)."""


def _integrity_verdict(verdict: str, *, step: "int | None" = None,
                       directory: "str | None" = None,
                       pinned: bool = False) -> None:
    """Publish the restore-side integrity verdict for ``/healthz`` and
    postmortems: ``intact`` / ``fallback`` / ``unreadable`` (every
    candidate failed with NO digest mismatch: possibly the caller's
    template, so it only degrades health) / ``corrupt``."""
    flight.set_health_fact("checkpoint_integrity", {
        "verdict": verdict,
        "step": step,
        "directory": directory,
        "pinned": pinned,
        "time_unix": time.time(),
    })


def checkpoint_digest(step_dir: str) -> dict:
    """Content digest of one landed step directory: sha256 over (sorted
    relative path, file bytes) pairs, so any truncation, missing file or
    flipped byte changes it. Sizes/count ride along for debugging."""
    h = hashlib.sha256()
    n_files = 0
    n_bytes = 0
    for root, dirs, files in os.walk(step_dir):
        dirs.sort()  # in-place: pins the walk's traversal order
        for name in sorted(files):
            path = os.path.join(root, name)
            rel = os.path.relpath(path, step_dir)
            h.update(rel.encode())
            h.update(b"\0")
            with open(path, "rb") as f:
                while True:
                    chunk = f.read(1 << 22)
                    if not chunk:
                        break
                    h.update(chunk)
            n_files += 1
            n_bytes += os.path.getsize(path)
    return {"sha256": h.hexdigest(), "files": n_files, "bytes": n_bytes}


def _landed_steps(directory: str) -> "list[int]":
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(int(n) for n in names
                  if n.isdigit() and os.path.isdir(os.path.join(directory, n)))


def _restore_errors() -> tuple:
    """What a failed restore raises: any Exception, and DCP's
    CheckpointException (a BaseException)."""
    from torch.distributed.checkpoint import CheckpointException

    return (Exception, CheckpointException)


def _tensor_leaves(tree: Any, path: tuple = ()) -> "dict[tuple, Any]":
    """``{path: tensor}`` of a nested dict's tensor leaves."""
    import torch

    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_tensor_leaves(v, path + (k,)))
    elif isinstance(tree, torch.Tensor):
        out[path] = tree
    return out


def _write_back(template: Any, live: "dict[tuple, Any]") -> None:
    """Make the restore land in the template's own tensors: DCP fills a
    DTensor leaf through a tensor of its own, so each loaded leaf whose
    storage is not the live one is copied into it and put back."""
    import torch

    loaded = _tensor_leaves(template)
    for path, t in live.items():
        got = loaded.get(path)
        if got is None or got is t:
            continue
        mine = t.to_local() if hasattr(t, "to_local") else t
        theirs = got.to_local() if hasattr(got, "to_local") else got
        if theirs.data_ptr() != mine.data_ptr():
            with torch.no_grad():
                mine.copy_(theirs)
        node = template
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = t


class _Snapshot:
    """The synchronous half of a save: every tensor of the state copied
    to host memory. Device tensors go through pinned buffers kept from
    save to save (one copy each, then one wait); DTensors keep their
    mesh and placements around the copied local shard."""

    def __init__(self):
        self._bufs: "dict[str, Any]" = {}

    def take(self, state: Any) -> Any:
        import torch

        pending = []

        def copy(name: str, t: Any) -> Any:
            if not isinstance(t, torch.Tensor):
                return t
            local = t.to_local() if hasattr(t, "to_local") else t
            local = local.detach()
            if local.device.type == "cpu":
                host = local.clone()
            else:
                buf = self._bufs.get(name)
                if (buf is None or buf.shape != local.shape
                        or buf.dtype != local.dtype):
                    buf = self._bufs[name] = torch.empty(
                        local.shape, dtype=local.dtype, pin_memory=True)
                buf.copy_(local, non_blocking=True)
                pending.append(local.device)
                host = buf
            if hasattr(t, "to_local"):
                from torch.distributed.tensor import DTensor

                return DTensor.from_local(
                    host, t.device_mesh, t.placements, run_check=False,
                    shape=t.shape, stride=t.stride())
            return host

        def walk(node: Any, prefix: str) -> Any:
            if isinstance(node, dict):
                return {k: walk(v, f"{prefix}.{k}") for k, v in node.items()}
            return copy(prefix, node)

        out = walk(state, "")
        for dev in set(pending):
            torch.cuda.synchronize(dev)
        return out


class CheckpointManager:
    """Async DCP checkpoints of a train state under ``directory``.

    >>> ckpt = CheckpointManager(dir, keep=3)
    >>> ckpt.save(step, state)            # async; returns once snapshotted
    >>> state = ckpt.restore(template=state)   # newest INTACT step
    >>> ckpt.close()

    Every rank of a process group constructs, saves, restores and closes
    together (the calls are collective).
    """

    def __init__(self, directory: "str | os.PathLike", *, keep: int = 3,
                 save_interval_steps: int = 1,
                 verify_integrity: bool = True,
                 retry: "RetryPolicy | None" = None):
        self.directory = os.fspath(directory)
        self.keep = keep
        self.save_interval_steps = save_interval_steps
        self.verify_integrity = verify_integrity
        self._retry = retry if retry is not None else RetryPolicy(
            max_attempts=3, base_delay_s=0.02, max_delay_s=0.5,
            retryable=(OSError, RuntimeError),
        )
        self._world, self._rank = world_size(), world_rank()
        self._pg = None
        if self._world > 1:
            import torch.distributed as dist

            self._pg = dist.new_group(backend="gloo")
        os.makedirs(self.directory, exist_ok=True)
        #: steps queued or landed by this manager (the skip policy)
        self._newest_queued = max(_landed_steps(self.directory), default=None)
        #: steps queued whose digest is not yet recorded (digests hash
        #: what is ON DISK, so they finalize at the next barrier)
        self._pending_digest: "set[int]" = set()
        self._snapshot = _Snapshot()
        self._jobs: "queue.Queue" = queue.Queue()
        self._error: "BaseException | None" = None
        self._idle = threading.Event()
        self._idle.set()
        self._writer = threading.Thread(target=self._write_loop, daemon=True,
                                        name="sparkdl-checkpoint-writer")
        self._writer.start()
        self._closed = False

    # -- collectives over the checkpoint group -------------------------------
    def _barrier(self) -> None:
        if self._pg is not None:
            import torch.distributed as dist

            dist.barrier(group=self._pg)

    def _agree(self, value: Any) -> Any:
        """Rank 0's ``value`` on every rank."""
        if self._pg is None:
            return value
        import torch.distributed as dist

        box = [value]
        dist.broadcast_object_list(box, src=dist.get_global_rank(self._pg, 0),
                                   group=self._pg)
        return box[0]

    def _all_ok(self, ok: bool) -> bool:
        """True on every rank iff ``ok`` on every rank."""
        if self._pg is None:
            return ok
        import torch
        import torch.distributed as dist

        flag = torch.tensor([0 if ok else 1])
        dist.all_reduce(flag, group=self._pg)
        return int(flag) == 0

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Snapshot ``state`` to host memory and queue its write at
        ``step``. Returns False when the interval policy skipped it
        (``force=True`` bypasses the policy), or when ``step`` is not
        newer than the newest step saved or queued."""
        step = int(step)
        if not force and step % self.save_interval_steps != 0:
            return False
        if self._newest_queued is not None and step <= self._newest_queued:
            return False
        t0 = time.monotonic()

        def queue_save():
            fault_point("checkpoint.save")
            self._drain()  # one save in flight: its buffers are reused
            snap = self._snapshot.take(state)
            self._idle.clear()
            self._jobs.put((step, snap))

        self._retry.call(queue_save, site="checkpoint.save")
        self._newest_queued = step
        _metrics()["saves"].inc()
        _metrics()["save_time"].observe(time.monotonic() - t0)
        record_span("checkpoint.save", t0, time.monotonic(), step=step)
        if self.verify_integrity:
            self._pending_digest.add(step)
        return True

    def _write_loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            step, snap = job
            try:
                self._write(step, snap)
            except BaseException as e:  # surfaced at the next barrier
                _log.error("checkpoint step %s write failed: %r", step, e)
                self._error = e
            finally:
                if self._jobs.empty():
                    self._idle.set()

    def _write(self, step: int, snap: Any) -> None:
        import torch.distributed.checkpoint as dcp

        tmp = os.path.join(self.directory, f"{step}.tmp")
        final = os.path.join(self.directory, str(step))
        if self._rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)  # a crashed attempt's
        t0 = time.monotonic()
        writer = dcp.FileSystemWriter(tmp)
        if self._pg is None:
            dcp.save(snap, storage_writer=writer, no_dist=True)
        else:
            dcp.save(snap, storage_writer=writer, process_group=self._pg)
            self._barrier()  # every rank's files landed
        if self._rank == 0:
            os.replace(tmp, final)
            self._gc()
        record_span("checkpoint.write", t0, time.monotonic(), step=step)

    def _gc(self) -> None:
        steps = _landed_steps(self.directory)
        for s in steps[:max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, str(s)),
                          ignore_errors=True)

    def _drain(self) -> None:
        self._idle.wait()
        err, self._error = self._error, None
        if err is not None:
            raise err

    def wait(self) -> None:
        """Block until every queued async save has landed on disk."""
        t0 = time.perf_counter()
        self._drain()
        self._finalize_digests()
        _metrics()["wait_time"].observe(time.perf_counter() - t0)

    # -- integrity -----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    def _load_manifest(self) -> dict:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _write_manifest(self, manifest: dict) -> None:
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, sort_keys=True)
        os.replace(tmp, self._manifest_path())

    def _step_dir(self, step: int) -> "str | None":
        path = os.path.join(self.directory, str(step))
        return path if os.path.isdir(path) else None

    def _finalize_digests(self) -> "dict[int, dict]":
        """Record digests for landed saves and prune GC'd steps (rank 0),
        then a barrier. Returns the digests computed by this call so a
        restore can verify a step without hashing it twice."""
        fresh: "dict[int, dict]" = {}
        if self.verify_integrity and self._rank == 0:
            live = set(_landed_steps(self.directory))
            manifest = self._load_manifest()
            changed = False
            for step in sorted(self._pending_digest):
                d = self._step_dir(step)
                if step in live and d is not None:
                    digest = checkpoint_digest(d)
                    manifest[str(step)] = digest
                    fresh[step] = digest
                    changed = True
            stale = [k for k in manifest if int(k) not in live]
            for k in stale:
                del manifest[k]
                changed = True
            if changed:
                self._write_manifest(manifest)
        self._pending_digest.clear()
        self._barrier()
        return fresh

    def _quarantine_step(self, step: int) -> None:
        """Rename a corrupt step dir out of the step namespace (rank 0):
        the bytes stay for forensics, and a resumed run re-reaching the
        step can save it again."""
        d = self._step_dir(step)
        if d is None or self._rank != 0:
            return
        for n in range(100):
            suffix = f"-{n}" if n else ""
            dest = os.path.join(
                self.directory, f"corrupt-step-{int(step)}{suffix}")
            if os.path.exists(dest):
                continue
            try:
                os.rename(d, dest)
            except OSError as e:  # pragma: no cover - fs-dependent
                _log.warning(
                    "could not quarantine corrupt checkpoint step %s "
                    "(%r); a resumed run may fail to re-save it", step, e)
                return
            manifest = self._load_manifest()
            if manifest.pop(str(int(step)), None) is not None:
                self._write_manifest(manifest)
            _log.warning("quarantined corrupt checkpoint step %s -> %s",
                         step, dest)
            return

    def verify(self, step: int, *,
               _actual: "dict | None" = None) -> "bool | None":
        """Integrity check of one landed step against the manifest: True
        = digest matches; False = corrupt (mismatch or missing files);
        None = no recorded digest (the caller decides)."""
        recorded = self._load_manifest().get(str(int(step)))
        if recorded is None:
            return None
        if _actual is None:
            d = self._step_dir(int(step))
            if d is None:
                return False
            _actual = checkpoint_digest(d)
        return _actual["sha256"] == recorded["sha256"]

    # -- restore -------------------------------------------------------------
    def latest_step(self) -> "int | None":
        steps = _landed_steps(self.directory)
        return steps[-1] if steps else None

    def all_steps(self) -> "list[int]":
        return _landed_steps(self.directory)

    def restore(self, step: "int | None" = None, *, template: Any) -> Any:
        """Restore ``step`` (default: the newest INTACT one) into
        ``template``, a dict of tensors shaped and placed like the state
        (DTensors for sharded leaves): DCP writes the checkpoint into
        those tensors in place and reshards it where the saving run's
        layout differs. Returns ``template``.

        A latest-step restore verifies each candidate against the
        manifest and falls back past torn steps, quarantining them. A
        step with no recorded digest that fails to load is quarantined
        only once an older step restores (until then the failure could
        be the template's). A pinned ``step`` never falls back: a digest
        mismatch raises :class:`CheckpointCorruptError`, a load failure
        propagates. ``verify_integrity=False``: one restore of the chosen
        step, errors as they come."""
        self._drain()
        fresh = self._finalize_digests()
        if step is not None:
            candidates = [int(step)]
            pinned = True
        else:
            candidates = self._agree(
                sorted(_landed_steps(self.directory), reverse=True))
            pinned = False
        if not candidates:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        if not self.verify_integrity:
            return self._do_restore(candidates[0], template)
        m = _metrics()
        errors: "list[str]" = []
        suspects: "list[int]" = []
        definite_corruption = False
        for i, s in enumerate(candidates):
            ok = self._agree(self.verify(s, _actual=fresh.get(int(s)))
                             if self._rank == 0 else None)
            if ok is False:
                m["corrupt"].inc()
                definite_corruption = True
                flight.record_event("checkpoint.corrupt", step=int(s),
                                    directory=self.directory)
                msg = f"step {s}: integrity digest mismatch (torn write?)"
                _log.error("checkpoint %s under %s", msg, self.directory)
                if pinned:
                    _integrity_verdict("corrupt", step=int(s),
                                       directory=self.directory, pinned=True)
                    flight.trigger_dump("checkpoint_corrupt", settle_s=0,
                                        step=int(s))
                    raise CheckpointCorruptError(
                        f"requested checkpoint {msg} under {self.directory}")
                errors.append(msg)
                self._quarantine_step(s)
                self._barrier()
                continue
            error: "BaseException | None" = None
            try:
                out = self._do_restore(s, template)
            except _restore_errors() as e:
                error = e
            if not self._all_ok(error is None):
                if error is None:
                    error = RuntimeError("another rank failed to restore")
                if ok is True or pinned:
                    # the step verified INTACT: not corruption (the
                    # template is wrong, or the device failed)
                    raise error
                _log.error("checkpoint step %s under %s failed to restore: "
                           "%r", s, self.directory, error)
                errors.append(f"step {s}: restore failed: {error!r}")
                suspects.append(int(s))
                continue
            for sus in suspects:
                m["corrupt"].inc()
                flight.record_event("checkpoint.corrupt", step=int(sus),
                                    directory=self.directory)
                self._quarantine_step(sus)
            self._barrier()
            if i > 0:
                m["fallbacks"].inc()
                flight.record_event("checkpoint.fallback", step=int(s),
                                    skipped=i, directory=self.directory)
                _integrity_verdict("fallback", step=int(s),
                                   directory=self.directory)
                _log.warning(
                    "restored fallback step %s under %s (newer candidate(s) "
                    "corrupt: %s)", s, self.directory, "; ".join(errors))
            else:
                _integrity_verdict("intact", step=int(s),
                                   directory=self.directory)
            # a quarantined newer step frees its number for a re-save
            self._newest_queued = max(_landed_steps(self.directory),
                                      default=None)
            return out
        _integrity_verdict(
            "corrupt" if definite_corruption else "unreadable",
            directory=self.directory)
        flight.trigger_dump("checkpoint_corrupt", settle_s=0)
        raise CheckpointCorruptError(
            f"no intact checkpoint under {self.directory}: "
            + "; ".join(errors))

    def _do_restore(self, step: int, template: Any) -> Any:
        import torch.distributed.checkpoint as dcp

        d = os.path.join(self.directory, str(int(step)))
        if not os.path.isdir(d):
            raise FileNotFoundError(f"no checkpoint step {step} under "
                                    f"{self.directory}")
        t0 = time.perf_counter()
        live = _tensor_leaves(template)
        with span("checkpoint.restore", step=int(step)):
            reader = dcp.FileSystemReader(d)
            if self._pg is None:
                dcp.load(template, storage_reader=reader, no_dist=True)
            else:
                dcp.load(template, storage_reader=reader,
                         process_group=self._pg)
        _write_back(template, live)
        _metrics()["restores"].inc()
        _metrics()["restore_time"].observe(time.perf_counter() - t0)
        return template

    def close(self) -> None:
        if self._closed:
            return
        try:
            self._drain()
            self._finalize_digests()
        finally:
            self._closed = True
            self._jobs.put(None)
            self._writer.join(timeout=60)

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- module-level conveniences (single-shot paths) ---------------------------

def save_and_wait(directory: "str | os.PathLike", step: int, state: Any) -> None:
    """Synchronous one-shot save (estimator/model export paths)."""
    with CheckpointManager(directory) as mgr:
        mgr.save(step, state, force=True)


def latest_step(directory: "str | os.PathLike") -> "int | None":
    steps = _landed_steps(os.fspath(directory))
    return steps[-1] if steps else None


def restore_matching(directory: "str | os.PathLike", template: Any,
                     step: "int | None" = None) -> Any:
    """One-shot restore into ``template``."""
    with CheckpointManager(directory) as mgr:
        return mgr.restore(step, template=template)
