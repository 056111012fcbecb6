"""Pre-flight device/collective health probe: the port of
``sparkdl_tpu.observability.health``.

Each ``TorchRunner`` worker runs it after ``init_process_group`` and
before the user's train function: a wedged card or a broken collective
path fails the job in seconds, inside the barrier task (a cheap retry),
instead of minutes into training.

The probe is deliberately tiny: one addition on this rank's device
(exercises the runtime path to the card) and, with ``collective=True``
on a world larger than one, one all-reduce over every rank (the path the
gradient all-reduce takes).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch


@dataclasses.dataclass
class HealthReport:
    ok: bool
    n_local_devices: int
    n_global_devices: int
    process_index: int
    process_count: int
    platform: str
    device_kinds: list[str]
    probe_time_s: float
    collective_ok: bool
    error: str | None = None

    def summary(self) -> str:
        state = "OK" if self.ok else f"UNHEALTHY: {self.error}"
        return (
            f"[health] {state} — process {self.process_index}/"
            f"{self.process_count}, {self.n_local_devices} local / "
            f"{self.n_global_devices} global {self.platform} devices, "
            f"probe {self.probe_time_s * 1e3:.0f} ms"
        )


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def check_health(*, collective: bool = True,
                 expect_local_devices: int | None = None) -> HealthReport:
    """Probe this rank's device and (optionally) the collective path.

    Raises nothing: always returns a report; the caller decides whether a
    not-ok report aborts the job. This rank's device is the current card
    under an NCCL process group, or with no process group where CUDA is
    available; the CPU otherwise.
    """
    from sparkdl_torch.runtime.mesh import rank_device

    t0 = time.perf_counter()
    error = None
    collective_ok = False
    dist = _dist()
    device = rank_device()
    if dist is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        y = torch.ones(8, device=device) + 1.0  # catches a wedged card
        if not bool((y.cpu() == 2.0).all()):
            raise RuntimeError(f"device probe on {device} computed {y}")
        local = torch.cuda.device_count() if device.type == "cuda" else 1
        if expect_local_devices is not None and local != expect_local_devices:
            raise RuntimeError(
                f"expected {expect_local_devices} local devices, "
                f"found {local}"
            )
    except Exception as e:  # report, don't raise: the caller decides
        error = f"{type(e).__name__}: {e}"
    world = dist.get_world_size() if dist is not None else 1
    if collective and world > 1:
        # EVERY rank enters the all-reduce, even one whose local probe
        # failed: a rank that bailed out here would leave its healthy
        # peers blocked in the collective until the timeout
        try:
            ones = torch.ones(1, device=device)
            dist.all_reduce(ones)
            total = float(ones.cpu())
            if total != float(world):
                raise RuntimeError(f"collective sum {total} != {world}")
            collective_ok = True
        except Exception as e:
            error = error or f"{type(e).__name__}: {e}"
    elif collective:
        collective_ok = True  # one rank: nothing to reduce over
    try:
        kinds = ([torch.cuda.get_device_name(device)]
                 if device.type == "cuda" else ["cpu"])
        n_local = torch.cuda.device_count() if device.type == "cuda" else 1
    except Exception:
        kinds, n_local = [], 0
    return HealthReport(
        ok=error is None,
        n_local_devices=n_local,
        n_global_devices=world,
        process_index=dist.get_rank() if dist is not None else 0,
        process_count=world,
        platform=device.type,
        device_kinds=kinds,
        probe_time_s=time.perf_counter() - t0,
        collective_ok=collective_ok,
        error=error,
    )


def preflight(*, skip: bool = False, profiler_port: int | None = None,
              rank: int = 0) -> HealthReport | None:
    """Shared ``TorchRunner`` worker pre-flight, called after
    ``init_process_group`` on every rank.

    Runs the health probe (unless ``skip``) and raises RuntimeError on an
    unhealthy report so the job fails fast; optionally starts the live
    trace server (``observability/profiling.py``) on localhost port
    ``profiler_port + rank``, and the ``/metrics`` endpoint where
    ``SPARKDL_TORCH_METRICS_PORT`` asks for one (offset by rank). The
    caller resolves the knobs (:func:`preflight_env_opts`).
    """
    report = None
    if not skip:
        report = check_health()
        print(report.summary(), file=sys.stderr)
        if not report.ok:
            raise RuntimeError(report.summary())
    if profiler_port is not None:
        from sparkdl_torch.observability.profiling import start_trace_server

        start_trace_server(int(profiler_port) + rank)
    from sparkdl_torch.observability.exporters import maybe_start_metrics_server

    maybe_start_metrics_server(port_offset=rank)
    return report


def preflight_env_opts() -> dict:
    """The preflight knobs from this process's environment:
    ``SPARKDL_TORCH_SKIP_HEALTH_CHECK`` (truthy) and
    ``SPARKDL_TORCH_PROFILER_PORT``."""
    port = os.environ.get("SPARKDL_TORCH_PROFILER_PORT")
    return {
        "skip": bool(os.environ.get("SPARKDL_TORCH_SKIP_HEALTH_CHECK")),
        "profiler_port": int(port) if port else None,
    }
