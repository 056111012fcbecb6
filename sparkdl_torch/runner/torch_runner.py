"""TorchRunner: the HorovodRunner-parity distributed runner (the port of
``sparkdl_tpu.runner.tpu_runner.TPURunner``).

``TorchRunner(np).run(main_fn, **kwargs)``:

* ``np < 0``: debug mode, ``|np|`` local processes on this host, one
  card each (``local_platform="cuda"``, NCCL) or on the CPU
  (``local_platform="cpu"``, gloo);
* ``np > 0``: cluster mode, one Spark barrier task per card.

Inside ``main_fn`` there is no ``hvd.init()``/``DistributedOptimizer``:
the process is already a rank of the job's ``torch.distributed`` process
group, and ``finetune_classifier`` under a data-parallel partitioner
(partition/) writes the gradient collectives into its step.
``HorovodRunner`` is exported as an alias so reference call sites run
unchanged.

By design one default differs from the reference's: ``local_platform``
is ``"cuda"``, because the port's entry points run on the card unless
asked otherwise (the reference's local mode fakes devices on the CPU).
"""

from __future__ import annotations

from typing import Any, Callable

from sparkdl_torch.runner.backends import LocalProcessBackend, SparkBarrierBackend

_VERBOSITIES = ("all", "none")


class TorchRunner:
    """Launch a function on every rank of a job and return rank 0's
    result to the driver."""

    def __init__(self, np: int, driver_log_verbosity: str = "all",
                 backend=None, devices_per_process: int = 1,
                 local_platform: str = "cuda",
                 timeout_s: float = 600.0,
                 metrics_summary: bool = False,
                 straggler_grace_s: "float | None" = None):
        if np == 0:
            raise ValueError("np must be a non-zero integer")
        if driver_log_verbosity not in _VERBOSITIES:
            raise ValueError(
                f"driver_log_verbosity must be one of {_VERBOSITIES}"
            )
        self.np = int(np)
        self.driver_log_verbosity = driver_log_verbosity
        self.metrics_summary = metrics_summary
        self._backend = backend
        self._devices_per_process = devices_per_process
        self._local_platform = local_platform
        self._timeout_s = timeout_s
        #: rank watchdog grace (local mode): once the first rank exits,
        #: survivors past this window are torn down as hung. None =
        #: disabled.
        self._straggler_grace_s = straggler_grace_s

    def run(self, main: Callable, **kwargs: Any) -> Any:
        """Run ``main(**kwargs)`` on all ranks; returns rank 0's result.

        With ``metrics_summary=True`` every rank's metrics registry is
        aggregated across ranks after its ``main`` returns (mean/min/max
        per series, ``snapshot_across_hosts``) and rank 0 logs the
        roll-up under the ``sparkdl_torch.metrics`` logger. The roll-up
        is a collective: if one rank's ``main`` raises, the survivors
        block in it until the backend tears the job down.
        """
        if not callable(main):
            raise TypeError("main must be callable")
        backend = self._backend or self._default_backend()
        fn = _with_metrics_summary(main) if self.metrics_summary else main
        return backend.run(
            abs(self.np), fn, kwargs, verbosity=self.driver_log_verbosity
        )

    def _default_backend(self):
        if self.np < 0:
            return LocalProcessBackend(
                devices_per_process=self._devices_per_process,
                platform=self._local_platform,
                timeout_s=self._timeout_s,
                straggler_grace_s=self._straggler_grace_s,
            )
        try:
            return SparkBarrierBackend()
        except Exception as e:
            raise RuntimeError(
                f"np={self.np} requires a cluster backend: {e}. Use a "
                "negative np for local debug mode, or pass backend= "
                "explicitly."
            ) from e


class _MetricsSummary:
    """``main`` wrapped so every rank joins the post-run metrics roll-up
    (a class, not a closure, so the standard pickle carries it)."""

    def __init__(self, main: Callable):
        self.main = main

    def __call__(self, **kwargs):
        result = self.main(**kwargs)
        import json
        import logging

        from sparkdl_torch.observability.registry import snapshot_across_hosts
        from sparkdl_torch.runtime.mesh import world_rank

        try:
            agg = snapshot_across_hosts()
            if agg and world_rank() == 0:
                logging.getLogger("sparkdl_torch.metrics").info(
                    "all-host metrics %s", json.dumps(agg, sort_keys=True))
        except Exception:  # observability must never fail the job
            logging.getLogger("sparkdl_torch.metrics").warning(
                "cross-host metrics rollup failed", exc_info=True)
        return result


def _with_metrics_summary(main: Callable) -> Callable:
    return _MetricsSummary(main)


#: Drop-in alias: reference code ``HorovodRunner(np=...).run(fn)`` runs as-is.
HorovodRunner = TorchRunner
