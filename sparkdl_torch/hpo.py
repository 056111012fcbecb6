"""Hyperopt-style distributed hyperparameter search: the port of
``sparkdl_tpu.hpo``.

Databricks pairs HorovodRunner with Hyperopt's ``fmin``/``SparkTrials``
for distributed HPO (BERT-base fine-tuning with a Hyperopt sweep is one of
the reference's benchmark configurations). Hyperopt itself is an optional
dependency: when installed, :func:`fmin` delegates to it; otherwise a
built-in random-search engine with the same call shape runs, so the API
works in hermetic environments. The search is plain Python; a trial's
objective does its own device work (e.g. ``train.finetune_classifier`` on
the card).

Trials execute through a pluggable ``trial_runner``: threads of the
calling process by default, one fresh interpreter per trial (each pinned
to one card with ``CUDA_VISIBLE_DEVICES``), Spark tasks, or a callable of
your own.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Sequence

import numpy as np

logger = logging.getLogger(__name__)

try:  # optional, API-compatible fast path
    import hyperopt as _hyperopt
except Exception:  # pragma: no cover - not in the hermetic image
    _hyperopt = None


# --------------------------------------------------------------------------
# Search-space primitives (hyperopt.hp-compatible subset)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Dist:
    kind: str
    label: str
    args: tuple

    def sample(self, rng: np.random.Generator) -> Any:
        if self.kind == "uniform":
            lo, hi = self.args
            return float(rng.uniform(lo, hi))
        if self.kind == "loguniform":
            lo, hi = self.args  # log-space bounds, as in hyperopt
            return float(np.exp(rng.uniform(lo, hi)))
        if self.kind == "quniform":
            lo, hi, q = self.args
            return float(np.round(rng.uniform(lo, hi) / q) * q)
        if self.kind == "choice":
            (options,) = self.args
            return options[int(rng.integers(len(options)))]
        raise ValueError(f"unknown dist {self.kind}")


class hp:
    """Drop-in subset of ``hyperopt.hp``."""

    @staticmethod
    def uniform(label: str, low: float, high: float) -> _Dist:
        return _Dist("uniform", label, (low, high))

    @staticmethod
    def loguniform(label: str, low: float, high: float) -> _Dist:
        return _Dist("loguniform", label, (low, high))

    @staticmethod
    def quniform(label: str, low: float, high: float, q: float) -> _Dist:
        return _Dist("quniform", label, (low, high, q))

    @staticmethod
    def choice(label: str, options: Sequence[Any]) -> _Dist:
        return _Dist("choice", label, (tuple(options),))


def sample_space(space: dict, rng: np.random.Generator) -> dict:
    return {
        k: v.sample(rng) if isinstance(v, _Dist) else v
        for k, v in space.items()
    }


@dataclasses.dataclass
class Trials:
    """Result log (hyperopt.Trials-shaped: .trials, .best_trial)."""

    trials: list[dict] = dataclasses.field(default_factory=list)

    @property
    def best_trial(self) -> dict:
        ok = [t for t in self.trials if t["status"] == "ok"]
        if not ok:
            raise RuntimeError("no successful trials")
        return min(ok, key=lambda t: t["loss"])

    @property
    def losses(self) -> list[float | None]:
        return [t.get("loss") for t in self.trials]


def _eval_trial(objective, i, params) -> dict:
    """One trial -> result record; failures never kill the sweep."""
    try:
        out = objective(params)
        loss = out["loss"] if isinstance(out, dict) else float(out)
        extra = out if isinstance(out, dict) else {}
        return {"tid": i, "params": params, "loss": float(loss),
                "status": "ok", **{k: v for k, v in extra.items()
                                   if k not in ("loss", "status")}}
    except Exception as e:
        logger.warning("trial %d failed: %s", i, e)
        return {"tid": i, "params": params, "loss": None,
                "status": "fail", "error": repr(e)}


def _pickler():
    """cloudpickle where it is installed (closures and lambdas travel by
    value), else the standard pickle (module-level objectives only)."""
    try:
        import cloudpickle as pickler
    except ImportError:
        import pickle as pickler
    return pickler


def local_cards() -> list[int]:
    """The local CUDA cards' indices (none on a host without CUDA)."""
    import torch

    return list(range(torch.cuda.device_count())) if torch.cuda.is_available() else []


def _run_trials_processes(objective, candidates, parallelism,
                          pin_devices: "list[int] | None" = None
                          ) -> list[dict]:
    """Each trial in a FRESH interpreter (own CUDA context), at most
    ``parallelism`` concurrent — the single-host analogue of SparkTrials'
    executor-side evaluation.

    Each trial is PINNED to one local card with ``CUDA_VISIBLE_DEVICES``,
    handed out round-robin from a free pool, so two trials never share a
    card; trials beyond the card count queue for a free card.
    ``pin_devices`` overrides the detected card list (:func:`local_cards`);
    hosts with no card run unpinned.
    """
    import subprocess
    import sys
    import tempfile
    import time as _time

    pickler = _pickler()
    if pin_devices is None:
        pin_devices = local_cards()
    if pin_devices and parallelism > len(pin_devices):
        logger.warning(
            "trial_runner='processes' parallelism=%d exceeds the %d local "
            "card(s); excess trials queue for a free card (pass a smaller "
            "parallelism to silence this)", parallelism, len(pin_devices),
        )
    free_cards = list(pin_devices)

    pending = list(enumerate(candidates))
    running: dict = {}  # popen -> (tid, params, result_path, card)
    results: list[dict] = []

    with tempfile.TemporaryDirectory(prefix="sparkdl_torch_hpo_") as workdir:
        def launch(i, params):
            payload = os.path.join(workdir, f"trial{i}.pkl")
            result = os.path.join(workdir, f"trial{i}.out")
            with open(payload, "wb") as f:
                pickler.dump({"objective": objective, "params": params}, f)
            card = None
            env = None
            if free_cards:
                card = free_cards.pop(0)
                env = os.environ.copy()
                env["CUDA_VISIBLE_DEVICES"] = str(card)
            p = subprocess.Popen(
                [sys.executable, "-m", "sparkdl_torch._trial_worker",
                 payload, result],
                env=env,
            )
            running[p] = (i, params, result, card)

        try:
            while pending or running:
                while (pending and len(running) < max(1, parallelism)
                       and (not pin_devices or free_cards)):
                    launch(*pending.pop(0))
                done = [p for p in running if p.poll() is not None]
                if not done:
                    _time.sleep(0.05)
                    continue
                for p in done:
                    i, params, rpath, card = running.pop(p)
                    if card is not None:
                        free_cards.append(card)
                    try:
                        with open(rpath, "rb") as f:
                            r = pickler.load(f)
                    except Exception as e:
                        r = {"loss": None, "status": "fail",
                             "error": f"worker died: exit "
                                      f"{p.returncode} ({e!r})"}
                    if r["status"] == "fail":
                        logger.warning("trial %d failed: %s", i,
                                       r.get("error"))
                    results.append({"tid": i, "params": params, **r})
        finally:
            # never orphan worker interpreters if the sweep loop raises
            for p in running:
                if p.poll() is None:
                    p.kill()
            for p in running:
                p.wait(timeout=10)
    results.sort(key=lambda r: r["tid"])
    return results


def _run_trials_spark(objective, candidates, parallelism,
                      spark=None) -> list[dict]:
    """SparkTrials equivalent: one Spark task per trial, fanned over the
    cluster's executors (the reference pairs Hyperopt's SparkTrials with
    HorovodRunner this way). ``spark`` may be a
    SparkSession or anything exposing ``sparkContext.parallelize``."""
    sc = None
    if spark is not None:
        sc = getattr(spark, "sparkContext", spark)
    else:
        try:
            from pyspark.sql import SparkSession

            active = SparkSession.getActiveSession()
            sc = active.sparkContext if active is not None else None
        except Exception:
            sc = None
    if sc is None:
        raise RuntimeError(
            "trial_runner='spark' needs a SparkSession (pass spark=..., "
            "or use 'processes' for single-host isolation)"
        )
    n_slices = max(1, min(parallelism, len(candidates)))
    rdd = sc.parallelize(list(enumerate(candidates)), n_slices)
    return sorted(
        rdd.map(lambda ip: _eval_trial(objective, ip[0], ip[1])).collect(),
        key=lambda r: r["tid"],
    )


def fmin(
    objective: Callable[[dict], float | dict],
    space: dict,
    *,
    max_evals: int = 20,
    seed: int = 0,
    parallelism: int = 1,
    trials: Trials | None = None,
    use_hyperopt: bool | None = None,
    trial_runner: "str | Callable" = "threads",
    spark=None,
) -> dict:
    """Minimise ``objective`` over ``space``; returns the best param dict.

    ``objective`` gets a concrete param dict and returns a float loss (or a
    dict with a ``loss`` key, hyperopt-style). With hyperopt installed and
    a serial configuration (default ``trial_runner`` "threads" and
    ``parallelism=1``) delegates to ``hyperopt.fmin`` + TPE — an explicit
    distributed request (``parallelism>1`` or a 'processes'/'spark'/
    callable ``trial_runner``) opts out, since TPE evaluates serially in
    the calling process (pass ``use_hyperopt=True`` to force the TPE
    path anyway). Otherwise runs seeded random search with
    ``parallelism`` trials at a time through ``trial_runner``:

    - ``"threads"`` — threads of the calling process (trials block on
      device work, so the GIL is not the limiter);
    - ``"processes"`` — one fresh interpreter per trial (own CUDA
      context, one card each), at most ``parallelism`` concurrent;
    - ``"spark"`` — one Spark task per trial over the cluster (the
      SparkTrials pairing; pass ``spark=`` or have an active session);
    - a callable ``f(objective, candidates, parallelism) -> results``.
    """
    if not callable(trial_runner) and trial_runner not in (
            "threads", "processes", "spark"):
        raise ValueError(
            f"unknown trial_runner {trial_runner!r}: expected 'threads', "
            "'processes', 'spark', or a callable"
        )
    if use_hyperopt is None:
        # hyperopt evaluates trials serially in this process, so any explicit
        # signal of distributed intent — a non-default trial_runner OR
        # parallelism>1 — opts out of the auto-upgrade; only the default
        # serial configuration silently takes the TPE path.
        use_hyperopt = (
            _hyperopt is not None
            and trial_runner == "threads"
            and parallelism == 1
        )
        if _hyperopt is not None and not use_hyperopt:
            # a silent TPE -> seeded-random downgrade would cost callers
            # search quality with no signal: say which knob flipped the
            # gate and how to force TPE back on
            logger.warning(
                "hyperopt is installed but the distributed-intent gate "
                "(parallelism=%d, trial_runner=%r) selected seeded random "
                "search over TPE; pass use_hyperopt=True to force the "
                "serial TPE engine instead",
                parallelism, trial_runner,
            )
    if use_hyperopt:
        if _hyperopt is None:
            raise RuntimeError("hyperopt requested but not installed")
        if callable(trial_runner) or trial_runner != "threads":
            logger.warning(
                "hyperopt path evaluates trials serially in this process; "
                "trial_runner=%r ignored — pass use_hyperopt=False for "
                "the distributed trial runners", trial_runner,
            )
        if parallelism > 1:
            logger.warning(
                "hyperopt path runs trials serially (TPE is sequential); "
                "parallelism=%d ignored — pass use_hyperopt=False for the "
                "parallel random-search engine", parallelism,
            )
        hp_space = {
            k: getattr(_hyperopt.hp, v.kind)(v.label, *(
                (list(v.args[0]),) if v.kind == "choice" else v.args
            )) if isinstance(v, _Dist) else v  # constants pass through
            for k, v in space.items()
        }
        ho_trials = _hyperopt.Trials()
        best = _hyperopt.fmin(
            objective, hp_space, algo=_hyperopt.tpe.suggest,
            max_evals=max_evals, rstate=np.random.default_rng(seed),
            trials=ho_trials,
        )
        # space_eval decodes hp.choice indices back to option values so the
        # return contract matches the built-in engine.
        best = dict(_hyperopt.space_eval(hp_space, best))
        if trials is not None:  # mirror the log into the caller's Trials
            for i, t in enumerate(ho_trials.trials):
                ok = t["result"].get("status") == _hyperopt.STATUS_OK
                # hyperopt stores encoded vals ({label: [v]}); decode each
                # trial through space_eval so params holds real option
                # values and trials.best_trial["params"] stays usable.
                vals = {
                    k: v[0]
                    for k, v in t["misc"]["vals"].items() if v
                }
                trials.trials.append({
                    "tid": i,
                    "params": dict(_hyperopt.space_eval(hp_space, vals)),
                    "loss": t["result"].get("loss") if ok else None,
                    "status": "ok" if ok else "fail",
                })
        return best

    trials = trials if trials is not None else Trials()
    rng = np.random.default_rng(seed)
    candidates = [sample_space(space, rng) for _ in range(max_evals)]

    if callable(trial_runner):
        results = trial_runner(objective, candidates, parallelism)
    elif trial_runner == "spark":
        results = _run_trials_spark(objective, candidates, parallelism,
                                    spark=spark)
    elif trial_runner == "processes":
        results = _run_trials_processes(objective, candidates, parallelism)
    else:  # "threads" (validated above)
        if parallelism <= 1:
            results = [_eval_trial(objective, i, p)
                       for i, p in enumerate(candidates)]
        else:
            with ThreadPoolExecutor(max_workers=parallelism) as pool:
                results = list(pool.map(
                    lambda ip: _eval_trial(objective, ip[0], ip[1]),
                    enumerate(candidates),
                ))
    trials.trials.extend(results)
    return dict(trials.best_trial["params"])
