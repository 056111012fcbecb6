"""The port's HPO search (sparkdl_torch/hpo.py, _trial_worker.py) against
the JAX package's (sparkdl_tpu/hpo.py): the same seeded candidates and
the same best from the built-in random search, the thread, process,
callable and Spark trial runners, failure tolerance, card pinning and a
worker that loads nothing of JAX. Exact comparisons: the search is plain
Python on numpy's seeded generator."""

import os

import numpy as np
import pytest

from sparkdl_torch import hpo as thpo
from sparkdl_tpu import hpo as jhpo

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sparkdl_tpu")


def _space(hp):
    return {
        "lr": hp.loguniform("lr", np.log(1e-5), np.log(1e-2)),
        "dropout": hp.uniform("dropout", 0.0, 0.5),
        "batch": hp.choice("batch", [16, 32, 64]),
        "layers": hp.quniform("layers", 1, 4, 1),
        "fixed": "adam",
    }


def _loss(p):
    return (np.log10(p["lr"]) + 3.5) ** 2 + p["dropout"] + p["layers"] / 10 + p["batch"] / 1000


def test_sample_space_matches_jax():
    ours = [thpo.sample_space(_space(thpo.hp), r)
            for r in [np.random.default_rng(4)] for _ in range(25)]
    theirs = [jhpo.sample_space(_space(jhpo.hp), r)
              for r in [np.random.default_rng(4)] for _ in range(25)]
    assert ours == theirs
    assert all(s["fixed"] == "adam" and s["batch"] in (16, 32, 64) for s in ours)


@pytest.mark.parametrize("parallelism", [1, 3])
def test_random_search_matches_jax(parallelism):
    t_ours, t_theirs = thpo.Trials(), jhpo.Trials()
    best = thpo.fmin(_loss, _space(thpo.hp), max_evals=30, seed=7,
                     parallelism=parallelism, trials=t_ours, use_hyperopt=False)
    want = jhpo.fmin(_loss, _space(jhpo.hp), max_evals=30, seed=7,
                     parallelism=parallelism, trials=t_theirs, use_hyperopt=False)
    assert best == want
    assert t_ours.trials == t_theirs.trials
    assert t_ours.losses == t_theirs.losses
    assert best == t_ours.best_trial["params"]


def test_failing_trials_are_recorded_and_the_sweep_survives():
    def objective(p):
        if p["x"] > 0.6:
            raise RuntimeError("boom")
        return {"loss": p["x"], "status": "ok", "aux": 42}

    runs = {}
    for name, mod in (("torch", thpo), ("jax", jhpo)):
        trials = mod.Trials()
        best = mod.fmin(objective, {"x": mod.hp.uniform("x", 0, 1)}, max_evals=20,
                        seed=2, parallelism=4, trials=trials, use_hyperopt=False)
        runs[name] = (best, [(t["tid"], t["status"], t.get("error"))
                             for t in trials.trials])
        assert trials.best_trial["aux"] == 42
    assert runs["torch"] == runs["jax"]
    statuses = [s for _, s, _ in runs["torch"][1]]
    assert "fail" in statuses and "ok" in statuses and len(statuses) == 20


def test_no_successful_trial_raises():
    with pytest.raises(RuntimeError, match="no successful"):
        _ = thpo.Trials(trials=[{"status": "fail", "loss": None}]).best_trial


def test_callable_trial_runner():
    seen = []

    def runner(objective, candidates, parallelism):
        seen.append((len(candidates), parallelism))
        return [{"tid": i, "params": p, "loss": objective(p), "status": "ok"}
                for i, p in enumerate(candidates)]

    best = thpo.fmin(lambda p: abs(p["x"] - 0.3), {"x": thpo.hp.uniform("x", 0, 1)},
                     max_evals=9, seed=1, parallelism=2, trial_runner=runner,
                     use_hyperopt=False)
    want = jhpo.fmin(lambda p: abs(p["x"] - 0.3), {"x": jhpo.hp.uniform("x", 0, 1)},
                     max_evals=9, seed=1, parallelism=2, trial_runner=runner,
                     use_hyperopt=False)
    assert best == want and seen == [(9, 2), (9, 2)]


def test_runner_errors_match_jax():
    for mod in (thpo, jhpo):
        space = {"x": mod.hp.uniform("x", 0, 1)}
        with pytest.raises(ValueError, match="trial_runner"):
            mod.fmin(lambda p: p["x"], space, max_evals=2, use_hyperopt=False,
                     trial_runner="bogus")
        with pytest.raises(RuntimeError, match="SparkSession"):
            mod.fmin(lambda p: p["x"], space, max_evals=2, use_hyperopt=False,
                     trial_runner="spark")
    if thpo._hyperopt is None:
        with pytest.raises(RuntimeError, match="not installed"):
            thpo.fmin(lambda p: p["x"], {"x": thpo.hp.uniform("x", 0, 1)},
                      max_evals=2, use_hyperopt=True)


class _FakeRDD:
    def __init__(self, data):
        self.data = data

    def map(self, fn):
        return _FakeRDD([fn(x) for x in self.data])

    def collect(self):
        return list(self.data)


class _FakeSpark:
    def __init__(self):
        self.calls = []
        self.sparkContext = self

    def parallelize(self, data, numSlices):
        self.calls.append(numSlices)
        return _FakeRDD(list(data))


def test_spark_trial_runner_fans_out_like_jax():
    results = []
    for mod in (thpo, jhpo):
        spark, trials = _FakeSpark(), mod.Trials()
        best = mod.fmin(lambda p: (p["x"] - 2.0) ** 2, {"x": mod.hp.uniform("x", -5, 5)},
                        max_evals=12, seed=5, parallelism=4, trial_runner="spark",
                        spark=spark, trials=trials, use_hyperopt=False)
        assert spark.calls == [4] and len(trials.trials) == 12
        results.append((best, trials.losses))
    assert results[0] == results[1]


def test_process_trials_run_in_fresh_interpreters():
    """trial_runner='processes': each trial in its own interpreter, failures
    recorded, results in trial order, the same best as the JAX package's
    in-process search; unpinned on a host without a card."""
    space = {"x": thpo.hp.uniform("x", -5, 5)}

    def objective(p):
        import os

        if p["x"] < -3.0:
            raise RuntimeError("synthetic trial failure")
        return {"loss": (p["x"] - 2.0) ** 2, "pid": os.getpid(),
                "card": os.environ.get("CUDA_VISIBLE_DEVICES")}

    trials = thpo.Trials()
    best = thpo.fmin(objective, space, max_evals=6, seed=3, parallelism=3,
                     trial_runner="processes", trials=trials, use_hyperopt=False)
    want = jhpo.fmin(lambda p: (p["x"] - 2.0) ** 2 if p["x"] >= -3.0 else 1 / 0,
                     {"x": jhpo.hp.uniform("x", -5, 5)}, max_evals=6, seed=3,
                     use_hyperopt=False)
    assert best == want
    assert [t["tid"] for t in trials.trials] == list(range(6))
    ok = [t for t in trials.trials if t["status"] == "ok"]
    failed = [t for t in trials.trials if t["status"] == "fail"]
    assert ok and failed and "synthetic trial failure" in failed[0]["error"]
    pids = {t["pid"] for t in ok}
    assert os.getpid() not in pids and len(pids) == len(ok)
    if not thpo.local_cards():  # unpinned: the environment as it is
        assert all(t["card"] == os.environ.get("CUDA_VISIBLE_DEVICES") for t in ok)


def test_process_trials_pin_one_card_each():
    """Each concurrent trial gets its own card through CUDA_VISIBLE_DEVICES;
    trials beyond the cards queue for a free one."""
    def objective(p):
        import os
        import time

        time.sleep(0.3)  # hold the card so concurrent trials overlap
        return {"loss": p["x"], "card": os.environ.get("CUDA_VISIBLE_DEVICES")}

    res = thpo._run_trials_processes(objective, [{"x": 0.0}, {"x": 1.0}], 2,
                                     pin_devices=[3, 5])
    assert sorted(r["card"] for r in res) == ["3", "5"]
    res = thpo._run_trials_processes(objective, [{"x": float(i)} for i in range(3)], 3,
                                     pin_devices=[0, 1])
    assert len(res) == 3 and all(r["status"] == "ok" for r in res)
    assert {r["card"] for r in res} <= {"0", "1"}
    res = thpo._run_trials_processes(objective, [{"x": 0.0}], 1, pin_devices=[])
    assert res[0]["card"] == os.environ.get("CUDA_VISIBLE_DEVICES")


def test_trial_worker_loads_no_jax():
    """The worker interpreter imports sparkdl_torch only: nothing of JAX,
    Flax or sparkdl_tpu is loaded when a trial runs."""
    forbidden = FORBIDDEN

    def objective(p):
        import sys

        import sparkdl_torch.hpo  # noqa: F401  (what the worker imported)

        loaded = sorted(m for m in sys.modules if m.split(".")[0] in forbidden)
        return {"loss": p["x"], "loaded": loaded,
                "port": "sparkdl_torch._trial_worker" in sys.modules
                or "__main__" in sys.modules}

    res = thpo._run_trials_processes(objective, [{"x": 1.0}], 1, pin_devices=[])
    assert res[0]["status"] == "ok", res
    assert res[0]["loaded"] == [] and res[0]["port"]


def test_worker_main_records_results(tmp_path):
    """_trial_worker.main in process: ok and failing objectives."""
    from sparkdl_torch import _trial_worker

    pickler = thpo._pickler()
    for objective, status in ((lambda p: p["x"] * 2, "ok"), (lambda p: 1 / 0, "fail")):
        payload, result = tmp_path / "in.pkl", tmp_path / "out.pkl"
        with open(payload, "wb") as f:
            pickler.dump({"objective": objective, "params": {"x": 2.0}}, f)
        assert _trial_worker.main(str(payload), str(result)) == 0
        with open(result, "rb") as f:
            r = pickler.load(f)
        assert r["status"] == status
        if status == "ok":
            assert r["loss"] == 4.0
        else:
            assert r["loss"] is None and "ZeroDivisionError" in r["error"]
