"""FaultPlan/fault_point: parse syntax, deterministic triggers, metrics,
and the zero-cost-when-disarmed contract the hot paths rely on.

The port's copy (sparkdl_torch/reliability/faults.py), after the JAX
package's suite tests/reliability/test_faults.py, and faults injected
into the port's feed: a failed dispatch or readback surfaces on its own
batch, after the rows of the batches before it."""

import os
import subprocess
import sys
import textwrap
import time

import pytest

from sparkdl_torch.observability.registry import registry
from sparkdl_torch.reliability import faults
from sparkdl_torch.reliability.faults import (
    FaultPlan,
    FaultRule,
    fault_point,
    inject,
)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    yield
    faults.disarm()


class TestParse:
    def test_full_syntax(self):
        p = FaultPlan.parse(
            "seed=9; dispatch:OSError@3; fetch%0.25; "
            "replica.execute:TimeoutError@2*4; checkpoint.save@1*"
        )
        assert p.seed == 9
        by_site = {r.site: r for r in p.rules}
        assert by_site["dispatch"].exc_type is OSError
        assert by_site["dispatch"].on_hit == 3
        assert by_site["dispatch"].times == 1
        assert by_site["fetch"].p == 0.25
        assert by_site["replica.execute"].on_hit == 2
        assert by_site["replica.execute"].times == 4
        assert by_site["checkpoint.save"].times is None  # forever

    def test_bare_site_means_first_hit(self):
        (rule,) = FaultPlan.parse("dispatch").rules
        assert rule.on_hit == 1 and rule.exc_type is RuntimeError

    def test_unknown_exception_rejected(self):
        with pytest.raises(ValueError, match="unknown exception"):
            FaultPlan.parse("dispatch:NoSuchError@1")

    def test_non_exception_builtin_rejected(self):
        with pytest.raises(ValueError, match="unknown exception"):
            FaultPlan.parse("dispatch:print@1")

    def test_empty_plan_rejected(self):
        with pytest.raises(ValueError, match="no rules"):
            FaultPlan.parse("seed=3")

    def test_bad_probability_rejected(self):
        with pytest.raises(ValueError):
            FaultPlan.parse("dispatch%1.5")

    def test_exactly_one_trigger(self):
        with pytest.raises(ValueError, match="exactly one"):
            FaultRule("dispatch", on_hit=1, p=0.5)
        with pytest.raises(ValueError, match="exactly one"):
            FaultRule("dispatch")


class TestTriggers:
    def test_nth_hit_fires_once(self):
        with inject("dispatch:OSError@3"):
            outcomes = []
            for _ in range(6):
                try:
                    fault_point("dispatch")
                    outcomes.append("ok")
                except OSError:
                    outcomes.append("boom")
        assert outcomes == ["ok", "ok", "boom", "ok", "ok", "ok"]

    def test_window_and_forever(self):
        with inject("dispatch@2*2") as p:
            outcomes = []
            for _ in range(5):
                try:
                    fault_point("dispatch")
                    outcomes.append("ok")
                except RuntimeError:
                    outcomes.append("boom")
            assert outcomes == ["ok", "boom", "boom", "ok", "ok"]
            assert p.snapshot()["injected"]["dispatch"] == 2
        with inject("dispatch@2*"):
            outcomes = []
            for _ in range(5):
                try:
                    fault_point("dispatch")
                    outcomes.append("ok")
                except RuntimeError:
                    outcomes.append("boom")
            assert outcomes == ["ok", "boom", "boom", "boom", "boom"]

    def test_probability_is_seed_deterministic(self):
        def run(seed):
            out = []
            with inject(FaultPlan.parse(f"seed={seed};dispatch%0.5")):
                for _ in range(32):
                    try:
                        fault_point("dispatch")
                        out.append(0)
                    except RuntimeError:
                        out.append(1)
            return out

        a, b = run(11), run(11)
        assert a == b  # same seed, same execution order -> same faults
        assert 0 < sum(a) < 32  # it does actually fire sometimes
        assert run(12) != a  # and the seed matters

    def test_unarmed_site_never_fires(self):
        with inject("dispatch@1"):
            fault_point("fetch")  # no rule for this site

    def test_message_names_site_and_hit(self):
        with inject("dispatch:OSError@1"):
            with pytest.raises(OSError, match="site 'dispatch'.*hit 1"):
                fault_point("dispatch")

    def test_injections_land_in_registry(self):
        fam = registry().get("sparkdl_faults_injected_total")
        before = (fam.snapshot_values().get('site="dispatch"', 0.0)
                  if fam else 0.0)
        with inject("dispatch@1*3"):
            for _ in range(5):
                try:
                    fault_point("dispatch")
                except RuntimeError:
                    pass
        fam = registry().get("sparkdl_faults_injected_total")
        assert fam.snapshot_values()['site="dispatch"'] == before + 3


class TestArming:
    def test_inject_restores_previous_plan(self):
        outer = faults.arm("dispatch@100")
        try:
            with inject("fetch@1"):
                assert faults.active_plan() is not outer
            assert faults.active_plan() is outer
        finally:
            faults.disarm()

    def test_inject_restores_on_exception(self):
        with pytest.raises(ValueError):
            with inject("dispatch@1"):
                raise ValueError("body blew up")
        assert faults.active_plan() is None

    def test_env_plan_parsing(self, monkeypatch):
        monkeypatch.setenv(faults.ENV_VAR, "worker.rank@2")
        p = FaultPlan.from_env()
        assert p is not None and p.rules[0].site == "worker.rank"
        monkeypatch.setenv(faults.ENV_VAR, "")
        assert FaultPlan.from_env() is None


def test_env_plan_armed_at_import_in_a_fresh_interpreter():
    """``SPARKDL_TORCH_FAULT_PLAN`` is parsed once at import: a child
    process inheriting it fires at the planned hit with no plumbing."""
    code = textwrap.dedent("""
        from sparkdl_torch.reliability.faults import fault_point
        fault_point("dispatch")
        print("survived 1")
        fault_point("dispatch")
        print("survived 2")
    """)
    env = {**os.environ, "SPARKDL_TORCH_FAULT_PLAN": "dispatch:RuntimeError@2"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "survived 1" in proc.stdout and "survived 2" not in proc.stdout
    assert "dispatch" in proc.stderr


def _rows(n):
    import numpy as np

    return [{"x": np.full((3,), float(i), np.float32)} for i in range(n)]


SETTINGS = [dict(prefetch=0, chain_k=1, async_fetch=False), dict(chain_k=1),
            dict(chain_k=1, fetch_window=4), dict(chain_k=2, fetch_window=1)]


@pytest.mark.parametrize("site,settings", [("dispatch", s) for s in SETTINGS]
                         + [("fetch", s) for s in SETTINGS[1:]])
def test_feed_fault_surfaces_where_the_jax_runner_surfaces_it(site, settings):
    """The same plan armed in each package's runner over the same rows:
    the same rows come out, in order, before the same injected error (a
    dispatch fault after every earlier batch's rows; a fetch fault when
    its fetch is started, so rows still in the readback window behind it
    are not delivered). Disarmed again, the runner serves the stream."""
    import jax.numpy as jnp

    from sparkdl_torch.transformers._inference import BatchedRunner
    from sparkdl_tpu.reliability.faults import inject as jax_inject
    from sparkdl_tpu.transformers._inference import BatchedRunner as JaxRunner

    def run(runner, arm):
        got = []
        with arm(f"{site}:RuntimeError@3"):
            with pytest.raises(RuntimeError, match=site):
                for o in runner.run(iter(_rows(20))):
                    got.append(float(o[0]))
        return got

    r = BatchedRunner(lambda b: b["x"] * 2, batch_size=4, device="cpu",
                      **settings)
    got = run(r, inject)
    want = run(JaxRunner(lambda b: jnp.asarray(b["x"]) * 2, batch_size=4,
                         data_parallel=False, **settings), jax_inject)
    assert got == want
    if site == "dispatch" and settings["chain_k"] == 1:
        assert got == [2.0 * i for i in range(8)]  # batches 1 and 2
    assert len(list(r.run(iter(_rows(20))))) == 20


def test_run_batch_async_fault_is_the_callers():
    import numpy as np

    from sparkdl_torch.transformers._inference import BatchedRunner

    r = BatchedRunner(lambda b: b["x"] + 1, batch_size=4, device="cpu")
    with inject("dispatch:RuntimeError@1"):
        with pytest.raises(RuntimeError, match="dispatch"):
            r.run_batch({"x": np.ones((2, 3), np.float32)})
    np.testing.assert_array_equal(
        r.run_batch({"x": np.ones((2, 3), np.float32)}), np.full((2, 3), 2.0))


def test_disarmed_fault_point_is_nearly_free():
    """The hot-path contract: disarmed fault_point must be invisible next
    to any device dispatch (measured ~100ns; the bound is generous for
    loaded CI hosts)."""
    n = 50_000
    fault_point("dispatch")  # warm
    t0 = time.perf_counter()
    for _ in range(n):
        fault_point("dispatch")
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 2e-6, f"disarmed fault_point {per_call*1e9:.0f}ns"
