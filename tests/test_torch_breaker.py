"""The port's reliability loop pieces against the JAX package's copies:
the ProbationBreaker (the same call sequences at injected ``now`` values
give the same state after every call) and the retry loop
(``RetryPolicy``/``record_retry``: the same attempts, backoff draws,
outcomes and ``sparkdl_retries_total`` increments). Both are
framework-free, so everything here is exact equality.
"""

import pytest

from sparkdl_torch.observability import flight as tflight
from sparkdl_torch.observability.registry import registry as tregistry
from sparkdl_torch.reliability import breaker as tbreaker
from sparkdl_torch.reliability import retry as tretry
from sparkdl_tpu.observability.registry import registry as jregistry
from sparkdl_tpu.reliability import breaker as jbreaker
from sparkdl_tpu.reliability import retry as jretry

_STATE = ("consecutive_failures", "quarantined", "probing",
          "probation_until", "probation_backoff_s")

# the call sequences of the reference's tests/reliability/test_breaker.py
SCRIPTS = {
    "opens_only_at_max_consecutive_failures": (
        dict(max_failures=3),
        [("record_failure", 10.0)] * 3 + [("record_failure", 10.5)]),
    "success_resets_streak_and_closes_circuit": (
        dict(max_failures=2),
        [("record_failure", 0.0), ("record_success",),
         ("record_failure", 0.0), ("record_failure", 0.0),
         ("record_probe_failure", 1.0), ("record_success",)]),
    "probe_scheduling_and_backoff_cap": (
        dict(max_failures=1, probation_max_s=3.0),
        [("record_failure", 0.0), ("probe_due", 0.5), ("probe_due", 1.0),
         ("begin_probe",), ("probe_due", 1.0),
         ("record_probe_failure", 1.0), ("record_probe_failure", 3.0),
         ("record_probe_failure", 6.0)]),
    "release_probe_frees_the_slot_without_backoff": (
        dict(max_failures=1),
        [("record_failure", 0.0), ("begin_probe",), ("release_probe",),
         ("probe_due", 1.0)]),
    "probation_none_disables_probes": (
        dict(max_failures=1, probation_s=None),
        [("record_failure", 0.0), ("probe_due", 1e9), ("schedule_probe", 0.0),
         ("next_probe_in_s", 0.0), ("record_success",)]),
    "trip_opens_without_streak_and_counts_once": (
        {}, [("trip",), ("trip",), ("schedule_probe", 5.0)]),
    "next_probe_in_s_snapshot_surface": (
        dict(max_failures=1, probation_s=2.0),
        [("next_probe_in_s", 0.0), ("record_failure", 10.0),
         ("next_probe_in_s", 10.5), ("next_probe_in_s", 13.0)]),
    "identical_event_script_identical_transitions": (
        dict(max_failures=3, probation_max_s=30.0),
        [("record_failure", 0.0), ("record_failure", 0.1),
         ("record_failure", 0.2), ("record_probe_failure", 1.3),
         ("record_probe_failure", 3.5), ("record_success",),
         ("record_failure", 4.0)]),
}


def _trajectory(module, kw, script):
    kw = {"max_failures": 3, "probation_s": 1.0, "probation_max_s": 8.0, **kw}
    b = module.ProbationBreaker(**kw)
    out = []
    for verb, *args in script:
        ret = getattr(b, verb)(*args)
        out.append((verb, ret, tuple(getattr(b, k) for k in _STATE)))
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_breaker_sequences_match_the_reference(name):
    kw, script = SCRIPTS[name]
    got = _trajectory(tbreaker, kw, script)
    assert got == _trajectory(jbreaker, kw, script)
    # and the documented transitions hold (a few spot checks)
    if name == "identical_event_script_identical_transitions":
        assert got[2][2][1] is True and got[3][2][4] == 2.0
        assert got[5][1] is True and got[5][2][:2] == (0, False)
    if name == "trip_opens_without_streak_and_counts_once":
        assert [r for _, r, _ in got[:2]] == [True, False]


@pytest.mark.parametrize("kw,match", [
    (dict(max_failures=0), "max_failures"),
    (dict(probation_s=0.0), "probation_s"),
    (dict(probation_max_s=0.0), "probation_max_s"),
])
def test_breaker_validation_matches_the_reference(kw, match):
    for module in (tbreaker, jbreaker):
        with pytest.raises(ValueError, match=match):
            module.ProbationBreaker(**kw)


# -- the retry loop ------------------------------------------------------------

class _Flaky:
    def __init__(self, fail_times, exc):
        self.fail_times = fail_times
        self.exc = exc
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise self.exc
        return "ok"


class _Weird(BaseException):
    pass


OUTCOMES = ("retried", "recovered", "exhausted", "budget", "fatal")

# the cases of the reference's tests/reliability/test_retry.py
RETRY_CASES = {
    "recovers_after_transient_failures": (2, RuntimeError, dict(max_attempts=3)),
    "exhausted_raises_with_cause": (99, RuntimeError, dict(max_attempts=3)),
    "fatal_propagates_immediately": (
        99, TypeError, dict(max_attempts=5, fatal=(TypeError,))),
    "unclassified_exception_propagates_untouched": (
        99, _Weird, dict(max_attempts=5)),
    "backoff_is_full_jitter_and_capped": (
        99, RuntimeError, dict(max_attempts=6, base_delay_s=1.0, max_delay_s=3.0)),
    "budget_stops_retries": (99, RuntimeError, dict(max_attempts=10, tokens=1)),
    "success_on_first_attempt_records_nothing": (0, RuntimeError, {}),
}


def _counts(reg, site):
    fam = reg().get("sparkdl_retries_total")
    vals = fam.snapshot_values() if fam is not None else {}
    return [vals.get(f'site="{site}",outcome="{o}"', 0.0) for o in OUTCOMES]


def _drive(module, reg, name):
    fail_times, exc, kw = RETRY_CASES[name]
    kw = dict(kw)
    budget = module.RetryBudget(kw.pop("tokens", 1000))
    delays = []
    policy = module.RetryPolicy(
        **{"base_delay_s": 0.01, **kw}, sleep=delays.append, budget=budget,
        seed=0)
    fn = _Flaky(fail_times, exc("boom"))
    site = f"t_{name}"
    before = _counts(reg, site)
    try:
        outcome = ("ok", policy.call(fn, site=site))
    except BaseException as e:  # noqa: BLE001 - the outcome is compared
        cause = type(e.__cause__).__name__ if e.__cause__ else None
        outcome = (type(e).__name__, cause, "budget" in str(e))
    after = _counts(reg, site)
    return (outcome, fn.calls, delays, budget.remaining,
            [a - b for a, b in zip(after, before)])


@pytest.mark.parametrize("name", sorted(RETRY_CASES))
def test_retry_policy_matches_the_reference(name):
    got = _drive(tretry, tregistry, name)
    assert got == _drive(jretry, jregistry, name)
    outcome, calls, delays, _, added = got
    if name == "backoff_is_full_jitter_and_capped":
        assert len(delays) == 5
        for i, d in enumerate(delays, start=1):
            assert 0.0 <= d <= min(3.0, 2.0 ** (i - 1))
    if name == "recovers_after_transient_failures":
        assert outcome == ("ok", "ok") and calls == 3 and added[1] == 1
    if name == "budget_stops_retries":
        assert outcome == ("RetryExhaustedError", "RuntimeError", True)
        assert calls == 2 and added[3] == 1


def test_budget_reset_and_bad_config_match_the_reference():
    for module in (tretry, jretry):
        b = module.RetryBudget(2)
        assert b.try_acquire() and b.try_acquire() and not b.try_acquire()
        b.reset()
        assert b.remaining == 2
        b.reset(5)
        assert b.remaining == 5
        with pytest.raises(ValueError):
            module.RetryPolicy(max_attempts=0)
        with pytest.raises(ValueError):
            module.RetryBudget(-1)


def test_record_retry_lands_in_the_counter_and_the_flight_ring():
    before = _counts(tregistry, "t_manual")
    seq = tflight.flight_recorder().events_total
    tretry.record_retry("t_manual", "retried")
    assert _counts(tregistry, "t_manual")[0] == before[0] + 1
    evs = [e for e in tflight.flight_recorder().events()
           if e["kind"] == "retry" and e["seq"] > seq]
    assert evs and evs[-1]["site"] == "t_manual"
    assert evs[-1]["outcome"] == "retried"


def test_process_budget_reads_the_port_env_name(monkeypatch):
    monkeypatch.setenv("SPARKDL_TORCH_RETRY_BUDGET", "3")
    monkeypatch.setattr(tretry, "_PROCESS_BUDGET", None)
    assert tretry.process_retry_budget().remaining == 3
    # a policy without a budget of its own draws from it
    with pytest.raises(tretry.RetryExhaustedError,
                       match="SPARKDL_TORCH_RETRY_BUDGET"):
        tretry.RetryPolicy(max_attempts=10, sleep=lambda s: None,
                           seed=0).call(_Flaky(99, RuntimeError("x")),
                                        site="t_env")
    assert tretry.process_retry_budget().remaining == 0
