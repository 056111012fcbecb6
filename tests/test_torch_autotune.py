"""The port's AutoTuner (sparkdl_torch/ingest/autotune.py, a copy of the
JAX package's) on a deterministic fake clock + metrics feed, after the
JAX package's suite (tests/ingest/test_autotune.py): starved producer
grows depth/parallelism (and shrinks inverted knobs), consumer-bound
shrinks back, pinned knobs never move, hysteresis prevents flapping,
steps stay bounded in [lo, hi]. And side by side with the JAX package's
tuner: the same decisions on the same signals."""

from __future__ import annotations

import pytest

from sparkdl_torch.ingest import AutoTuner, Knob
from sparkdl_torch.observability.registry import registry
from sparkdl_tpu import ingest as jax_ingest


class FakeFeed:
    """Deterministic clock + cumulative (starve_s, blocked_s, items)
    feed: each tick advances the clock 1s and adds the next programmed
    deltas. items_delta=0 keeps the rate at zero, which disables the
    throughput-revert path (rate0 > 0 is required for a verdict)."""

    def __init__(self):
        self.now = 0.0
        self.starve = 0.0
        self.blocked = 0.0
        self.items = 0.0

    def clock(self) -> float:
        return self.now

    def signals(self) -> "tuple[float, float, float]":
        return self.starve, self.blocked, self.items

    def advance(self, starve_delta: float, blocked_delta: float,
                items_delta: float = 0.0) -> None:
        self.now += 1.0
        self.starve += starve_delta
        self.blocked += blocked_delta
        self.items += items_delta


class Value:
    def __init__(self, v: int):
        self.v = v

    def get(self) -> int:
        return self.v

    def set(self, v: int) -> None:
        self.v = v


def make_tuner(feed: FakeFeed, **kw) -> AutoTuner:
    kw.setdefault("hysteresis", 2)
    kw.setdefault("cooldown_ticks", 1)
    return AutoTuner(clock=feed.clock, signals=feed.signals, **kw)


def tick(tuner: AutoTuner, feed: FakeFeed, starve: float,
         blocked: float, items: float = 0.0) -> int:
    feed.advance(starve, blocked, items)
    return tuner.tick()


def test_starved_producer_grows_depth_and_parallelism():
    feed = FakeFeed()
    tuner = make_tuner(feed)
    depth = Value(2)
    par = Value(1)
    chain = Value(4)
    tuner.register(Knob("t1.depth", depth.get, depth.set, lo=1, hi=32))
    tuner.register(Knob("t1.par", par.get, par.set, lo=1, hi=8))
    tuner.register(Knob("t1.chain", chain.get, chain.set, lo=1, hi=8,
                        inverted=True))
    tuner.tick()  # first sample only establishes the baseline
    assert tick(tuner, feed, 0.5, 0.0) == 0  # streak 1 < hysteresis 2
    assert tick(tuner, feed, 0.5, 0.0) == 3  # streak 2: all three move
    assert depth.v == 4 and par.v == 2
    assert chain.v == 2  # inverted: shrinks when the producer is starved


def test_consumer_bound_shrinks_back_and_grows_inverted():
    feed = FakeFeed()
    tuner = make_tuner(feed, cooldown_ticks=0)
    depth = Value(8)
    chain = Value(1)
    tuner.register(Knob("t2.depth", depth.get, depth.set, lo=1, hi=32))
    tuner.register(Knob("t2.chain", chain.get, chain.set, lo=1, hi=8,
                        inverted=True))
    tuner.tick()
    tick(tuner, feed, 0.0, 0.5)
    tick(tuner, feed, 0.0, 0.5)
    assert depth.v == 4  # producer-side shrinks: consumer is the bottleneck
    assert chain.v == 2  # inverted grows: amortize the consumer's dispatches


def test_pinned_knobs_never_move():
    feed = FakeFeed()
    tuner = make_tuner(feed, cooldown_ticks=0)
    pinned = Value(3)
    free = Value(2)
    tuner.register(Knob("t3.pinned", pinned.get, pinned.set, lo=1, hi=32,
                        pinned=True, pin_source="prefetch="))
    tuner.register(Knob("t3.free", free.get, free.set, lo=1, hi=32))
    tuner.tick()
    for _ in range(6):
        tick(tuner, feed, 0.5, 0.0)
    assert pinned.v == 3, "pinned knob moved"
    assert free.v > 2


def test_hysteresis_prevents_flapping():
    feed = FakeFeed()
    tuner = make_tuner(feed, hysteresis=2)
    depth = Value(4)
    tuner.register(Knob("t4.depth", depth.get, depth.set, lo=1, hi=32))
    tuner.tick()
    # alternating starve/blocked: direction flips every sample, so the
    # streak never reaches the hysteresis bar and nothing ever moves
    for i in range(10):
        moved = tick(tuner, feed, 0.5 if i % 2 == 0 else 0.0,
                     0.0 if i % 2 == 0 else 0.5)
        assert moved == 0
    assert depth.v == 4
    assert tuner.decision_count == 0


def test_cooldown_after_a_move():
    feed = FakeFeed()
    tuner = make_tuner(feed, hysteresis=1, cooldown_ticks=2)
    depth = Value(2)
    tuner.register(Knob("t5.depth", depth.get, depth.set, lo=1, hi=32))
    tuner.tick()
    assert tick(tuner, feed, 0.9, 0.0) == 1  # hysteresis 1: move at once
    assert depth.v == 4
    # two cooldown samples are ignored even though the signal persists
    assert tick(tuner, feed, 0.9, 0.0) == 0
    assert tick(tuner, feed, 0.9, 0.0) == 0
    assert depth.v == 4
    assert tick(tuner, feed, 0.9, 0.0) == 1
    assert depth.v == 8


def test_steps_stay_bounded():
    feed = FakeFeed()
    tuner = make_tuner(feed, hysteresis=1, cooldown_ticks=0)
    depth = Value(16)
    chain = Value(2)
    tuner.register(Knob("t6.depth", depth.get, depth.set, lo=1, hi=32))
    tuner.register(Knob("t6.chain", chain.get, chain.set, lo=1, hi=8,
                        inverted=True))
    tuner.tick()
    for _ in range(8):
        tick(tuner, feed, 0.9, 0.0)
    assert depth.v == 32  # clamped at hi, never beyond
    assert chain.v == 1   # clamped at lo
    for _ in range(8):
        tick(tuner, feed, 0.0, 0.9)
    assert depth.v == 1
    assert chain.v == 8


def test_neutral_samples_reset_the_streak():
    feed = FakeFeed()
    tuner = make_tuner(feed, hysteresis=2)
    depth = Value(4)
    tuner.register(Knob("t7.depth", depth.get, depth.set, lo=1, hi=32))
    tuner.tick()
    assert tick(tuner, feed, 0.5, 0.0) == 0   # streak 1
    assert tick(tuner, feed, 0.0, 0.0) == 0   # neutral: streak resets
    assert tick(tuner, feed, 0.5, 0.0) == 0   # streak 1 again
    assert depth.v == 4


def test_decisions_and_values_land_in_the_registry():
    feed = FakeFeed()
    tuner = make_tuner(feed, hysteresis=1, cooldown_ticks=0)
    depth = Value(2)
    tuner.register(Knob("t8reg.depth", depth.get, depth.set, lo=1, hi=32))
    tuner.tick()
    tick(tuner, feed, 0.9, 0.0)
    gauge = registry().get("sparkdl_autotune_knob")
    assert gauge.labelled_values("knob")["t8reg.depth"] == 4.0
    dec = registry().get("sparkdl_autotune_decisions_total")
    vals = dec.snapshot_values()
    assert vals.get('knob="t8reg.depth",direction="grow"', 0) >= 1


def test_move_that_drops_throughput_is_reverted_and_tabooed():
    feed = FakeFeed()
    tuner = make_tuner(feed, hysteresis=1, cooldown_ticks=1, tabu_ticks=20)
    chain = Value(1)
    tuner.register(Knob("t10.chain", chain.get, chain.set, lo=1, hi=8,
                        inverted=True))
    tuner.tick()
    # consumer-bound at 100 items/s: the signal says grow the inverted
    # knob, so the tuner chains 1 -> 2 ...
    assert tick(tuner, feed, 0.0, 0.5, items=100) == 1
    assert chain.v == 2
    # ... but the move TANKS delivered throughput (100 -> 10/s):
    assert tick(tuner, feed, 0.0, 0.5, items=10) == 0  # cooldown
    assert tick(tuner, feed, 0.0, 0.5, items=10) == 1  # verdict: revert
    assert chain.v == 1, "throughput-negative move not undone"
    dec = registry().get("sparkdl_autotune_decisions_total")
    assert dec.snapshot_values().get(
        'knob="t10.chain",direction="revert"', 0) >= 1
    # the direction is tabu now: the persisting blocked signal must NOT
    # re-grow the chain every few samples (no grow/revert oscillation)
    for _ in range(10):
        tick(tuner, feed, 0.0, 0.5, items=100)
    assert chain.v == 1


def test_move_that_keeps_throughput_sticks():
    feed = FakeFeed()
    tuner = make_tuner(feed, hysteresis=1, cooldown_ticks=1)
    depth = Value(2)
    tuner.register(Knob("t11.depth", depth.get, depth.set, lo=1, hi=32))
    tuner.tick()
    assert tick(tuner, feed, 0.5, 0.0, items=100) == 1
    assert depth.v == 4
    tick(tuner, feed, 0.5, 0.0, items=100)  # cooldown
    # rate held: the verdict passes and the knob stays where it moved
    assert tick(tuner, feed, 0.5, 0.0, items=110) in (0, 1)
    assert depth.v >= 4


def test_clamped_noop_move_is_not_a_decision():
    feed = FakeFeed()
    tuner = make_tuner(feed, hysteresis=1, cooldown_ticks=0)

    class Clamped(Value):
        def set(self, v: int) -> None:
            self.v = min(int(v), 1)  # a policy ceiling holds it at 1

    knob = Clamped(1)
    tuner.register(Knob("t12.k", knob.get, knob.set, lo=1, hi=8))
    tuner.tick()
    for _ in range(4):
        assert tick(tuner, feed, 0.5, 0.0) == 0
    assert tuner.decision_count == 0
    assert knob.v == 1


def test_knob_bounds_validated():
    with pytest.raises(ValueError, match="lo <= hi"):
        Knob("bad", lambda: 1, lambda v: None, lo=4, hi=2)


def test_unregister_stops_tuning():
    feed = FakeFeed()
    tuner = make_tuner(feed, hysteresis=1, cooldown_ticks=0)
    depth = Value(2)
    tuner.register(Knob("t9.depth", depth.get, depth.set, lo=1, hi=32))
    tuner.unregister("t9.depth")
    tuner.tick()
    tick(tuner, feed, 0.9, 0.0)
    assert depth.v == 2


SIGNALS = {
    "starved": [(0.9, 0.0, 100)] * 8,
    "consumer_bound": [(0.0, 0.8, 100)] * 8,
    "flapping": [(0.9, 0.0, 100), (0.0, 0.9, 100)] * 5,
    "throughput_drop": [(0.0, 0.5, 100), (0.0, 0.5, 10), (0.0, 0.5, 10)]
    + [(0.0, 0.5, 100)] * 6,
    "mixed": [(0.5, 0.1, 50), (0.6, 0.0, 60), (0.0, 0.0, 60),
              (0.1, 0.7, 30), (0.0, 0.9, 20), (0.7, 0.0, 90)] * 2,
}


@pytest.mark.parametrize("name", sorted(SIGNALS))
@pytest.mark.parametrize("hysteresis,cooldown", [(1, 0), (2, 1)])
def test_same_decisions_as_the_jax_tuner(name, hysteresis, cooldown):
    """One signal trace through both tuners, each over the same three
    knobs (a depth, an inverted chain K, a pinned one): the same moves,
    tick by tick."""
    def run(tuner_cls, knob_cls):
        feed = FakeFeed()
        tuner = tuner_cls(clock=feed.clock, signals=feed.signals,
                          hysteresis=hysteresis, cooldown_ticks=cooldown)
        depth, chain, pinned = Value(2), Value(2), Value(3)
        tag = f"tvs_{name}_{hysteresis}_{tuner_cls.__module__.split('.')[0]}"
        tuner.register(knob_cls(f"{tag}.depth", depth.get, depth.set,
                                lo=1, hi=32))
        tuner.register(knob_cls(f"{tag}.chain", chain.get, chain.set,
                                lo=1, hi=8, inverted=True))
        tuner.register(knob_cls(f"{tag}.pinned", pinned.get, pinned.set,
                                lo=1, hi=8, pinned=True))
        tuner.tick()
        trace = []
        for s, b, i in SIGNALS[name]:
            n = tick(tuner, feed, s, b, i)
            trace.append((n, depth.v, chain.v, pinned.v))
        return trace, tuner.decision_count

    assert run(AutoTuner, Knob) == run(jax_ingest.AutoTuner, jax_ingest.Knob)
