"""Autotuned streaming ingest (ROADMAP item 2; tf.data, arXiv 2101.12127).

:class:`Pipeline` — composable ``source -> map(fn, parallelism) ->
interleave(cycle) -> batch(bucketing) -> prefetch(depth) / to_device``
stage chain subsuming the hand-wired infeeds.

:class:`AutoTuner` / :class:`Knob` — the online control loop that closes
the observability spine back onto the knobs: starvation grows the
producer side, producer blocking shrinks it (and grows inverted
consumer-side knobs like the dispatch chain K), bounded power-of-two
steps with hysteresis so it never oscillates. Explicit settings pin.
"""

from sparkdl_torch.ingest.autotune import (
    AutoTuner,
    Knob,
    autotune_enabled,
    autotune_telemetry,
    default_tuner,
    read_feed_signals,
)
from sparkdl_torch.ingest.pipeline import Pipeline, resolve_pin, unique_name

__all__ = [
    "AutoTuner",
    "Knob",
    "Pipeline",
    "autotune_enabled",
    "autotune_telemetry",
    "default_tuner",
    "read_feed_signals",
    "resolve_pin",
    "unique_name",
]
