"""Fused multi-step dispatch: K same-shape steps per device dispatch.

The counterpart of the reference's ``lax.scan`` chaining. PyTorch runs
eagerly, one host launch per op, so the port's unit of dispatch is a CUDA
graph: :class:`ScanChainer` captures ``step_fn`` applied to K static input
slots as one graph per (input shapes, K), on first use, and replays it —
one launch for K steps and every op in them. On the CPU it is a plain loop
over the same ``step_fn``. Outputs are bitwise those of the eager steps.

The graphs themselves are :class:`GraphCache`'s: an LRU of captured
graphs keyed on the inputs' shapes, the settings a call bakes in and the
storage of the state it updates, each captured after an eager warm-up on
a side stream and replayed afterwards. Every graphed path of the port
goes through it: the featurizer's chains (:class:`ScanChainer`),
``DeepTextGenerator``'s whole ``generate`` per bucket, the train steps of
``train/vision.py`` and the K-step training chain :func:`chain_carry`
under ``finetune_classifier``.

The rest:

* :func:`calibrate_dispatch_gap` — the measured per-dispatch overhead on
  the device: a trivial launch timed to its completion (anything it
  "takes" is launch cost, not compute);
* :class:`ChainPolicy` — picks K from the measured program time vs the
  calibrated gap so the overhead share stays under ``target_overhead``,
  degrading to K=1 for long programs (>~50 ms, where chaining buys
  nothing and only delays host visibility);
* :class:`ScanChainer` — maps ``step_fn`` over a stream, K same-shape
  inputs per dispatch.

Dispatches are timed with CUDA events recorded around them and read a
dispatch later, so timing never makes the host wait for the device.
Everything dispatched here lands in the observability spine:
``sparkdl_dispatches_total{path=...}``, the ``sparkdl_dispatch_chain_len``
histogram, the per-dispatch device-time histogram
``sparkdl_dispatch_seconds``, and a ``dispatch.chain`` span.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import math
import os
import threading
import time
from typing import Any, Callable, Iterable, Iterator

import torch

from sparkdl_torch.observability.registry import registry
from sparkdl_torch.observability.tracing import span
from sparkdl_torch.ops import _dispatch
from sparkdl_torch.reliability.faults import fault_point
from sparkdl_torch.runtime.tree import tree_leaves, tree_map

__all__ = [
    "CapturedGraph",
    "CarryChain",
    "ChainPolicy",
    "GraphCache",
    "ScanChainer",
    "SpecPolicy",
    "calibrate_dispatch_gap",
    "chain_carry",
    "default_chain_k",
    "dispatch_metrics",
    "graph_key",
    "optimizer_settings",
    "overhead_share",
    "record_dispatch",
    "require_capturable",
    "shape_key",
    "storage_key",
]

#: Chain-length histogram bounds: powers of two up to the largest K the
#: bench ever measured a win at (PERF.md: saturation by K=32..64).
CHAIN_LEN_BUCKETS: tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128)

_METRICS = None


def dispatch_metrics():
    """Lazy handles for the dispatch spine (one tuple per process):
    (dispatches counter by path, chain-length histogram, wall histogram).
    """
    global _METRICS
    if _METRICS is None:
        _METRICS = (
            registry().counter(
                "sparkdl_dispatches_total",
                "device dispatches issued (one graph replay or eager step = one)",
                labels=("path",)),
            registry().histogram(
                "sparkdl_dispatch_chain_len",
                "steps fused into each device dispatch",
                labels=("path",), buckets=CHAIN_LEN_BUCKETS),
            registry().histogram(
                "sparkdl_dispatch_seconds",
                "time of each device dispatch (all chained steps): CUDA "
                "events on the card, the host clock on the CPU",
                labels=("path",)),
        )
    return _METRICS


def record_dispatch(path: str, k: int, wall_s: "float | None" = None) -> None:
    """Record one device dispatch that fused ``k`` steps on ``path``."""
    dispatches, chain_len, wall = dispatch_metrics()
    dispatches.inc(path=path)
    chain_len.observe(k, path=path)
    if wall_s is not None:
        wall.observe(wall_s, path=path)


def dispatch_count(path: "str | None" = None) -> float:
    """Current value of the dispatch counter (summed over paths when
    ``path`` is None) — the benches' ``dispatch_count`` source."""
    fam = registry().get("sparkdl_dispatches_total")
    if fam is None:
        return 0.0
    values = fam.snapshot_values()
    if path is not None:
        return float(values.get(f'path="{path}"', 0.0))
    return float(sum(values.values()))


# -- dispatch-gap calibration -------------------------------------------------

_GAP_CACHE: "dict[str, float]" = {}


def _default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def calibrate_dispatch_gap(samples: int = 30, *, refresh: bool = False,
                           device: Any = None) -> float:
    """Median wall seconds of a trivial dispatch on ``device`` (default:
    the card where there is one, else the CPU).

    A one-element add has effectively zero compute, so its wall time to
    completion (launch + synchronize on the card) IS the per-dispatch
    overhead. Cached per device type; ``SPARKDL_TORCH_DISPATCH_GAP_MS``
    overrides (no measurement run), for environments where a calibration
    burst is unwelcome.
    """
    env = os.environ.get("SPARKDL_TORCH_DISPATCH_GAP_MS")
    if env:
        return float(env) / 1e3
    dev = torch.device(device) if device is not None else _default_device()
    if not refresh and dev.type in _GAP_CACHE:
        return _GAP_CACHE[dev.type]
    x = torch.zeros((), device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    x.add_(1.0)
    sync()  # first-use costs outside the timed region
    times = []
    for _ in range(max(3, samples)):
        t0 = time.perf_counter()
        x.add_(1.0)
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    gap = times[len(times) // 2]
    _GAP_CACHE[dev.type] = gap
    registry().gauge(
        "sparkdl_dispatch_gap_seconds",
        "calibrated per-dispatch overhead of this backend",
    ).set(gap)
    return gap


def overhead_share(n_dispatches: float, wall_s: float,
                   gap_s: "float | None" = None) -> "float | None":
    """Dispatch-overhead share of a measured wall interval:
    ``n * gap / wall`` — what fraction of the wall clock was launch/relay
    cost rather than device program. The number the benches emit so the
    trajectory captures amortization, not just img/s."""
    if wall_s <= 0 or n_dispatches <= 0:
        return None
    if gap_s is None:
        gap_s = calibrate_dispatch_gap()
    return min(1.0, n_dispatches * gap_s / wall_s)


# -- chain-length policy ------------------------------------------------------


@dataclasses.dataclass
class ChainPolicy:
    """Pick K so the dispatch-gap share of wall time stays under target.

    Overhead share of a K-chain is ``gap / (gap + K * program)``; solving
    for share <= ``target_overhead`` gives
    ``K >= gap * (1 - t) / (t * program)``. K is rounded UP to a power of
    two (bounded jit-cache churn: at most log2(max_chain) compiles per
    program) and clamped to ``[1, max_chain]``. Programs longer than
    ``max_program_s`` (~50 ms) get K=1 — the gap is already <5% there,
    and chaining only delays host visibility (metrics, checkpoints,
    retirements).

    ``record(wall_s, k)`` feeds the measured per-step program time back
    (EMA); until the first record, :meth:`chain_len` returns 1 so the
    first dispatch doubles as the measurement probe.
    """

    target_overhead: float = 0.02
    max_chain: int = 32
    max_program_s: float = 0.050
    gap_s: "float | None" = None  # None: calibrate lazily on first use
    ema: float = 0.5
    program_s: "float | None" = dataclasses.field(default=None)

    def gap(self) -> float:
        if self.gap_s is None:
            self.gap_s = calibrate_dispatch_gap()
        return self.gap_s

    def record(self, wall_s: float, k: int) -> None:
        """Fold one measured dispatch (k fused steps, wall seconds).

        Deliberately does NOT trigger gap calibration: record() sits on
        every hot path even when the chain length is pinned (where the
        policy is only a program-time estimator, e.g. the decode
        deadline bound), and the 30-probe calibration burst must never
        ride a production dispatch. Until the gap is known the estimate
        includes it — a slight overestimate, which only makes
        chain_len()/deadline bounds more conservative.
        """
        gap = self.gap_s if self.gap_s is not None else 0.0
        prog = max((wall_s - gap) / max(k, 1), 1e-9)
        if self.program_s is None:
            self.program_s = prog
        else:
            self.program_s += self.ema * (prog - self.program_s)

    def chain_len(self) -> int:
        if self.program_s is None:
            return 1  # first dispatch measures
        if self.program_s >= self.max_program_s:
            return 1  # long program: overhead share already < target-ish
        t = self.target_overhead
        k = self.gap() * (1.0 - t) / (t * self.program_s)
        if k <= 1.0:
            return 1
        # the 1e-9 guard keeps float fuzz from bumping an exact power of
        # two (ideal K = 4.0000000001) to the next one
        return min(self.max_chain, 1 << math.ceil(math.log2(k) - 1e-9))


@dataclasses.dataclass
class SpecPolicy:
    """Pick the speculative verify width from measured acceptance.

    :class:`ChainPolicy` chains k IDENTICAL steps, so its only question
    is dispatch-gap amortization. A speculative verify chains k
    *conditional* steps: position j only produces a real token if every
    draft before it was accepted, so the useful width depends on the
    measured per-position acceptance rate ``p``. Expected real tokens
    from a width-k verify are ``E(k) = (1-p^k)/(1-p)`` (a geometric
    series — each extra position converts with one more factor of p).

    ``spec_len`` returns the largest power-of-two ``k <= max_k`` whose
    expected utilization stays above ``util`` (``E(k) >= util * k``):
    below that, the marginal verify positions are mostly wasted FLOPs.
    Acceptance below ``min_rate`` returns 1 — drafting is not paying
    for itself and the engine serves plain (chained) decode instead.

    The estimator is a pair of geometrically-decayed counts
    (proposed/accepted per dispatch), seeded with an OPTIMISTIC prior:
    cold engines open at full width (the first verifies double as
    measurement probes — repetitive/shared-prefix workloads, the ones
    speculation exists for, get their speedup immediately), and one
    unlucky one-draft dispatch cannot poison the estimate the way a
    plain EMA of per-dispatch ratios would. Stood-down is NOT
    terminal: every ``probe_every``-th consultation while below
    ``min_rate`` returns a width-2 probation probe — the same
    reintegration discipline as quarantined replicas — so a workload
    that turns acceptance-friendly again is re-detected without any
    operator action.
    """

    max_k: int = 8
    util: float = 0.5
    min_rate: float = 0.2
    decay: float = 0.2
    prior: float = 8.0
    probe_every: int = 16

    def __post_init__(self) -> None:
        self._proposed = self.prior
        self._accepted = self.prior
        self._stood_down = 0

    @property
    def rate(self) -> float:
        """Decayed-count acceptance estimate (optimistic at cold)."""
        return self._accepted / self._proposed

    def record(self, proposed: int, accepted: int) -> None:
        if proposed < 1:
            return
        self._proposed = (1 - self.decay) * self._proposed + proposed
        self._accepted = (1 - self.decay) * self._accepted + accepted

    def expected_tokens(self, k: int) -> float:
        """E(k) under the current acceptance estimate."""
        p = min(max(self.rate, 0.0), 0.999999)
        return (1.0 - p ** k) / (1.0 - p)

    def spec_len(self) -> int:
        if self.max_k < 2:
            return 1
        if self.rate < self.min_rate:
            self._stood_down += 1
            if self._stood_down % self.probe_every == 0:
                return 2  # probation probe: re-measure acceptance
            return 1
        self._stood_down = 0
        k = 2
        while (2 * k <= self.max_k
               and self.expected_tokens(2 * k) >= self.util * 2 * k):
            k *= 2
        return k


def default_chain_k() -> "int | None":
    """Process-wide chain_k override: ``SPARKDL_TORCH_CHAIN_K`` (int), or
    None meaning auto (ChainPolicy decides from measurements). A value
    below 1 is a misconfiguration and raises — same contract as the
    constructor argument (``1`` is how chaining is disabled)."""
    env = os.environ.get("SPARKDL_TORCH_CHAIN_K")
    if not env:
        return None
    k = int(env)
    if k < 1:
        raise ValueError(
            f"SPARKDL_TORCH_CHAIN_K must be >= 1, got {env!r} "
            "(set 1 to disable chaining)"
        )
    return k


# -- the chainer --------------------------------------------------------------


def shape_key(tree: Any) -> Any:
    """Hashable (structure, shapes, dtypes) key for a batch tree: only
    inputs with equal keys may join one chain (one graph serves them).
    The single grouping predicate of ``ScanChainer.map_stream``."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, shape_key(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(shape_key(v) for v in tree))
    return (tuple(getattr(tree, "shape", ())),
            str(getattr(tree, "dtype", type(tree))))


def _on_cuda(tree: Any) -> bool:
    return any(isinstance(l, torch.Tensor) and l.device.type == "cuda"
               for l in tree_leaves(tree))


def _clone(leaf: Any) -> Any:
    return leaf.clone() if isinstance(leaf, torch.Tensor) else leaf


def _record_stream(tree: Any, stream) -> None:
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            leaf.record_stream(stream)


# -- CUDA graphs: the port's counterpart of jit ---------------------------------


def storage_key(*modules: torch.nn.Module) -> "tuple[int, ...]":
    """The device addresses of every parameter and buffer of ``modules``.

    A captured graph reads and writes those addresses, not the tensors
    that later sit in the module: weights copied in place
    (``load_state_dict``) keep the key and are seen by the next replay;
    replaced parameters change it, so a graph cache keyed on it captures
    anew instead of replaying against memory the module no longer uses."""
    return tuple(t.data_ptr() for m in modules
                 for t in (*m.parameters(), *m.buffers()))


def optimizer_settings(optimizer: torch.optim.Optimizer) -> tuple:
    """Each parameter group's hyperparameters (lr, betas, momentum, ...):
    a captured ``optimizer.step()`` bakes in every Python number, so a
    changed one needs a new capture."""
    return tuple(
        tuple((k, v if isinstance(v, (int, float, bool, str, tuple, type(None)))
               else id(v)) for k, v in sorted(g.items()) if k != "params")
        for g in optimizer.param_groups)


def require_capturable(optimizer: torch.optim.Optimizer, path: str) -> None:
    """Raise where ``optimizer`` cannot run inside a CUDA graph: an
    optimizer with a ``capturable`` setting left False (Adam, AdamW, ...)
    keeps its step count on the host, which a graph would bake in."""
    if any(g.get("capturable") is False for g in optimizer.param_groups):
        raise ValueError(
            f"{path!r} runs its steps as CUDA graphs on the card, and "
            f"{type(optimizer).__name__} with capturable=False cannot be "
            "captured (its step count lives on the host); construct it "
            "with capturable=True")


_NO_GC_LOCK = threading.Lock()
_NO_GC = {"depth": 0, "was_enabled": False}


@contextlib.contextmanager
def no_gc():
    """Python's cyclic garbage collector off inside the block. A
    collection during a CUDA-graph capture can finalize a dropped runner
    (its staging ring, pinned buffers, events), whose CUDA calls
    invalidate the capture; PyTorch's ``torch.cuda.graph`` no longer
    collects before a capture, so such garbage may still be waiting.

    The collector is process-wide and captures may overlap across threads
    (HPO trials in threads), so the blocks share one depth count: the
    first to enter turns the collector off, the last to leave restores
    the state the first found."""
    with _NO_GC_LOCK:
        if _NO_GC["depth"] == 0:
            _NO_GC["was_enabled"] = gc.isenabled()
            gc.disable()
        _NO_GC["depth"] += 1
    try:
        yield
    finally:
        with _NO_GC_LOCK:
            _NO_GC["depth"] -= 1
            if _NO_GC["depth"] == 0 and _NO_GC["was_enabled"]:
                gc.enable()


#: One graph-cache miss (eager warm-up, then capture) at a time in the
#: process: a capture must not meet another thread's device-wide
#: synchronize or cache release (runners of a ReplicaPool that share a
#: card, HPO trials in threads). Reentrant: a warm-up may miss a cache too.
_CAPTURE_LOCK = threading.RLock()

#: The priority of the warm-up and capture streams. PyTorch hands out
#: streams round-robin from a pool of 32 per priority, and the feed's puts
#: take a new priority-0 stream per batch, so a capture stream from that
#: pool is, sooner or later, another thread's copy stream: its copies and
#: events would land in the graph. No other stream of the port has this
#: priority.
_CAPTURE_STREAM_PRIORITY = -1


class CapturedGraph:
    """``fn(*inputs)`` captured as one CUDA graph over static copies of
    ``inputs``, and the kernel launches one replay makes (what the
    wrappers launched into the capturing stream during the capture, where
    nothing ran: :func:`~sparkdl_torch.ops._dispatch.capture_tally`).

    ``generator``: a ``torch.Generator`` the call draws from. The graph
    gets one of its own, registered with it; a replay starts from the
    caller's generator state and hands the advanced state back, so it
    draws the numbers an eager call would. ``capture_s`` and
    ``pool_bytes`` (device memory reserved during the capture: the
    graph's private pool) say what the capture cost."""

    __slots__ = ("inputs", "graph", "outputs", "launches", "generator",
                 "capture_s", "pool_bytes")

    def __init__(self, fn: Callable, inputs: tuple, *, stream,
                 generator: "torch.Generator | None" = None):
        self.inputs = tree_map(torch.Tensor.clone, inputs)
        self.graph = torch.cuda.CUDAGraph()
        self.generator = None
        kwargs = {}
        if generator is not None:
            self.generator = torch.Generator(device=generator.device)
            self.graph.register_generator_state(self.generator)
            kwargs["generator"] = self.generator
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # as the capture does: the pool is what grows
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        # thread_local: feed threads and other replicas may keep copying
        # and launching while this thread captures; no collection may
        # finalize garbage mid-capture (no_gc); what the wrappers launch
        # here is only captured (capture_tally)
        with no_gc(), _dispatch.capture_tally() as self.launches, \
                torch.cuda.graph(self.graph, stream=stream,
                                 capture_error_mode="thread_local"):
            self.outputs = fn(*self.inputs, **kwargs)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved() - reserved

    def replay(self, inputs: tuple,
               generator: "torch.Generator | None" = None) -> Any:
        for s, v in zip(tree_leaves(self.inputs), tree_leaves(inputs)):
            s.copy_(v)
        if self.generator is not None:
            self.generator.set_state(generator.get_state())
        self.graph.replay()
        if self.generator is not None:
            generator.set_state(self.generator.get_state())
        _dispatch.add_launches(self.launches)
        # fresh outputs: the next replay overwrites the static ones
        return tree_map(_clone, self.outputs)


class GraphCache:
    """An LRU of :class:`CapturedGraph` for one path: ``cache(fn, inputs,
    key)`` runs ``fn(*inputs)`` on the card as a graph replay.

    The entry is chosen by the inputs' shapes and dtypes
    (:func:`shape_key`) and ``key``: the settings the call bakes in and
    the storage identity of the state it reads and writes
    (:func:`storage_key`, :func:`optimizer_settings`). On a miss the call
    runs eagerly on a side stream (the warm-up: kernel libraries load,
    lazy state such as optimizer moments is created, and its outputs are
    this call's), then the same call is captured on that stream, and the
    least recently used graph beyond ``maxsize`` is dropped. Misses take
    turns across the process's threads, and the side stream comes from a
    priority pool no feed copy draws from. A capture that fails raises,
    naming the path: nothing falls back to eager execution. ``fn`` must not read the device from the host; every leaf
    of ``inputs`` must be a tensor (another value would be baked in)."""

    def __init__(self, path: str, *, maxsize: int = 8):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.path = path
        self.maxsize = maxsize
        self._graphs: "collections.OrderedDict[Any, CapturedGraph]" = (
            collections.OrderedDict())
        self._stream = None  # warm-up and capture stream, made at first use
        #: graphs captured so far (evicted ones included)
        self.captures = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self) -> "list[Any]":
        """(shape key, key) of every cached graph, least recent first."""
        return list(self._graphs)

    def graphs(self) -> "list[CapturedGraph]":
        return list(self._graphs.values())

    def clear(self) -> None:
        """Drop every graph (and, once its outputs are gone, its pool)."""
        self._graphs.clear()

    def __call__(self, fn: Callable, inputs: tuple, key: Any = (), *,
                 generator: "torch.Generator | None" = None) -> Any:
        if not all(isinstance(l, torch.Tensor) for l in tree_leaves(inputs)):
            raise ValueError(
                f"{self.path!r}: a CUDA graph takes tensor inputs only")
        full = (shape_key(inputs), key)
        g = self._graphs.get(full)
        if g is not None:
            self._graphs.move_to_end(full)
            return g.replay(inputs, generator)
        with _CAPTURE_LOCK:
            out = self._warm_up(fn, inputs, generator)
            try:
                g = self._capture(fn, inputs, generator)
            except Exception as e:
                raise RuntimeError(
                    f"capturing a CUDA graph of {self.path!r} failed "
                    f"({type(e).__name__}: {e})") from e
        self.captures += 1
        self._graphs[full] = g
        while len(self._graphs) > self.maxsize:
            self._graphs.popitem(last=False)
        return out

    def _warm_up(self, fn, inputs, generator):
        kwargs = {} if generator is None else {"generator": generator}
        cur = torch.cuda.current_stream()
        if self._stream is None:
            self._stream = torch.cuda.Stream(
                priority=_CAPTURE_STREAM_PRIORITY)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = fn(*inputs, **kwargs)
        cur.wait_stream(self._stream)
        _record_stream(inputs, self._stream)
        _record_stream(out, cur)
        return out

    def _capture(self, fn, inputs, generator) -> CapturedGraph:
        return CapturedGraph(fn, inputs, stream=self._stream,
                             generator=generator)


class ScanChainer:
    """Fuse K same-shape ``step_fn`` applications into one device dispatch.

    ``step_fn(x) -> y`` is any map over a tree of tensors (no carried
    state). On CUDA inputs a dispatch of K steps replays one CUDA graph of
    ``step_fn`` over K static input slots: the inputs are copied into the
    slots, the graph is replayed, and its outputs are copied out, all on
    the current stream. The graph for an (input shapes, K) is captured on
    its first use, after an eager run of the same K steps on a side stream
    (the warm-up capture needs, whose outputs are the dispatch's own), so
    only the shapes that occur get a graph and its memory. Replayed
    outputs are bitwise those of eager steps (the same kernels on the same
    inputs); the wrappers' launch counts grow by what one replay launches.
    On CPU inputs a dispatch is a plain loop over ``step_fn``.

    ``chain_k``: None = auto (``SPARKDL_TORCH_CHAIN_K`` env if set, else
    the :class:`ChainPolicy` picks from measured program time vs the
    calibrated dispatch gap); N pins the chain length. ``chain_k=1``
    pinned (argument or env) disables chaining and graphs alike: every
    step runs eagerly, the parity reference and the way out for a
    ``step_fn`` that cannot be captured (one that waits for the device).
    Ragged tails (fewer than K same-shape items buffered when the stream
    ends or the shape changes) run unchained — one-step dispatches reuse
    the K=1 graph instead of capturing a one-off tail length.
    """

    def __init__(self, step_fn: Callable[[Any], Any], *, path: str,
                 chain_k: "int | None" = None,
                 policy: "ChainPolicy | None" = None,
                 device: Any = None):
        if chain_k is not None and chain_k < 1:
            raise ValueError(f"chain_k must be >= 1, got {chain_k}")
        self.step_fn = step_fn
        self.path = path
        env_k = default_chain_k()
        if chain_k is not None and env_k is not None and env_k != chain_k:
            # two explicit pins that disagree is a misconfiguration the
            # autotuner must never paper over: fail loud
            raise ValueError(
                f"conflicting chain-K pins: explicit chain_k={chain_k} "
                f"vs SPARKDL_TORCH_CHAIN_K={env_k} — pin it one way, not "
                "both"
            )
        self.chain_k = chain_k if chain_k is not None else env_k
        #: True when the chain length was explicitly configured (arg or
        #: env): the autotuner registers a pinned knob and never moves it
        self.pinned = self.chain_k is not None
        self.pin_source = (
            "chain_k" if chain_k is not None
            else "SPARKDL_TORCH_CHAIN_K" if env_k is not None else None
        )
        #: False when chain_k=1 is pinned: every step runs eagerly
        self.graphs = not (self.pinned and self.chain_k == 1)
        self.policy = policy if policy is not None else ChainPolicy()
        if self.chain_k is None and self.policy.gap_s is None:
            # auto mode consults policy.chain_len() per dispatch: pay the
            # 30-probe gap calibration ONCE here at construction, never
            # mid-stream on a production dispatch
            self.policy.gap_s = calibrate_dispatch_gap(device=device)
        self._graphs = GraphCache(path, maxsize=16)
        self._timing: "list[tuple[Any, Any, int]]" = []  # (start, end, k)

    @property
    def graph_keys(self) -> "list[tuple[Any, int]]":
        """(input shape key, K) of every graph cached."""
        return [key for _, key in self._graphs.keys()]

    # -- running steps -------------------------------------------------------
    def run(self, xs: "list[Any]") -> "list[Any]":
        """``step_fn`` over ``xs`` (same shapes) as one dispatch, without
        metrics: a graph replay on CUDA (captured here on first use), else
        a plain loop."""
        if not (self.graphs and _on_cuda(xs[0])):
            return [self.step_fn(x) for x in xs]
        return self._graphs(self._steps, tuple(xs),
                            (shape_key(xs[0]), len(xs)))

    def _steps(self, *xs: Any) -> "list[Any]":
        return [self.step_fn(x) for x in xs]

    # -- dispatching ---------------------------------------------------------
    def target_chain_len(self) -> int:
        """The chain length the next group aims for."""
        if self.chain_k is not None:
            return self.chain_k
        return self.policy.chain_len()

    def _dispatch(self, xs: "list[Any]") -> "list[Any]":
        k = len(xs)
        fault_point("dispatch")
        self._harvest()
        dispatches, chain_len, _ = dispatch_metrics()
        with span("dispatch.chain", path=self.path, k=k):
            if _on_cuda(xs[0]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                ys = self.run(xs)
                end.record()
                self._timing.append((start, end, k))
            else:
                t0 = time.perf_counter()
                ys = self.run(xs)
                self._observe(time.perf_counter() - t0, k)
        dispatches.inc(path=self.path)
        chain_len.observe(k, path=self.path)
        return ys

    def _observe(self, seconds: float, k: int) -> None:
        dispatch_metrics()[2].observe(seconds, path=self.path)
        self.policy.record(seconds, k)

    def _harvest(self) -> None:
        """Fold in the device times of earlier dispatches that are done
        (their events are read a dispatch later: the host never waits)."""
        while self._timing and self._timing[0][1].query():
            start, end, k = self._timing.pop(0)
            self._observe(start.elapsed_time(end) / 1e3, k)

    def dispatch_single(self, x: Any) -> Any:
        """One unchained dispatch (counts toward the spine like any
        other): the probe/tail/K=1 path of :meth:`map_stream`."""
        return self._dispatch([x])[0]

    def dispatch_chain(self, xs: "list[Any]") -> "list[Any]":
        """Fuse ``len(xs)`` same-shape steps into one dispatch; returns
        per-step outputs in order."""
        return self._dispatch(list(xs))

    def map_stream(self, it: Iterable[Any]) -> Iterator[Any]:
        """Map ``step_fn`` over a stream of device-resident inputs,
        fusing runs of same-shape items into chained dispatches; yields
        one output per input, in order.

        Buffering never reorders: a shape change (ragged tail bucket)
        flushes the pending group first. Pending items held for a chain
        are bounded by the target K, so memory stays O(K batches).
        """
        pending: "list[Any]" = []
        pending_key = None
        for x in it:
            key = shape_key(x)
            if pending and key != pending_key:
                yield from self._flush(pending)
                pending = []
            pending.append(x)
            pending_key = key
            k = self.target_chain_len()
            if len(pending) >= k:
                if k > 1:
                    yield from self.dispatch_chain(pending)
                else:
                    yield from self._flush(pending)
                pending = []
        if pending:
            yield from self._flush(pending)

    def _flush(self, pending: "list[Any]") -> Iterator[Any]:
        """Tail/ragged flush: run unchained (no one-off-K capture)."""
        for x in pending:
            yield self.dispatch_single(x)


def graph_key(step_fn: Callable) -> Any:
    """What a step's graphs depend on besides its inputs' shapes:
    ``step_fn.graph_key()`` where the step defines it (the train steps of
    ``train/``: optimizer settings and the model's storage), else ()."""
    key = getattr(step_fn, "graph_key", None)
    return () if key is None else key()


class CarryChain:
    """``chained(batches) -> [step_fn(b) for b in batches]``, K carried-
    state steps as one dispatch: one CUDA graph per (K, batch shapes,
    :func:`graph_key`) on the card, captured at first use after the same
    K steps ran eagerly (they are that call's steps), then replayed; a
    plain loop on the CPU. ``step_fn(batch) -> metrics`` updates its
    model and optimizer in place, so a replay carries the state from step
    to step through the same memory, as the reference's scan carries it
    through its loop. Metrics come back per step, in order, bitwise those
    of the eager steps."""

    def __init__(self, step_fn: Callable[[Any], Any], *, path: str = "train"):
        self.step_fn = step_fn
        self.graphs = GraphCache(path)

    def __call__(self, batches: "Iterable[Any]") -> "list[Any]":
        batches = tuple(batches)
        if not batches:
            return []
        if not _on_cuda(batches[0]):
            return [self.step_fn(b) for b in batches]
        return self.graphs(self._steps, batches, graph_key(self.step_fn))

    def _steps(self, *batches: Any) -> "list[Any]":
        return [self.step_fn(b) for b in batches]


def chain_carry(step_fn: Callable[[Any], Any], *,
                donate: bool = True) -> CarryChain:
    """The carried-state (training) chain of the reference, in the port's
    idiom: ``chained(batches) -> [metrics]`` runs ``step_fn(batch) ->
    metrics`` (which updates its model and optimizer in place) over the K
    batches as one dispatch — a CUDA graph per (K, batch shapes) on the
    card, a plain loop on the CPU (:class:`CarryChain`). ``donate`` has no
    counterpart: the state is updated in place, never copied, so there is
    nothing to donate; it is accepted for the reference's signature."""
    del donate
    return CarryChain(step_fn)
