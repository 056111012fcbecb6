"""The port's ContinuousGPTEngine against the JAX package's, on the same
tiny GPT weights and requests, both on the CPU and driven by ``tick()``:
greedy tokens identical under every layout and decode mode, the same
prefix-hit and deferral counts; plus what the port adds to the
reference's programs: the scratch block at the sentinel id and the graph
path's static inputs (``sp`` > 1 is tests/test_torch_sp_engine.py).
"""

import threading

import numpy as np
import pytest
import torch
from torch_parity import gpt_pair

from sparkdl_torch.runtime.dispatch import GraphCache
from sparkdl_torch.serving import ContinuousGPTEngine as TorchEngine
from sparkdl_tpu.serving import ContinuousGPTEngine as JaxEngine

torch.set_num_threads(2)

MAX_LEN = 48
SHARED = [5, 3, 9, 2, 7, 11, 4, 8]
CASES = [
    (SHARED + [1, 6], 6),
    (SHARED + [2, 2, 9], 5),   # a prefix hit on the first
    ([6, 8, 6], 4),            # no shared prefix
    (SHARED + [1, 6], 3),      # the whole prompt but its last token
    (list(range(1, 14)), 7),   # a multi-chunk prompt
    (SHARED[:6], 5),           # shares a partial block: copy on write
]


@pytest.fixture(scope="module")
def pair():
    jm, variables, tm = gpt_pair(0)
    return jm.config, variables, tm.config, tm


def _engine(kind, pair, **kw):
    jcfg, variables, tcfg, module = pair
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("auto_start", False)
    if kind == "jax":
        return JaxEngine(jcfg, variables, **kw)
    return TorchEngine(tcfg, module, **kw)


def _run(kind, pair, cases=CASES, **kw):
    eng = _engine(kind, pair, **kw)
    futs = [eng.submit(p, n) for p, n in cases]
    while not all(f.done() for f in futs):
        eng.tick()
    snap = eng.snapshot()
    eng.close()
    return [f.result(timeout=0).tolist() for f in futs], snap


MODES = {
    "dense": dict(kv_layout="dense"),
    "dense_chain4": dict(kv_layout="dense", chain_tokens=4),
    "paged": dict(kv_block_size=4, prefill_chunk=4),
    "paged_one_chunk": dict(),
    "chain4": dict(kv_block_size=4, chain_tokens=4),
    "spec4": dict(kv_block_size=4, spec_k=4),
    "bf16": dict(kv_block_size=4, kv_dtype="bf16"),
    "int8": dict(kv_block_size=4, prefill_chunk=4, kv_dtype="int8"),
    "int8_spec4": dict(kv_block_size=4, kv_dtype="int8", spec_k=4),
    "deferral": dict(kv_block_size=4, kv_blocks=9, n_slots=3),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tokens_and_counts_equal_the_jax_engine(pair, mode):
    want, jsnap = _run("jax", pair, **MODES[mode])
    got, tsnap = _run("torch", pair, **MODES[mode])
    assert got == want
    if jsnap["kv"] is not None:
        for key in ("prefix_hits", "prefix_misses", "deferrals_total",
                    "prefill_chunks", "blocks_used_peak"):
            assert tsnap["kv"][key] == jsnap["kv"][key], key
    if mode == "deferral":
        assert tsnap["kv"]["deferrals_total"] > 0
    if mode.endswith("spec4"):
        for key in ("proposed", "accepted", "dispatches", "tokens"):
            assert tsnap["spec"][key] == jsnap["spec"][key], key


def test_paged_hits_and_copy_on_write_engage(pair):
    got, snap = _run("torch", pair, **MODES["paged"])
    assert snap["kv"]["prefix_hits"] > 0
    # the copy-on-write request reuses a partial block of another's
    # prompt: its prefill is shorter than its prompt
    assert snap["kv"]["prefix_misses"] < sum(len(p) for p, _ in CASES)


def _first_new_index(stream, at_least):
    for j in range(at_least, len(stream)):
        if stream[j] not in stream[:j]:
            return j
    pytest.fail(f"no token of {stream} occurs first at index >= {at_least}")


@pytest.fixture(scope="module")
def eos_case(pair):
    """A prompt, its 12-token greedy stream from the JAX ``generate``, and
    a stop token whose FIRST occurrence in that stream is mid-stream."""
    import jax.numpy as jnp

    from sparkdl_tpu.models.gpt import GPTLMHeadModel, generate

    jcfg, variables, _, _ = pair
    prompt = [6, 8, 6]
    oracle = np.asarray(generate(GPTLMHeadModel(jcfg), variables,
                                 jnp.asarray([prompt], jnp.int32), 12))
    oracle = oracle[0, len(prompt):].tolist()
    j = _first_new_index(oracle, 2)
    return prompt, oracle, j


@pytest.mark.parametrize("mode", ["dense", "paged", "chain4", "spec4"])
def test_eos_stops_at_the_first_occurrence_and_frees_the_slot(pair, eos_case,
                                                              mode):
    """The engine stops exactly at the stop token's first occurrence, as
    the JAX engine does, and the freed slot serves the next request."""
    prompt, oracle, j = eos_case
    kw = {k: v for k, v in MODES[mode].items() if k != "n_slots"}
    cases = [(prompt, len(oracle)), (SHARED, 4)]
    want, _ = _run("jax", pair, cases, eos_id=oracle[j], n_slots=1, **kw)
    got, snap = _run("torch", pair, cases, eos_id=oracle[j], n_slots=1, **kw)
    assert got[0] == oracle[:j + 1] == want[0]
    assert got == want and snap["completed"] == 2


class _StaticGraph:
    """A stand-in for a captured CUDA graph: the inputs live in static
    buffers, a replay copies the call's inputs into them and runs the
    captured function on the buffers, and the outputs come back cloned."""

    capture_s = 0.0
    pool_bytes = 0

    def __init__(self, fn, inputs):
        self.fn = fn
        self.inputs = tuple(t.clone() for t in inputs)
        self.replays = 0

    def replay(self, inputs, generator=None):
        for s, v in zip(self.inputs, inputs):
            s.copy_(v)
        self.replays += 1
        out = self.fn(*self.inputs)
        return tuple(o.clone() for o in out) if isinstance(out, tuple) else out.clone()


class _StaticGraphCache(GraphCache):
    def _warm_up(self, fn, inputs, generator):
        return fn(*inputs)

    def _capture(self, fn, inputs, generator):
        return _StaticGraph(fn, inputs)


@pytest.mark.parametrize("mode", ["dense", "paged", "chain4", "spec4", "int8"])
def test_graph_path_feeds_every_tick_through_static_inputs(pair, mode):
    """The card's path on the CPU: each program is taken from a graph
    cache keyed on its static arguments, and a replay sees this tick's
    tables, depths and tokens only through its input buffers. Tokens
    equal the eager engine's."""
    want, _ = _run("torch", pair, **MODES[mode])
    eng = _engine("torch", pair, **MODES[mode])
    eng.graphs = _StaticGraphCache("t_continuous", maxsize=96)
    eng._graphed = True
    futs = [eng.submit(p, n) for p, n in CASES]
    while not all(f.done() for f in futs):
        eng.tick()
    snap = eng.snapshot()
    names = {key[1][0] for key in eng.graphs.keys()}
    replays = sum(g.replays for g in eng.graphs.graphs())
    assert snap["graphs"]["captured"] == len(eng.graphs) and replays > 0
    eng.close()
    assert len(eng.graphs) == 0  # closing frees the graphs
    assert [f.result().tolist() for f in futs] == want
    if mode == "dense":
        assert names == {"prefill", "step_chain"}
    else:
        assert "paged_step" in names and names & {"chunk_one", "chunk_final"}
    if mode == "spec4":
        assert "paged_verify" in names


def test_sentinel_writes_land_in_the_scratch_block_only(pair):
    """Idle slots decode over the sentinel table entries: their writes go
    to the scratch block past the real ones, never into a real block."""
    eng = _engine("torch", pair, kv_block_size=4, n_slots=3)
    sentinel = eng._pool.sentinel
    assert eng._pool_kv["k"].shape[1] == sentinel + 1
    before = {n: t.clone() for n, t in eng._pool_kv.items()}  # zeros
    fut = eng.submit(SHARED + [1, 6], 6)
    eng.tick()  # admit + prefill + first decode
    owned = set(eng._inflight[0].blocks)
    while not fut.done():
        eng.tick()
    for name, t in eng._pool_kv.items():
        for b in range(sentinel):
            if b not in owned:
                assert torch.equal(t[:, b], before[name][:, b]), (name, b)
        assert t[:, sentinel].any()  # the idle slots wrote there
    eng.close()
    # a direct sentinel write: the real blocks stay as they were
    eng = _engine("torch", pair, kv_block_size=4, kv_dtype="int8")
    before = {n: t.clone() for n, t in eng._pool_kv.items()}
    cfg = eng.config
    vals = torch.randn(cfg.num_layers, 2, cfg.num_heads,
                       cfg.hidden_size // cfg.num_heads)
    blk = torch.full((2,), eng._pool.sentinel, dtype=torch.long)
    eng._q_write((blk, torch.tensor([0, 3])), vals, vals)
    for name, t in eng._pool_kv.items():
        assert torch.equal(t[:, :-1], before[name][:, :-1])
    assert eng._pool_kv["k_scale"][:, -1].any()
    eng.close()


def test_threaded_daemon_loop_matches_manual_ticks(pair):
    """Concurrent submits into the daemon loop (auto chain length): the
    tokens of the manual-tick run, which equal the JAX engine's."""
    want, _ = _run("torch", pair, kv_block_size=4)
    eng = _engine("torch", pair, auto_start=True, chain_tokens=None,
                  kv_block_size=4)
    results = {}

    def client(i, p, n):
        results[i] = eng.submit(p, n).result(timeout=60).tolist()

    threads = [threading.Thread(target=client, args=(i, p, n))
               for i, (p, n) in enumerate(CASES)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    eng.close()
    assert not any(t.is_alive() for t in threads)
    assert [results[i] for i in range(len(CASES))] == want


def test_background_prefill_is_preempted_and_both_finish(pair):
    from sparkdl_torch.serving import PRIORITY_BACKGROUND

    long_prompt = list(np.random.default_rng(5).integers(1, 100, 40))
    want, _ = _run("torch", pair, [(long_prompt, 4), ([6, 8, 6], 4)],
                   kv_block_size=4, prefill_chunk=4)
    eng = _engine("torch", pair, kv_block_size=4, prefill_chunk=4, n_slots=1)
    bg = eng.submit(long_prompt, 4, priority=PRIORITY_BACKGROUND)
    eng.tick()  # admitted, first chunk
    assert eng._prefilling
    fg = eng.submit([6, 8, 6], 4)
    eng.tick()  # the interactive request takes the slot
    held = [s.req.future for s in (*eng._prefilling.values(),
                                   *eng._inflight.values())]
    assert held == [fg] and eng.queue.depth == 1  # the victim waits
    while not (bg.done() and fg.done()):
        eng.tick()
    eng.close()
    assert [bg.result().tolist(), fg.result().tolist()] == want


def test_deadline_mid_decode_fails_alone(pair):
    from sparkdl_torch.serving import DeadlineExceededError

    eng = _engine("torch", pair, kv_block_size=4)
    doomed = eng.submit(SHARED, 20, timeout_s=0.05)
    ok = eng.submit([6, 8, 6], 3)
    eng.tick()
    import time

    time.sleep(0.1)
    while not (doomed.done() and ok.done()):
        eng.tick()
    eng.close()
    with pytest.raises(DeadlineExceededError, match="mid-decode"):
        doomed.result()
    assert len(ok.result()) == 3
    assert eng._pool.used_count == eng._prefix.cached_blocks


def test_constructor_contract(pair, monkeypatch):
    _, _, tcfg, module = pair
    # sp: a power of two, the paged layout, no more cards than are visible
    with pytest.raises(ValueError, match="power of two"):
        TorchEngine(tcfg, module, sp=6, auto_start=False)
    with pytest.raises(ValueError, match="requires kv_layout='paged'"):
        TorchEngine(tcfg, module, sp=2, kv_layout="dense", auto_start=False)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="exceeds the 1 visible devices"):
            TorchEngine._sp_devices(torch.device("cuda", 0), 2)
    # the tier knobs are validated as the reference validates them
    for kw, match in ((dict(kv_layout="dense", host_kv_blocks=4),
                       "requires kv_layout='paged'"),
                      (dict(disk_kv_blocks=4), "requires host_kv_blocks"),
                      (dict(host_kv_blocks=0), "host_kv_blocks must be"),
                      (dict(host_kv_blocks=4, disk_kv_blocks=-1),
                       "disk_kv_blocks must be")):
        with pytest.raises(ValueError, match=match):
            TorchEngine(tcfg, module, auto_start=False, **kw)
    with pytest.raises(ValueError, match="require kv_layout='paged'"):
        TorchEngine(tcfg, module, kv_layout="dense", spec_k=4,
                    auto_start=False)
    eng = TorchEngine(tcfg, module, auto_start=False)
    assert eng.device == torch.device("cpu")
    # no tier store: nothing parks, exports or imports
    with pytest.raises(RuntimeError, match="needs a host tier"):
        eng.park_cold()
    assert eng.export_parked_sessions() is None
    assert eng.import_parked_sessions({"sessions": [{}]}) == 0
    cap = eng.capacity()
    assert cap["free_slots"] == eng.n_slots and cap["kv_blocks_free"] > 0
    eng.close()
    # a state dict builds the module on the requested device, the card by
    # default, which raises where there is none
    sd = module.state_dict()
    eng = TorchEngine(tcfg, sd, device="cpu", auto_start=False)
    assert eng.submit([1, 2, 3], 2) is not None
    eng.close(drain=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchEngine(tcfg, sd, auto_start=False)
