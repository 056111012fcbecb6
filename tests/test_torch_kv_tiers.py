"""Tiered KV in the port against the JAX package, on the CPU.

Store level: the same park / fetch / peek / drop sequences give the same
demotions, drops and ``stats()`` in both ``TieredKVStore``s, the spill
path is crash-safe (a torn file, a digest mismatch, a missing sidecar or
an orphaned ``.tmp`` each become the corrupt-unpark path), and a spill
file or export bundle written by either package decodes in the other to
identical bits for float32, bfloat16 and int8.

Engine level, for each ``kv_dtype``: a session parked between turns and
resumed gives turn-2 greedy tokens bitwise those of the same engine
that never parked — through the host tier, the disk tier, and an
export/import between two engines — equal to the JAX engine's, to the
token; the pool tensors never move; injected ``kv.park``, ``kv.unpark``
and ``kv.migrate`` faults lose no request; the scratch block at the
sentinel id is never parked.
"""

import glob
import json
import os

import numpy as np
import pytest
from torch_parity import gpt_pair

from sparkdl_torch.observability.flight import healthz_report
from sparkdl_torch.reliability.faults import inject
from sparkdl_torch.serving import ContinuousGPTEngine as TorchEngine
from sparkdl_torch.serving import kv_codec
from sparkdl_torch.serving import kv_tiers as tkv
from sparkdl_torch.serving.kv_blocks import KVBlockPool
from sparkdl_torch.serving.prefix_cache import PrefixCache
from sparkdl_tpu.serving import ContinuousGPTEngine as JaxEngine
from sparkdl_tpu.serving import kv_tiers as jkv

MAX_LEN = 32
DTYPES = ("fp32", "bf16", "int8")
TIERED = dict(kv_blocks=24, host_kv_blocks=64, disk_kv_blocks=16)


@pytest.fixture(scope="module")
def pair():
    jm, variables, tm = gpt_pair(0)
    return jm.config, variables, tm.config, tm


def _engine(kind, pair, **kw):
    jcfg, variables, tcfg, module = pair
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("auto_start", False)
    kw.setdefault("kv_block_size", 4)
    if kind == "jax":
        return JaxEngine(jcfg, variables, **kw)
    return TorchEngine(tcfg, module, **kw)


def _drain(eng, futs):
    while not all(f.done() for f in futs):
        eng.tick()


def _prompts(seed=7, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 100, size=9).tolist() for _ in range(n)]


def _turn(eng, prompts, new=4):
    futs = [eng.submit(p, new) for p in prompts]
    _drain(eng, futs)
    return [f.result(timeout=0).tolist() for f in futs]


def _next_prompts(prompts, replies):
    return [p + r + [5] for p, r in zip(prompts, replies)]


def _two_turns(eng, prompts, *, park):
    """Turn 1, optionally park everything cold, turn 2 (each prompt
    extended by its own turn-1 reply and one fresh token)."""
    replies = _turn(eng, prompts)
    if park:
        eng.park_cold()
    return _turn(eng, _next_prompts(prompts, replies))


# -- the store ----------------------------------------------------------------

class _H:
    """A trie-node stand-in: a handle with ``children`` and ``tier``."""

    def __init__(self, name, children=()):
        self.name = name
        self.children = dict.fromkeys(children)
        self.tier = "device"

    def __repr__(self):
        return self.name


def _payload(tag):
    rng = np.random.default_rng(tag)
    return {"k": rng.standard_normal((2, 4, 2, 3)).astype(np.float32),
            "v": rng.integers(-128, 127, (2, 4, 2, 3)).astype(np.int8)}


STORE_SCRIPTS = {
    # (host, disk, protected names, ops)
    "lru_cascade_host_disk_drop": (2, 2, (), [
        ("park", "a"), ("park", "b"), ("park", "c"), ("park", "d"),
        ("park", "e"), ("fetch", "c"), ("fetch", "a")]),
    "fetch_peek_drop": (2, 3, (), [
        ("park", "a"), ("park", "b"), ("park", "c"), ("peek", "a"),
        ("fetch", "b"), ("drop", "c"), ("park", "d"), ("park", "e"),
        ("peek", "d"), ("fetch", "a"), ("fetch", "z")]),
    "host_only_overflow_drops": (2, 0, (), [
        ("park", "a"), ("park", "b"), ("park", "c"), ("fetch", "a"),
        ("fetch", "c")]),
    "protected_interior_soft_exceeds": (1, 1, ("a", "b"), [
        ("park", "a"), ("park", "b"), ("park", "c"), ("park", "d"),
        ("fetch", "b")]),
}


def _store_trace(mod, name, tmp_path):
    host, disk, protected, ops = STORE_SCRIPTS[name]
    nodes = {n: _H(n, children=("x",) if n in protected else ())
             for n in "abcdez"}
    store = mod.TieredKVStore(host, disk, spill_dir=str(tmp_path),
                              is_droppable=lambda node: not node.children)
    out = []
    try:
        for i, (op, n) in enumerate(ops):
            if op == "park":
                ret = [x.name for x in store.park(nodes[n], _payload(i))]
            elif op == "drop":
                ret = store.drop(nodes[n])
            else:
                got = getattr(store, op)(nodes[n])
                ret = None if got is None else {
                    k: (str(v.dtype), np.asarray(v).tobytes())
                    for k, v in got.items()}
            out.append((op, n, ret, store.stats(),
                        {x: store.tier_of(nodes[x]) for x in "abcde"},
                        {x: nodes[x].tier for x in "abcde"}))
    finally:
        store.close()
    return out


@pytest.mark.parametrize("name", sorted(STORE_SCRIPTS))
def test_store_sequences_match_the_reference(name, tmp_path):
    got = _store_trace(tkv, name, tmp_path / "t")
    assert got == _store_trace(jkv, name, tmp_path / "j")
    if name == "lru_cascade_host_disk_drop":
        assert got[4][2] == ["a"]  # disk overflow dropped the LRU leaf
    if name == "protected_interior_soft_exceeds":
        assert got[3][3]["disk_blocks"] == 2  # protected: soft-exceeded


def _register(prefix, pool, tokens):
    bids = pool.allocate(len(tokens) // pool.block_size)
    prefix.register(tuple(tokens), bids)
    prefix.release(bids)  # refcount 0: cold, cached
    return bids


def _cascade(kv_blocks_mod, prefix_mod, kv_tiers_mod):
    pool = kv_blocks_mod.KVBlockPool(16, 2)
    tiers = kv_tiers_mod.TieredKVStore(
        2, 2, is_droppable=lambda n: not n.children)
    prefix = prefix_mod.PrefixCache(pool, tiers=tiers)
    payload = lambda bid: {"k": np.full((1, 2), bid, np.float32)}  # noqa: E731
    sessions = {c: [10 * i + 1, 10 * i + 2] for i, c in enumerate("abcde")}
    node = lambda c: prefix._root.children.get(tuple(sessions[c]))  # noqa: E731
    trace = []
    for wave in ("abc", "de"):
        for c in wave:
            _register(prefix, pool, sessions[c])
        trace.append(prefix.demote(len(wave), payload))
        trace.append({c: (node(c).tier if node(c) else None) for c in "abcde"})
        trace.append((tiers.host_used, tiers.disk_used, pool.free_count))
    got = tiers.fetch(node("c"))
    trace.append(float(got["k"][0, 0]))
    trace.append(prefix.match(tuple(sessions["d"])).full_blocks)
    trace.append(prefix.tier_stats())
    tiers.close()
    return trace


def test_prefix_cache_demotion_cascade_matches_the_reference():
    """One eviction policy across the hierarchy: demote parks the LRU
    device leaf first, host overflow demotes its LRU entry to disk, disk
    overflow drops the LRU disk leaf (pruned from the trie)."""
    from sparkdl_torch.serving import kv_blocks as tkb
    from sparkdl_torch.serving import prefix_cache as tpc
    from sparkdl_tpu.serving import kv_blocks as jkb
    from sparkdl_tpu.serving import prefix_cache as jpc

    got = _cascade(tkb, tpc, tkv)
    assert got == _cascade(jkb, jpc, jkv)
    assert got[1] == {"a": "disk", "b": "host", "c": "host",
                      "d": None, "e": None}
    assert got[4]["a"] is None  # dropped and pruned


def test_refcounted_share_never_parks():
    pool = KVBlockPool(8, 2)
    tiers = tkv.TieredKVStore(8)
    prefix = PrefixCache(pool, tiers=tiers)
    payload = lambda bid: {"k": np.zeros((1, 2), np.float32)}  # noqa: E731
    bids = pool.allocate(2)
    prefix.register((1, 2, 3, 4), bids)  # refcount 1: live
    assert prefix.demote(2, payload) == 0 and tiers.host_used == 0
    prefix.release(bids)
    assert prefix.demote(2, payload) == 2 and tiers.host_used == 2


# -- spill crash safety ----------------------------------------------------------

def _spill_one(store, node, tag):
    assert store.park(node, _payload(tag)) == []
    assert store.park(("filler", tag), _payload(tag + 1000)) == []
    assert store.tier_of(node) == "disk"
    return store._disk[node]


def _companions(path):
    return [p for p in (path, path + ".tmp", path + ".sha256")
            if os.path.exists(p)]


def _truncate(path):
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[: len(blob) // 2])


def _garble(path):
    open(path, "wb").write(b"\xff" * os.path.getsize(path))


KILL_POINTS = {
    "intact": lambda path: None,
    "truncated": _truncate,
    "garbled_same_length": _garble,
    "missing_sidecar": lambda path: os.unlink(path + ".sha256"),
    "orphaned_tmp": lambda path: os.rename(path, path + ".tmp"),
}


@pytest.mark.parametrize("kill", sorted(KILL_POINTS))
def test_torn_spill_fetches_none_and_prunes(kill, tmp_path):
    store = tkv.TieredKVStore(1, 4, spill_dir=str(tmp_path))
    try:
        path = _spill_one(store, "sess", 2)
        KILL_POINTS[kill](path)
        got = store.fetch("sess")
        if kill == "intact":
            for key, want in _payload(2).items():
                assert got[key].dtype == want.dtype
                np.testing.assert_array_equal(got[key], want)
        else:
            assert got is None
        assert _companions(path) == [] and "sess" not in store
        assert store.tier_of(("filler", 2)) == "host"  # untouched
    finally:
        store.close()


def test_peek_on_torn_file_is_none_but_nondestructive(tmp_path):
    store = tkv.TieredKVStore(1, 4, spill_dir=str(tmp_path))
    try:
        path = _spill_one(store, "sess", 6)
        with open(path, "ab") as f:
            f.write(b"garbage")
        assert store.peek("sess") is None
        assert store.tier_of("sess") == "disk" and _companions(path)
        store.drop("sess")
        assert _companions(path) == []
    finally:
        store.close()


def test_close_with_external_dir_unlinks_spills(tmp_path):
    store = tkv.TieredKVStore(1, 4, spill_dir=str(tmp_path))
    for i in range(4):
        store.park(("s", i), _payload(i))
    assert glob.glob(str(tmp_path / "kvblk-*"))
    store.close()
    assert os.path.isdir(tmp_path) and not glob.glob(str(tmp_path / "kvblk-*"))
    owned = tkv.TieredKVStore(1, 2)  # no dir given: its own, removed at close
    owned.park("a", _payload(0))
    owned.park("b", _payload(1))
    spill_dir = owned._dir
    assert os.listdir(spill_dir)
    owned.close()
    assert not os.path.exists(spill_dir)


# -- the raw codec across the two packages -----------------------------------------

def _block(dtype, seed=0):
    """One KV block payload in storage dtype: the reference's arrays and
    the port's (bf16 as BF16Bits), the same bits."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 2, 3)).astype(np.float32)
    if dtype == "fp32":
        return {"k": x, "v": -x}, {"k": x, "v": -x}
    if dtype == "bf16":
        ref = {"k": x.astype(ml_dtypes.bfloat16),
               "v": (-x).astype(ml_dtypes.bfloat16)}
        return ref, {n: kv_codec.bf16_bits(a.view(np.uint16))
                     for n, a in ref.items()}
    q = rng.integers(-127, 128, (2, 4, 2, 3)).astype(np.int8)
    s = rng.random((2, 4)).astype(np.float32)
    both = {"k": q, "v": -q, "k_scale": s, "v_scale": 2 * s}
    return both, dict(both)


def _bits(a):
    return np.asarray(a).view(np.uint8).tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_codec_and_spill_files_cross_the_packages_bit_for_bit(dtype, tmp_path):
    from sparkdl_tpu.disagg.handoff import _dec, _enc

    ref, port = _block(dtype)
    for name in ref:
        # reference JSON -> port, port JSON -> reference: the same bits
        got = kv_codec.decode(json.loads(json.dumps(_enc(ref[name]))))
        assert _bits(got) == _bits(ref[name])
        assert isinstance(got, kv_codec.BF16Bits) == (dtype == "bf16")
        back = _dec(json.loads(json.dumps(kv_codec.encode(port[name]))))
        assert back.dtype == ref[name].dtype and _bits(back) == _bits(ref[name])
    # a spill file written by one store loads in the other
    for writer, reader, payload, want in ((jkv, tkv, ref, port),
                                          (tkv, jkv, port, ref)):
        w = writer.TieredKVStore(1, 2, spill_dir=str(tmp_path / writer.__name__))
        w.park("blk", payload)
        w.park("filler", payload)
        path = w._disk["blk"]
        r = reader.TieredKVStore(1, 2, spill_dir=str(tmp_path / "r"))
        loaded = r._load(path)
        assert {n: _bits(v) for n, v in loaded.items()} == {
            n: _bits(v) for n, v in want.items()}
        w.close()
        r.close()


# -- the engine ----------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_parked_resume_is_bitwise_and_equals_the_jax_engine(pair, kv_dtype):
    """Parked vs never parked, same engine settings: turn 2 bitwise (raw
    bytes out and back), the pool tensors never rebound, and the tokens
    equal the JAX engine's parked run, to the token."""
    prompts = _prompts()
    kw = dict(kv_dtype=kv_dtype, **TIERED)
    eng = _engine("torch", pair, **kw)
    ptrs = {n: t.data_ptr() for n, t in eng._pool_kv.items()}
    got = _two_turns(eng, prompts, park=True)
    tiers = eng._kv_snapshot()["tiers"]
    assert {n: t.data_ptr() for n, t in eng._pool_kv.items()} == ptrs
    eng.close()
    with _engine("torch", pair, **kw) as plain:
        assert got == _two_turns(plain, prompts, park=False)
    with _engine("jax", pair, **kw) as jeng:
        assert got == _two_turns(jeng, prompts, park=True)
        jtiers = jeng._kv_snapshot()["tiers"]
    assert tiers["parks"] > 0 and tiers["unparks"] > 0
    assert tiers["park_fallbacks"] == 0
    for key in ("parks", "unparks", "host_blocks", "disk_blocks"):
        assert tiers[key] == jtiers[key], key


@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_disk_tier_resume_is_bitwise(pair, kv_dtype, tmp_path):
    """A host tier of 2 blocks: parking spills the rest to disk (raw
    codec, crash-safe files), and the resume from disk is bitwise."""
    prompts = _prompts(seed=8)
    kw = dict(kv_dtype=kv_dtype, kv_blocks=24, host_kv_blocks=2,
              disk_kv_blocks=64)
    with _engine("torch", pair, kv_spill_dir=str(tmp_path), **kw) as eng:
        replies = _turn(eng, prompts)
        eng.park_cold()
        snap = eng._kv_snapshot()["tiers"]
        assert snap["disk_blocks"] > 0
        assert len(glob.glob(str(tmp_path / "kvblk-*.json"))) == snap["disk_blocks"]
        got = _turn(eng, _next_prompts(prompts, replies))
        assert eng._kv_snapshot()["tiers"]["park_fallbacks"] == 0
    with _engine("torch", pair, **kw) as plain:
        assert got == _two_turns(plain, prompts, park=False)
    assert not glob.glob(str(tmp_path / "kvblk-*"))  # closed: spills removed


@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_export_import_resumes_bitwise_across_engines_and_packages(
        pair, kv_dtype):
    """Export from one engine, import into a second: the second's turn 2
    is bitwise the never-parked turn 2 — port to port, and with the JAX
    engine on either end of the wire."""
    prompts = _prompts(seed=9, n=2)
    kw = dict(kv_dtype=kv_dtype, **TIERED)
    with _engine("torch", pair, **kw) as plain:
        want = _two_turns(plain, prompts, park=False)
    for src_kind, dst_kind in (("torch", "torch"), ("jax", "torch"),
                               ("torch", "jax")):
        with _engine(src_kind, pair, **kw) as src:
            replies = _turn(src, prompts)
            src.park_cold()
            bundle = json.loads(json.dumps(src.export_parked_sessions()))
            assert src._kv_snapshot()["tiers"]["host_blocks"] == 0
        assert bundle["kv_dtype"] == kv_dtype and bundle["sessions"]
        with _engine(dst_kind, pair, **kw) as dst:
            assert dst.import_parked_sessions(bundle) == len(bundle["sessions"])
            got = _turn(dst, _next_prompts(prompts, replies))
            snap = dst._kv_snapshot()["tiers"]
        assert got == want, (src_kind, dst_kind)
        assert snap["unparks"] > 0 and snap["park_fallbacks"] == 0


@pytest.mark.parametrize("kv_dtype", DTYPES)
@pytest.mark.parametrize("site", ["kv.park", "kv.unpark", "kv.migrate"])
def test_injected_tier_faults_lose_no_request(pair, site, kv_dtype):
    """A torn park evicts instead, a corrupt unpark prunes and
    re-prefills, a torn migration skips the session: every request still
    completes with the never-parked tokens, and the fallback is counted."""
    prompts = _prompts(seed=4, n=2)
    kw = dict(kv_dtype=kv_dtype, **TIERED)
    with _engine("torch", pair, **kw) as plain:
        want = _two_turns(plain, prompts, park=False)
    with _engine("torch", pair, **kw) as eng:
        replies = _turn(eng, prompts)
        nxt = _next_prompts(prompts, replies)
        if site == "kv.park":
            with inject("kv.park:RuntimeError@1"):
                eng.park_cold()
            got = _turn(eng, nxt)
        elif site == "kv.unpark":
            eng.park_cold()
            with inject("kv.unpark:RuntimeError@1"):
                got = _turn(eng, nxt)
        else:
            eng.park_cold()
            with inject("kv.migrate:RuntimeError@1"):
                bundle = eng.export_parked_sessions()
            assert len(bundle["sessions"]) == len(prompts) - 1
            with _engine("torch", pair, **kw) as dst:
                with inject("kv.migrate:RuntimeError@1"):
                    assert dst.import_parked_sessions(bundle) == 0
                assert dst.import_parked_sessions(bundle) == len(prompts) - 1
                got = _turn(dst, nxt)
        tiers = eng._kv_snapshot()["tiers"]
    assert got == want
    if site != "kv.migrate":
        assert tiers["park_fallbacks"] >= 1


@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_scratch_block_is_never_parked(pair, kv_dtype):
    """park_cold() walks the trie's cold blocks only: the sentinel id
    (the scratch block idle slots write into) is never registered, so it
    is never fetched, parked or exported."""
    with _engine("torch", pair, n_slots=3, kv_dtype=kv_dtype,
                 **TIERED) as eng:
        sentinel = eng._pool.sentinel
        seen = []
        park = eng._park_payload
        eng._park_payload = lambda bid: (seen.append(bid), park(bid))[1]
        replies = _turn(eng, _prompts(seed=5, n=2))
        assert eng._pool_kv["k"][:, sentinel].any()  # idle slots wrote it
        assert eng.park_cold() > 0
        bundle = eng.export_parked_sessions()
        assert seen and sentinel not in seen
        assert sentinel not in eng._prefix._registered
        assert all(len(b["k"]["shape"]) == 4 for s in bundle["sessions"]
                   for b in s["blocks"])
        del replies


def test_live_blocks_and_cow_donor_pinned_while_decoding(pair):
    """park_cold() mid-decode parks nothing a slot still references
    (the donor's partial tail block a COW sharer matched included); once
    both retire, their cold blocks park."""
    with _engine("torch", pair, host_kv_blocks=32, kv_blocks=16) as eng, \
            _engine("jax", pair, host_kv_blocks=32, kv_blocks=16) as jeng:
        donor = [5, 3, 9, 2, 7, 11]
        outs = []
        for e in (eng, jeng):
            fa = e.submit(donor, 8)
            for _ in range(3):
                e.tick()
            fb = e.submit(donor + [1, 6], 4)
            e.tick()
            assert not fa.done()
            assert e.park_cold() == 0
            assert e._kv_snapshot()["tiers"]["host_blocks"] == 0
            _drain(e, [fa, fb])
            parked = e.park_cold()
            outs.append((fa.result().tolist(), fb.result().tolist(), parked))
        assert outs[0] == outs[1] and outs[0][2] > 0


def test_capacity_and_healthz_expose_tier_occupancy(pair):
    with _engine("torch", pair, host_kv_blocks=64, kv_blocks=24) as eng:
        _turn(eng, _prompts(seed=5))
        cap = eng.capacity()
        assert cap["kv_blocks_cold"] > 0 and cap["kv_parked_blocks"] == 0
        eng.park_cold()
        cap = eng.capacity()
        assert cap["kv_parked_blocks"] > 0 and cap["kv_parked_sessions"] >= 3
        assert eng._pool.unpark_reserved == cap["kv_parked_blocks"]
        pools = [p for p in healthz_report()["kv_pools"]
                 if p.get("host_tier_blocks")]
        assert pools and pools[0]["parked_sessions"] >= 3
