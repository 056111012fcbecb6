"""Prefix→host digest units: the hash grid both ends of the fabric
share.

The router never ships tries — it compares CHAINED block hashes: each
host publishes ``PrefixCache.block_hashes()`` (its cached block-aligned
prefixes), the router hashes an incoming prompt once with
``prompt_block_hashes`` on the same grid, and ``match_blocks`` counts
the consecutive-from-zero overlap. These tests pin the grid agreement —
a drift between the two sides silently turns affinity routing into load
routing, which no hard failure would ever surface.
"""

import subprocess
import sys

from sparkdl_torch.fabric.digest import (
    HostDigest,
    match_blocks,
    prompt_block_hashes,
)
from sparkdl_torch.serving.kv_blocks import KVBlockPool
from sparkdl_torch.serving.prefix_cache import (
    DIGEST_ROOT,
    PrefixCache,
    chain_hash,
)

import pytest

BS = 4


def _digest(hashes, bs=BS, host="h"):
    return HostDigest(host_id=host, block_size=bs,
                      hashes=frozenset(hashes))


# -- chain_hash ---------------------------------------------------------------

def test_chain_hash_deterministic_across_processes():
    """The digest must survive the wire: blake2b, not PYTHONHASHSEED-
    salted hash() — a child process with a different seed computes the
    IDENTICAL value."""
    here = chain_hash(DIGEST_ROOT, (5, 3, 9, 2))
    code = ("from sparkdl_torch.serving.prefix_cache import "
            "DIGEST_ROOT, chain_hash; "
            "print(chain_hash(DIGEST_ROOT, (5, 3, 9, 2)))")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, env={"PYTHONHASHSEED": "99", "PATH": "/usr/bin:/bin",
                         "PYTHONPATH": ":".join(sys.path)})
    assert int(out.stdout.strip()) == here


def test_chain_hash_sensitive_to_parent_and_tokens():
    a = chain_hash(DIGEST_ROOT, (1, 2, 3, 4))
    assert chain_hash(DIGEST_ROOT, (1, 2, 3, 5)) != a
    assert chain_hash(a, (1, 2, 3, 4)) != a
    # chained: same block under different parents hashes differently
    b = chain_hash(DIGEST_ROOT, (9, 9, 9, 9))
    assert chain_hash(a, (7, 7, 7, 7)) != chain_hash(b, (7, 7, 7, 7))


# -- prompt_block_hashes ------------------------------------------------------

def test_prompt_block_hashes_grid():
    """Entry i covers [0, (i+1)*bs); the final prompt token never
    participates (it always prefills — the same tokens[:-1] rule the
    cache's own match applies)."""
    toks = list(range(13))  # 12 usable -> 3 full blocks at bs=4
    hs = prompt_block_hashes(toks, BS)
    assert len(hs) == 3
    h0 = chain_hash(DIGEST_ROOT, tuple(toks[0:4]))
    h1 = chain_hash(h0, tuple(toks[4:8]))
    h2 = chain_hash(h1, tuple(toks[8:12]))
    assert hs == [h0, h1, h2]
    # exactly 12 tokens: only 11 usable -> 2 blocks
    assert len(prompt_block_hashes(toks[:12], BS)) == 2
    # shorter than one block: no hashes at all
    assert prompt_block_hashes([1, 2, 3], BS) == []
    assert prompt_block_hashes([], BS) == []


def test_prompt_block_hashes_max_blocks_cap():
    toks = list(range(100))
    assert len(prompt_block_hashes(toks, BS, max_blocks=5)) == 5


def test_prompt_block_hashes_rejects_bad_block_size():
    with pytest.raises(ValueError, match="block_size"):
        prompt_block_hashes([1, 2, 3], 0)


# -- match_blocks -------------------------------------------------------------

def test_match_blocks_consecutive_from_zero():
    hs = prompt_block_hashes(list(range(17)), BS)  # 4 blocks
    assert match_blocks(hs, _digest(hs)) == 4
    assert match_blocks(hs, _digest(hs[:2])) == 2
    # a hole at block 1 makes deeper blocks unreachable: the radix
    # match could never reuse block 2 without block 1
    assert match_blocks(hs, _digest([hs[0], hs[2], hs[3]])) == 1
    assert match_blocks(hs, _digest([])) == 0
    assert match_blocks(hs, None) == 0
    assert match_blocks([], _digest(hs)) == 0


def test_host_digest_from_snapshot():
    assert HostDigest.from_snapshot(None) is None  # dense host
    d = HostDigest.from_snapshot(
        {"host_id": "h1", "block_size": 4, "version": 7,
         "hashes": [1, 2, 3]})
    assert d.host_id == "h1" and d.block_size == 4 and d.version == 7
    assert d.hashes == frozenset((1, 2, 3))
    assert d.age_s(d.fetched_at + 2.5) == pytest.approx(2.5)


# -- PrefixCache.block_hashes: the host side of the grid ----------------------

def _cache(n_blocks=32):
    return PrefixCache(KVBlockPool(n_blocks, BS))


def _seed(cache, tokens):
    """Register ``tokens`` as a prefilled prompt (allocate real block
    ids — register indexes the slot's table prefix)."""
    n = -(-len(tokens) // BS)
    ids = cache.pool.allocate(n)
    assert ids is not None
    cache.register(tuple(tokens), ids)
    return ids


def test_block_hashes_match_prompt_grid():
    cache = _cache()
    toks = tuple(range(12))  # 3 full blocks
    _seed(cache, toks)
    got = set(cache.block_hashes())
    # the host's digest must contain every block-aligned prefix of the
    # registered prompt, on exactly the router's grid (tokens[:-1] is
    # irrelevant here: 13-token prompts hash 3 blocks = all cached)
    want = prompt_block_hashes(list(toks) + [99], BS)
    assert set(want) <= got
    assert len(got) == 3


def test_block_hashes_excludes_partial_tails():
    cache = _cache()
    _seed(cache, tuple(range(10)))  # 2 full blocks + 2-token partial
    assert len(cache.block_hashes()) == 2  # the partial never ships


def test_block_hashes_shared_prefix_no_duplicates():
    cache = _cache()
    a = tuple(range(8))
    _seed(cache, a)
    _seed(cache, a + (50, 51, 52, 53))
    hs = cache.block_hashes()
    assert len(hs) == len(set(hs)) == 3  # 2 shared + 1 divergent


def test_block_hashes_mru_first_and_bounded():
    cache = _cache()
    _seed(cache, tuple(range(0, 4)))
    _seed(cache, tuple(range(100, 104)))
    # re-touch the first prompt: MRU order must put it ahead
    cache.match(tuple(range(0, 4)) + (9,))
    hs = cache.block_hashes(max_entries=1)
    assert hs == [chain_hash(DIGEST_ROOT, tuple(range(0, 4)))]
    assert cache.block_hashes(max_entries=0) == []
    assert len(cache.block_hashes()) == 2
