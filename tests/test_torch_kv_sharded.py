"""The port's SeqShardedBlockPool against the JAX package's: striped
allocation, the virtual id -> (device, local block) mapping, refcounts
across shards, the shard-imbalance gauge, and spare parking that drains
and restores the stripes evenly. Each case runs the same operations on
both packages' pools and holds the port to the reference's block ids,
counts and gauge values."""

import pytest

from sparkdl_torch.observability.registry import registry
from sparkdl_torch.serving.kv_blocks import KVBlockPool, SeqShardedBlockPool
from sparkdl_tpu.observability.registry import registry as jax_registry
from sparkdl_tpu.serving.kv_blocks import SeqShardedBlockPool as JaxPool


def _both(ops):
    """``ops(pool_class)`` on the reference's pool and the port's: the
    port's result, after checking that both gave the same."""
    want, got = ops(JaxPool), ops(SeqShardedBlockPool)
    assert got == want
    return got


def test_divisibility_validated():
    with pytest.raises(ValueError, match="divisible"):
        SeqShardedBlockPool(10, 4, sp=4)
    with pytest.raises(ValueError, match="sp"):
        SeqShardedBlockPool(8, 4, sp=0)


def test_virtual_to_device_local_mapping():
    def ops(cls):
        pool = cls(8, 4, sp=2)
        return (pool.blocks_per_shard, [pool.shard_of(b) for b in range(8)],
                [pool.local_id(b) for b in range(8)])

    per_shard, shards, local = _both(ops)
    # contiguous shards: device c holds [c * 4, (c + 1) * 4)
    assert per_shard == 4
    assert shards == [0] * 4 + [1] * 4
    assert local == [0, 1, 2, 3] * 2


def test_striped_allocation_balances_shards():
    def ops(cls):
        pool = cls(8, 4, sp=2)
        got = pool.allocate(4)
        return got, [pool.shard_of(b) for b in got], pool.shard_used_counts()

    _, shards, used = _both(ops)
    assert shards.count(0) == 2 and shards.count(1) == 2
    assert used == [2, 2]


def test_striping_skips_exhausted_shard():
    def ops(cls):
        pool = cls(8, 4, sp=2)
        a = pool.allocate(6)  # 3 a shard
        b = pool.allocate(2)
        used, free = pool.shard_used_counts(), pool.free_count
        none = pool.allocate(1)  # defers, never errors
        first0 = next(x for x in a if pool.shard_of(x) == 0)
        pool.release(pool.deref([first0]))
        got = pool.allocate(1)
        return a + b, used, free, none, pool.shard_of(got[0])

    _, used, free, none, shard = _both(ops)
    assert used == [4, 4] and free == 0 and none is None
    assert shard == 0  # the freed shard-0 block is the one handed out


def test_refcounts_across_shards():
    """A block on shard 1 shared by two owners survives the first deref:
    sharing (copy on write, prefix reuse) is by virtual id."""
    def ops(cls):
        pool = cls(8, 4, sp=2)
        got = pool.allocate(2)
        remote = next(b for b in got if pool.shard_of(b) == 1)
        pool.ref([remote])
        out = [pool.refcount(remote), pool.deref([remote]),
               pool.deref([remote])]
        pool.release([remote])
        return out + [pool.free_count]

    assert _both(ops) == [2, [], [4], 7]


def test_imbalance_gauge_tracks_skew():
    def ops(cls):
        reg = jax_registry() if cls is JaxPool else registry()
        reg.reset()
        pool = cls(8, 4, sp=2)
        pool.allocate(4)  # striped: balanced
        fam = reg.get("sparkdl_sp_shard_imbalance")
        # the series exists at zero skew, not only once skew appears
        balanced = fam.snapshot_values()
        used1 = [b for b in range(8)
                 if not pool._is_free[b] and pool.shard_of(b) == 1]
        pool.release(pool.deref(used1))
        skewed = fam.snapshot_values()
        pool.close()
        return balanced, skewed, fam.snapshot_values()

    balanced, skewed, closed = _both(ops)
    assert balanced == {"": 0.0}
    assert skewed == {"": pytest.approx(2 / 4)}
    assert closed == {"": 0.0}


def test_base_pool_contracts_inherited():
    """Deferral streaks, double-free detection and the sentinel hold
    unchanged."""
    pool = SeqShardedBlockPool(4, 4, sp=2)
    assert pool.sentinel == 4
    got = pool.allocate(4)
    assert pool.allocate(1) is None
    pool.record_deferral(need=1)
    assert pool.deferral_streak == 1
    zeroed = pool.deref(got[:1])
    pool.release(zeroed)
    assert pool.deferral_streak == 0  # a release covering the need clears
    with pytest.raises(RuntimeError, match="double free"):
        pool.release(zeroed)
    assert isinstance(pool, KVBlockPool)


def test_sharded_pool_parks_evenly_and_restores_stripes():
    def ops(cls):
        p = cls(16, 4, sp=2)
        out = [p.shrink(4), [len(d) for d in p._shard_free]]
        got = p.allocate(4)
        out += [got, p.used_count, sum(p.shard_used_counts()), p.grow(4),
                [sorted(d) for d in p._shard_free]]
        p.release(p.deref(got))
        out += [p.used_count, p.shrink(100), p.grow(100), p.free_count]
        return out

    (parked, free_per_shard, got, used, shard_used, grown, stripes,
     used_after, parked_all, grown_all, free) = _both(ops)
    assert parked == 4
    assert free_per_shard == [6, 6]  # spare drains evenly off the stripes
    assert {b // 8 for b in got} == {0, 1}  # allocation still stripes
    assert used == shard_used == 4  # spare is neither used nor free
    assert grown == 4
    # grow returns each block to its own shard
    assert sum(len(d) for d in stripes) == 12
    assert all(b // 8 == shard for shard, d in enumerate(stripes) for b in d)
    assert used_after == 0
    assert parked_all == grown_all == 15  # the need floor (1) keeps one free
    assert free == 16
