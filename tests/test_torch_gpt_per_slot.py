"""The serving half of the port's GPT module against the JAX module's:
the per-slot cached step (every row at its own depth, L=1 decode and
L=k verify), its drops past the buffer, the paged pool's storage
(``init_block_pool``) and the int8 KV quantization.

Same weights through the weight bridge (``torch_parity.gpt_pair``), the
same inputs from a numpy seed, both on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import gpt_pair

from sparkdl_torch.models import gpt as tgpt
from sparkdl_tpu.models import gpt as jgpt

LOGIT_TOL = 1e-5  # float32, 2 layers: the summation orders differ


def _cache(cfg, rng, b, w):
    hd = cfg.hidden_size // cfg.num_heads
    shape = (cfg.num_layers, b, w, cfg.num_heads, hd)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("positions", ["rope", "learned"])
@pytest.mark.parametrize("l", [1, 4])
def test_per_slot_step_matches_jax(positions, l):
    """Rows at depths 0, 5, 11 and 13 of a 16-column cache: L=1 is the
    decode step, L=4 the speculative verify; the row at 13 writes past
    the buffer at L=4 (dropped on both sides)."""
    jm, variables, tm = gpt_pair(0, positions=positions)
    cfg = jm.config
    rng = np.random.default_rng(1)
    k, v = _cache(cfg, rng, 4, 16)
    idx = np.array([0, 5, 11, 13], np.int32)
    ids = rng.integers(0, cfg.vocab_size, (4, l)).astype(np.int32)
    jl, jc = jm.apply(variables, jnp.asarray(ids),
                      cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
                             "idx": jnp.asarray(idx)})
    tc = {"k": torch.tensor(k), "v": torch.tensor(v),
          "idx": torch.tensor(idx)}
    with torch.no_grad():
        tl, tc = tm(torch.tensor(ids).long(), cache=tc)
    jl = np.asarray(jl)
    scale = np.abs(jl).max()
    assert np.abs(tl.numpy() - jl).max() <= LOGIT_TOL * scale
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5, rtol=0)
    assert tc["idx"].dtype == torch.int32
    assert tc["idx"].tolist() == np.asarray(jc["idx"]).tolist()


def test_per_slot_with_explicit_positions_and_key_mask_matches_jax():
    """The dense engine's step: positions that skip left pads and a
    per-row key mask over the buffer."""
    jm, variables, tm = gpt_pair(0, positions="learned")
    cfg = jm.config
    rng = np.random.default_rng(2)
    k, v = _cache(cfg, rng, 3, 16)
    idx = np.array([6, 9, 12], np.int32)
    start = np.array([2, 0, 5], np.int32)
    pos = (idx - start)[:, None]
    key_valid = np.arange(16)[None, :] >= start[:, None]
    ids = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    jl, _ = jm.apply(variables, jnp.asarray(ids),
                     cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
                            "idx": jnp.asarray(idx)},
                     positions=jnp.asarray(pos),
                     attention_mask=jnp.asarray(key_valid))
    with torch.no_grad():
        tl, _ = tm(torch.tensor(ids).long(),
                   cache={"k": torch.tensor(k), "v": torch.tensor(v),
                          "idx": torch.tensor(idx)},
                   positions=torch.tensor(pos).long(),
                   attention_mask=torch.tensor(key_valid))
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= LOGIT_TOL * np.abs(jl).max()


def test_write_past_the_buffer_changes_no_other_column():
    """Columns at or past the buffer are dropped: a row whose span runs
    over keeps every earlier column, and an idle row far past the buffer
    keeps all of its columns."""
    rng = np.random.default_rng(3)
    buf = torch.tensor(rng.standard_normal((3, 8, 2, 4)).astype(np.float32))
    before = buf.clone()
    new = torch.tensor(rng.standard_normal((3, 4, 2, 4)).astype(np.float32))
    tgpt.write_columns(buf, new, torch.tensor([2, 6, 1000], dtype=torch.int32))
    assert torch.equal(buf[0, 2:6], new[0])
    assert torch.equal(buf[0, :2], before[0, :2])
    assert torch.equal(buf[0, 6:], before[0, 6:])
    assert torch.equal(buf[1, 6:8], new[1, :2])  # new[1, 2:] dropped
    assert torch.equal(buf[1, :6], before[1, :6])
    assert torch.equal(buf[2], before[2])
    with pytest.raises(ValueError, match="do not fit"):
        tgpt.write_columns(buf, torch.zeros(3, 9, 2, 4),
                           torch.zeros(3, dtype=torch.int32))


def test_init_cache_per_slot_and_block_pool_match_jax():
    cfg_t, cfg_j = tgpt.GPTConfig.tiny(), jgpt.GPTConfig.tiny()
    cache = tgpt.init_cache(cfg_t, 3, 16, per_slot=True, device="cpu")
    want = jgpt.init_cache(cfg_j, 3, 16, per_slot=True)
    assert tuple(cache["k"].shape) == want["k"].shape
    assert cache["idx"].dtype == torch.int32 and tuple(cache["idx"].shape) == (3,)
    assert tgpt.init_cache(cfg_t, 3, 16, device="cpu")["idx"] == 0
    for dtype, store in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                         ("int8", torch.int8)):
        pool = tgpt.init_block_pool(cfg_t, 5, 4, dtype, device="cpu")
        ref = jgpt.init_block_pool(cfg_j, 5, 4, dtype)
        assert sorted(pool) == sorted(ref)
        for name, t in pool.items():
            assert tuple(t.shape) == ref[name].shape
            assert not t.any()
        assert pool["k"].dtype == store
    with pytest.raises(ValueError, match="unknown KV pool dtype"):
        tgpt.init_block_pool(cfg_t, 5, 4, "fp8", device="cpu")


def test_quantize_kv_codes_equal_jax_and_round_trip():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 7, 3, 4, 8)) * 3).astype(np.float32)
    x[0, 0] = 0.0  # a zero column: floor scale, zero codes
    # a column whose absmax is 127 has scale 1: its halves are ties,
    # rounded to even on both sides
    x[1, 2, 1] = 0.0
    x[1, 2, 1, 0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5]
    q, s = tgpt.quantize_kv(torch.tensor(x))
    jq, js = jgpt.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    deq = tgpt.dequantize_kv(q, s)
    np.testing.assert_allclose(
        deq.numpy(), np.asarray(jgpt.dequantize_kv(jq, js)), rtol=1e-7, atol=0)
    # requantizing a dequantized column gives back its codes and scale
    q2, s2 = tgpt.quantize_kv(deq)
    assert torch.equal(q2, q) and torch.equal(s2, s)
    assert not q[0, 0].any()
    assert q[1, 2, 1, 0, :6].tolist() == [127, 0, 2, 2, 0, -2]


def test_pow2_bucket_matches_the_reference():
    from sparkdl_torch.runtime.batching import pow2_bucket
    from sparkdl_tpu.runtime.batching import pow2_bucket as ref

    for n in (0, 1, 7, 8, 9, 33, 255, 256, 257):
        for lo, hi in ((8, None), (1, 32), (8, 768)):
            assert pow2_bucket(n, lo, hi) == ref(n, lo, hi)
