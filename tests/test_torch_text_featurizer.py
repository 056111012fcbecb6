"""The port's DeepTextFeaturizer (sparkdl_torch/transformers/text.py)
against the JAX package's over the same LocalDataFrame rows and the same
tiny-BERT weights (the Flax init, through the BERT weight bridge): both
attention paths ("full"; "flash", the JAX kernel in interpret mode on the
CPU and the port's plain version), all three poolings, ragged lengths with
an empty row and rows longer than maxLength.

A row with no token has no valid key: the JAX flash kernel averages it
over its own padded key blocks, the port (kernel and plain version) over
the maxLength keys, as the dense path does. ``mean`` pooling zeroes such a
row in both; under ``cls`` and ``pooler`` with "flash" it is only checked
for finiteness.

Tolerance: max |diff| <= 1e-5 x max |ref| (float32 on both sides, two
layers, only summation order differs).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close

from sparkdl_tpu.models import bert as jbert
from sparkdl_torch import DeepTextFeaturizer, LocalDataFrame
from sparkdl_torch.models import bert as tbert
from sparkdl_torch.models.convert import bert_flax_to_torch
from sparkdl_torch.transformers import text as ttext

torch.set_num_threads(2)
TOL = 1e-5
VOCAB, MAX_LEN = 64, 16
#: token counts per row: an empty row, rows longer than MAX_LEN (truncated)
LENGTHS = (5, 16, 0, 20, 1, 9, 30, 12, 3)
EMPTY = LENGTHS.index(0)


@pytest.fixture(scope="module")
def variables():
    model = jbert.BertModel(jbert.BertConfig.tiny(vocab_size=VOCAB), add_pooler=True)
    v = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    return jax.device_get(flax.core.meta.unbox(v))


def _rows(seed, lengths=LENGTHS):
    r = np.random.default_rng(seed)
    return [{"id": i, "tokens": r.integers(1, VOCAB, n).tolist()}
            for i, n in enumerate(lengths)]


def _jax_features(variables, rows, attn_impl, pooling):
    from sparkdl_tpu.dataframe import LocalDataFrame as JaxFrame
    from sparkdl_tpu.transformers.text import DeepTextFeaturizer as JaxFeaturizer

    cfg = jbert.BertConfig.tiny(vocab_size=VOCAB, attn_impl=attn_impl)
    t = JaxFeaturizer(inputCol="tokens", outputCol="f", model=(cfg, variables),
                      pooling=pooling, maxLength=MAX_LEN, batchSize=4)
    return [r["f"] for r in t.transform(JaxFrame.from_rows(rows, 1)).collect()]


def _port(variables, attn_impl, pooling, **kw):
    cfg = tbert.BertConfig.tiny(vocab_size=VOCAB, attn_impl=attn_impl)
    return DeepTextFeaturizer(inputCol="tokens", outputCol="f",
                              model=(cfg, bert_flax_to_torch(variables)),
                              pooling=pooling, maxLength=MAX_LEN, batchSize=4,
                              device="cpu", **kw)


def _features(t, rows, partitions=2):
    out = t.transform(LocalDataFrame.from_rows(rows, partitions)).collect()
    assert [r["id"] for r in out] == [r["id"] for r in rows]
    return [r["f"] for r in out]


@pytest.mark.parametrize("pooling", ["cls", "mean", "pooler"])
@pytest.mark.parametrize("attn_impl", ["full", "flash"])
def test_features_match_jax(variables, attn_impl, pooling):
    rows = _rows(0)
    want = _jax_features(variables, rows, attn_impl, pooling)
    got = _features(_port(variables, attn_impl, pooling), rows)
    assert all(g.dtype == np.float32 and g.shape == (32,) for g in got)
    real = [i for i, n in enumerate(LENGTHS) if n]
    assert_close(np.stack([got[i] for i in real]),
                 np.stack([np.asarray(want[i]) for i in real]), TOL)
    assert np.isfinite(got[EMPTY]).all()
    if pooling == "mean":  # the mask zeroes it in both
        assert not got[EMPTY].any() and not np.asarray(want[EMPTY]).any()
    elif attn_impl == "full":  # the same empty-row semantics
        assert_close(got[EMPTY][None], np.asarray(want[EMPTY])[None], TOL)


def test_one_cached_runner_serves_different_masks(variables):
    """Two transforms with other lengths (other masks) reuse the one cached
    runner and model, and each agrees with the JAX featurizer."""
    ttext._RUNNER_CACHE.clear()
    t = _port(variables, "flash", "cls")
    first, second = _rows(1), _rows(2, lengths=(16, 2, 7, 11, 40, 4, 16, 1))
    for rows in (first, second):
        got = _features(t, rows)
        want = _jax_features(variables, rows, "flash", "cls")
        real = [i for i, r in enumerate(rows) if r["tokens"]]
        assert_close(np.stack([got[i] for i in real]),
                     np.stack([np.asarray(want[i]) for i in real]), TOL)
    assert len(ttext._RUNNER_CACHE) == 1
    # another pooling is another runner
    t.copy({"pooling": "mean"}).transform(LocalDataFrame.from_rows(first, 1)).collect()
    assert len(ttext._RUNNER_CACHE) == 2


def test_rows_truncate_at_max_length(variables):
    """A row longer than maxLength featurizes as its first maxLength ids."""
    r = np.random.default_rng(5)
    long = r.integers(1, VOCAB, 40).tolist()
    rows = [{"id": 0, "tokens": long}, {"id": 1, "tokens": long[:MAX_LEN]}]
    got = _features(_port(variables, "full", "mean"), rows, partitions=1)
    np.testing.assert_array_equal(got[0], got[1])


def test_params_and_errors(variables):
    t = DeepTextFeaturizer(inputCol="tokens", outputCol="f")
    assert (t.getOrDefault("pooling"), t.getOrDefault("maxLength"),
            t.getBatchSize(), t.getOrDefault("device")) == ("mean", 128, 64, "cuda")
    with pytest.raises(TypeError, match="BertConfig"):
        DeepTextFeaturizer(model=({}, {}))
    with pytest.raises(ValueError):
        DeepTextFeaturizer(device="tpu")
    bad = _port(variables, "full", "max")
    with pytest.raises(ValueError, match="pooling"):
        bad.transform(LocalDataFrame.from_rows(_rows(0), 1))
    # a 2-D token row is a per-row error: None, the others featurized
    rows = [{"id": 0, "tokens": [[1, 2], [3, 4]]}, {"id": 1, "tokens": [1, 2, 3]}]
    got = _features(_port(variables, "full", "cls"), rows, partitions=1)
    assert got[0] is None and got[1].shape == (32,)


def test_cuda_default_raises_without_cuda(variables):
    cfg = tbert.BertConfig.tiny(vocab_size=VOCAB)
    t = DeepTextFeaturizer(inputCol="tokens", outputCol="f",
                           model=(cfg, bert_flax_to_torch(variables)))
    with pytest.raises(RuntimeError, match="CUDA"):
        t.transform(LocalDataFrame.from_rows(_rows(0), 1)).collect()
