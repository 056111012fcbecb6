"""The port's DeepTextGenerator (sparkdl_torch/transformers/text_generator.py)
against the JAX package's on the same rows and the same weights (the Flax
init of ``GPTConfig.tiny``, bridged to the port): greedy tokens are
identical, bad rows come out None, too-long prompts keep their tail, and
the parameters fail the same way. The port runs with ``device="cpu"``,
where its kernels' wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode.
"""

import numpy as np
import pytest
import torch

from sparkdl_tpu.dataframe.local import LocalDataFrame as JaxDataFrame
from sparkdl_tpu.models import gpt as jgpt
from sparkdl_tpu.transformers.text_generator import (
    DeepTextGenerator as JaxGenerator,
)
from sparkdl_torch.dataframe.local import LocalDataFrame
from sparkdl_torch.models import gpt as tgpt
from sparkdl_torch.models.convert import gpt_flax_to_torch
from sparkdl_torch.transformers.text_generator import DeepTextGenerator
from torch_parity import gpt_variables

torch.set_num_threads(2)

ROWS = [
    {"prompt": [5, 3, 9, 2, 7], "tag": 0},
    {"prompt": [1, 4], "tag": 1},
    {"prompt": [], "tag": 2},                     # empty -> None
    {"prompt": [6, 8, 6], "tag": 3},
    {"prompt": list(range(1, 40)), "tag": 4},     # longer than maxLength
    {"prompt": [11, 2, 3, 4, 5, 6, 7], "tag": 5},
    {"prompt": "not ids", "tag": 6},              # not an id array -> None
]


@pytest.fixture(scope="module")
def bundles():
    kw = dict(attn_impl="flash", flash_decode=True)
    jcfg = jgpt.GPTConfig.tiny(**kw)
    variables = gpt_variables(jcfg, seed=0)
    tcfg = tgpt.GPTConfig.tiny(**kw)
    return (jcfg, variables), (tcfg, gpt_flax_to_torch(variables))


def _run(cls, df_cls, bundle, rows, parts=2, **kw):
    n = -(-len(rows) // parts)
    df = df_cls([rows[i:i + n] for i in range(0, len(rows), n)])
    return cls(inputCol="prompt", outputCol="generated", model=bundle,
               **kw).transform(df).collect()


def test_greedy_tokens_bad_rows_and_tails_match_jax(bundles):
    jb, tb = bundles
    kw = dict(maxNewTokens=5, maxLength=16, batchSize=4)
    want = _run(JaxGenerator, JaxDataFrame, jb, ROWS, **kw)
    got = _run(DeepTextGenerator, LocalDataFrame, tb, ROWS, device="cpu", **kw)
    assert [r["tag"] for r in got] == [r["tag"] for r in want] == list(range(7))
    for g, w in zip(got, want):
        assert g["prompt"] == w["prompt"]  # passthrough intact
        assert g["generated"] == w["generated"], g["tag"]
    assert got[2]["generated"] is None and got[6]["generated"] is None
    # the long prompt kept its last 16 tokens
    module = tgpt.GPTLMHeadModel(tb[0], device="cpu")
    module.load_state_dict(tb[1])
    tail = torch.tensor([ROWS[4]["prompt"][-16:]])
    solo = tgpt.generate(module.eval(), tail, 5)
    assert got[4]["generated"] == solo[0, 16:].tolist()


def test_full_batch_groups_and_row_buckets_match_jax(bundles):
    """Nine prompts at batchSize 4: two full groups and a ragged one,
    bucketed to 4 rows (pad rows carry one real token)."""
    jb, tb = bundles
    r = np.random.default_rng(0)
    rows = [{"prompt": r.integers(1, 128, r.integers(1, 12)).tolist()}
            for _ in range(9)]
    kw = dict(maxNewTokens=4, batchSize=4)
    want = _run(JaxGenerator, JaxDataFrame, jb, rows, parts=1, **kw)
    got = _run(DeepTextGenerator, LocalDataFrame, tb, rows, parts=1,
               device="cpu", **kw)
    assert [g["generated"] for g in got] == [w["generated"] for w in want]


def test_sampling_is_seeded(bundles):
    _, tb = bundles
    rows = [{"prompt": [7, 7, 2]}, {"prompt": [9]}]

    def run(seed):
        out = _run(DeepTextGenerator, LocalDataFrame, tb, rows, parts=1,
                   maxNewTokens=5, temperature=0.9, topK=8, seed=seed,
                   device="cpu")
        return [r["generated"] for r in out]

    a, b, c = run(1), run(1), run(2)
    assert a == b  # deterministic per seed
    assert a != c  # and the seed matters


def test_param_errors_match_jax(bundles):
    jb, tb = bundles
    rows = [{"prompt": [3, 1, 4]}]
    for cls, df_cls, bundle, kw in (
            (JaxGenerator, JaxDataFrame, jb, {}),
            (DeepTextGenerator, LocalDataFrame, tb, dict(device="cpu"))):
        with pytest.raises(TypeError, match="GPTConfig"):
            cls(inputCol="p", outputCol="g", model=("x", {}))
        with pytest.raises(KeyError, match="input column"):
            cls(inputCol="nope", outputCol="g", model=bundle, maxNewTokens=2,
                **kw).transform(df_cls([rows])).collect()
        with pytest.raises(ValueError, match="topK/topP"):
            cls(inputCol="prompt", outputCol="g", model=bundle, topK=3,
                **kw).transform(df_cls([rows])).collect()
        with pytest.raises(TypeError):
            cls(inputCol="prompt", outputCol="g", maxNewTokens="many")
    with pytest.raises(ValueError, match="position table"):
        cfg = tgpt.GPTConfig.tiny(positions="learned", max_seq_len=16)
        sd = tgpt.GPTLMHeadModel(cfg, device="cpu").state_dict()
        DeepTextGenerator(inputCol="prompt", outputCol="g", model=(cfg, sd),
                          maxNewTokens=10, maxLength=16, device="cpu",
                          ).transform(LocalDataFrame([rows])).collect()
    with pytest.raises(ValueError, match="device"):
        DeepTextGenerator(inputCol="prompt", outputCol="g", device="tpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeepTextGenerator(inputCol="prompt", outputCol="g", model=tb,
                          ).transform(LocalDataFrame([rows])).collect()
