"""Data-parallel generation in one process: the port of
``tests/models/test_gpt_dp.py``'s two cases, plain and ragged, and the
DeepTextGenerator over a placement.

The reference commits the prompt batch to its virtual 8-device CPU mesh
and ``generate`` runs SPMD over it, token-identical to the unsharded
run. The port spreads a group's rows over replicas of the model, one a
device (``text_generator._generate_group``); here four replicas on the
CPU stand in for four cards. Greedy tokens must equal the JAX
``generate``'s on the same weights (the Flax init of ``GPTConfig.tiny``,
bridged to the port).
"""

import numpy as np
import pytest

from sparkdl_torch.transformers import text_generator as tg
from torch_parity import gpt_pair

rng = np.random.default_rng(17)
DEVICES = 4
GREEDY = dict(temperature=0.0, top_k=None, top_p=None)


@pytest.fixture(scope="module")
def pair():
    return gpt_pair()


def _replicas(module):
    return [tg._GenReplica(module, i, DEVICES) for i in range(DEVICES)]


def test_dp_generate_matches_unsharded_jax(pair):
    from sparkdl_tpu.models.gpt import generate

    jmodel, variables, module = pair
    ids = rng.integers(0, 128, (8, 6)).astype(np.int64)
    want = np.asarray(generate(jmodel, variables, ids.astype(np.int32), 5))
    got = tg._generate_group(_replicas(module), ids, np.ones_like(ids, bool), 5,
                             seed=0, counter=0, **GREEDY)
    assert got.shape == (8, 11)
    np.testing.assert_array_equal(got, want)


def test_dp_ragged_generate(pair):
    """A ragged left-padded batch split over the replicas: per-row masking
    and positions survive the split."""
    from sparkdl_tpu.models.gpt import generate

    jmodel, variables, module = pair
    ids = rng.integers(1, 128, (8, 5)).astype(np.int64)
    mask = np.ones((8, 5), np.int32)
    mask[::2, :2] = 0  # every other row is left-padded by 2
    ids = ids * mask  # pad positions hold token 0
    want = np.asarray(generate(jmodel, variables, ids.astype(np.int32), 4,
                               attention_mask=mask))
    got = tg._generate_group(_replicas(module), ids, mask.astype(bool), 4,
                             seed=0, counter=0, **GREEDY)
    np.testing.assert_array_equal(got, want)


def test_generator_over_a_placement_matches_jax(pair, monkeypatch):
    """DeepTextGenerator with its groups spread over four devices (its
    ``_devices`` hook returning four CPU stand-ins): the groups round to
    the device count, and the greedy tokens are the JAX generator's (which
    runs over the conftest's eight virtual devices)."""
    from sparkdl_tpu.dataframe.local import LocalDataFrame as JaxDataFrame
    from sparkdl_tpu.transformers.text_generator import DeepTextGenerator as JaxGen
    from sparkdl_torch.dataframe.local import LocalDataFrame
    from sparkdl_torch.models import gpt as tgpt

    _, variables, module = pair
    cfg = tgpt.GPTConfig.tiny()
    seen = []

    class Placed(tg.DeepTextGenerator):
        @staticmethod
        def _devices(device, batch_size):
            seen.append((device, batch_size))
            return [device] * DEVICES

    r = np.random.default_rng(0)
    rows = [{"prompt": r.integers(1, 128, r.integers(1, 12)).tolist()}
            for _ in range(21)]
    # batchSize 10: groups of 8 (rounded down to the device multiple, as
    # the reference's over its 8 devices), row buckets multiples of 4
    kw = dict(inputCol="prompt", outputCol="generated", maxNewTokens=4, batchSize=10)
    want = JaxGen(model=(pair[0].config, variables), **kw).transform(
        JaxDataFrame([rows])).collect()
    shapes = []
    real = tg._generate_group

    def recording(replicas, ids, mask, *a, **k):
        shapes.append((len(replicas), ids.shape[0]))
        return real(replicas, ids, mask, *a, **k)

    monkeypatch.setattr(tg, "_generate_group", recording)
    got = Placed(model=(cfg, module.state_dict()), device="cpu", **kw).transform(
        LocalDataFrame([rows])).collect()
    assert seen == [("cpu", 10)]
    assert shapes == [(DEVICES, 8), (DEVICES, 8), (DEVICES, 8)]  # 8 + 8 + 5 rows
    assert [g["generated"] for g in got] == [w["generated"] for w in want]
