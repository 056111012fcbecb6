"""DeepTextFeaturizer — BERT-backed text featurization over DataFrames,
and the text transformers' shared helpers (a bounded LRU for per-process
caches, a cheap fingerprint of a state dict to key them by).

A column of token-id arrays goes in, pooled encoder features come out as
a float array column: ``cls`` (the first token), ``mean`` (the
mask-weighted mean over real tokens) or ``pooler`` (HF's tanh pooler
head). Rows are padded/truncated to ``maxLength`` and right-padded with a
key mask; an empty row has no valid key (see ``ops/flash_attention``: it
comes out finite). The encoder is ``models.bert.BertModel`` on ``device``
(``cuda`` unless the caller passes ``device="cpu"``), run by the shared
``BatchedRunner``: on the card each bucket's forward is a CUDA graph whose
inputs are the staged ids and mask, so with ``BertConfig(attn_impl=
"flash")`` the flash attention kernel launches inside the replays.
Tokenization is upstream (bring your own tokenizer).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from collections.abc import Mapping

import numpy as np
import torch

from sparkdl_torch.dataframe import transform_partitions
from sparkdl_torch.param import (
    HasBatchSize,
    HasInputCol,
    HasOutputCol,
    Param,
    SparkDLTypeConverters,
    Transformer,
)

_POOLINGS = ("cls", "mean", "pooler")


class _LruCache(OrderedDict):
    """Tiny bounded LRU so long-lived executors hosting many models don't
    keep every built model (and its device memory) for the process
    lifetime."""

    def __init__(self, maxsize: int):
        super().__init__()
        self.maxsize = maxsize

    def get(self, key, default=None):
        if key in self:
            self.move_to_end(key)
            return self[key]
        return default

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.move_to_end(key)
        while len(self) > self.maxsize:
            self.popitem(last=False)


def _fingerprint(state_dict: dict) -> str:
    """A key for a state dict without copying it to the host: the dict's
    identity, every tensor's name, shape, dtype and device, and the first
    16 elements of the largest tensor (random weights there, where a small
    tensor such as a bias may be all zeros). The identity guards against
    two dicts alike in all of that; the elements against an id reused
    after the first dict was freed."""
    items = sorted(state_dict.items())
    meta = [(k, tuple(t.shape), str(t.dtype), str(t.device)) for k, t in items]
    h = hashlib.blake2b(repr((id(state_dict), meta)).encode(), digest_size=16)
    if items:
        big = max((t for _, t in items), key=lambda t: t.numel())
        h.update(big.detach().reshape(-1)[:16].to("cpu", torch.float32)
                 .numpy().tobytes())
    return h.hexdigest()


#: per-process runner cache: one BERT forward (and its CUDA graphs) per
#: (weights, config, pooling, shapes, device), however many partitions or
#: copies of the transformer use it. LRU-bounded: evicting a live runner
#: only costs a rebuild and recapture on next use.
_RUNNER_CACHE: _LruCache = _LruCache(maxsize=8)


def _to_bundle(value):
    """Validate the model param: a (BertConfig, state_dict) pair."""
    from sparkdl_torch.models.bert import BertConfig

    if (
        isinstance(value, tuple)
        and len(value) == 2
        and isinstance(value[0], BertConfig)
        and isinstance(value[1], Mapping)
    ):
        return value
    raise TypeError(
        "model must be a (BertConfig, state_dict) tuple, e.g. from "
        "models.bert.load_hf_bert(...) or (cfg, init_bert_(BertModel(cfg))"
        ".state_dict())"
    )


def _encoder(cfg, state_dict, pooling: str, device: str):
    """The ``BertModel`` for the bundle on ``device``, with the pooler
    only where ``pooling`` uses it (a state dict's pooler is dropped
    otherwise, as the JAX module ignores unused parameters)."""
    from sparkdl_torch.models.bert import BertModel

    add_pooler = pooling == "pooler"
    module = BertModel(cfg, add_pooler=add_pooler, device=device)
    sd = {k: v for k, v in state_dict.items()
          if add_pooler or not k.startswith("pooler.")}
    module.load_state_dict(sd)
    return module.eval()


class DeepTextFeaturizer(Transformer, HasInputCol, HasOutputCol, HasBatchSize):
    model = Param(None, "model", "(BertConfig, state_dict) encoder bundle",
                  _to_bundle)
    pooling = Param(
        None, "pooling",
        "how to pool token features: 'cls' (first token), 'mean' "
        "(mask-weighted mean), 'pooler' (HF tanh pooler head)",
        SparkDLTypeConverters.toString,
    )
    maxLength = Param(None, "maxLength",
                      "pad/truncate token ids to this length",
                      SparkDLTypeConverters.toInt)
    device = Param(None, "device", "'cuda' (default) or 'cpu'",
                   SparkDLTypeConverters.toDevice)

    def __init__(self, inputCol=None, outputCol=None, model=None,
                 pooling=None, maxLength=None, batchSize=None, device=None):
        super().__init__()
        self._setDefault(pooling="mean", maxLength=128, batchSize=64,
                         device="cuda")
        self._set(inputCol=inputCol, outputCol=outputCol, model=model,
                  pooling=pooling, maxLength=maxLength, batchSize=batchSize,
                  device=device)

    def setModel(self, value):
        return self._set(model=value)

    def _transform(self, dataset):
        from sparkdl_torch.transformers._inference import (
            BatchedRunner,
            run_partition_with_passthrough,
        )

        cfg, state_dict = self.getOrDefault("model")
        pooling = self.getOrDefault("pooling")
        if pooling not in _POOLINGS:
            raise ValueError(f"pooling must be one of {_POOLINGS}, "
                             f"got {pooling!r}")
        max_len = self.getOrDefault("maxLength")
        batch_size = self.getBatchSize()
        device = self.getOrDefault("device")
        input_col = self.getInputCol()
        output_col = self.getOutputCol()

        def make_apply(dev):
            module = _encoder(cfg, state_dict, pooling, dev)

            def apply_fn(batch):
                mask = batch["attention_mask"]
                seq, pooled = module(batch["input_ids"].long(), mask)
                if pooling == "pooler":
                    out = pooled
                elif pooling == "cls":
                    out = seq[:, 0]
                else:  # mask-weighted mean over real tokens
                    m = mask[:, :, None].to(seq.dtype)
                    out = (seq * m).sum(dim=1) / m.sum(dim=1).clamp(min=1)
                return out.float()

            return apply_fn

        def make_runner():
            # with the default "cuda": a batch spread over the cards, a
            # copy of the encoder on each
            return BatchedRunner(make_apply(device), batch_size=batch_size,
                                 device=device, replicate=make_apply)

        def partition_fn(rows):
            rows = list(rows)
            if not rows:
                return iter(())
            key = (_fingerprint(state_dict), cfg, pooling, max_len, batch_size,
                   device)
            runner = _RUNNER_CACHE.get(key)
            if runner is None:
                runner = _RUNNER_CACHE[key] = make_runner()

            def extract(row):
                ids = np.asarray(row[input_col], dtype=np.int32)
                if ids.ndim != 1:
                    raise ValueError(
                        f"token-id input must be 1-D, got {ids.shape}")
                n = min(len(ids), max_len)
                padded = np.zeros(max_len, np.int32)
                padded[:n] = ids[:n]
                mask = np.zeros(max_len, np.int32)
                mask[:n] = 1
                return {"input_ids": padded, "attention_mask": mask}

            return run_partition_with_passthrough(
                rows, extract, runner, output_col,
                lambda o: np.asarray(o, dtype=np.float32),
                input_cols=(input_col,),
            )

        return transform_partitions(
            dataset, partition_fn, [(output_col, "array<float>")])
