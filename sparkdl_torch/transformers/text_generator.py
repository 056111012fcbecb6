"""DeepTextGenerator — GPT generation over DataFrames.

A column of prompt token-id arrays goes in, a column of generated token
ids comes out. Unequal-length prompts in a group decode together through
the ragged left-padded ``generate`` path (models/gpt.py): pad columns are
excluded from every attention softmax, so each row's greedy output equals
its unbatched decode.

Execution shape: prompts are grouped ``batchSize`` at a time and padded
to a (rows, prompt length) bucket, so the device sees a handful of
shapes. The model is a ``GPTLMHeadModel`` on ``device`` (``cuda`` unless
the caller passes ``device="cpu"``), built once per process for each
(weights, config, device). Tokenization is upstream (bring your own
tokenizer).

On the card each bucket's whole ``generate`` call — the prefill, every
cached decode step and the sampling — runs as one CUDA graph, captured at
the bucket's first use and replayed afterwards (:func:`graphed_generate`):
the counterpart of the reference's ``jax.jit(generate)`` per bucket, in
an LRU of 8 graphs as the reference's jit cache. On the CPU ``generate``
runs eagerly.
"""

from __future__ import annotations

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
from sparkdl_torch.runtime.batching import default_buckets, pick_bucket
from sparkdl_torch.runtime.dispatch import GraphCache, storage_key
from sparkdl_torch.transformers._inference import (
    run_partition_with_passthrough,
)
from sparkdl_torch.transformers.text import _fingerprint, _LruCache

#: per-process model cache (key: weights fingerprint + config + device)
_MODEL_CACHE: _LruCache = _LruCache(maxsize=8)
#: per-process CUDA graphs of whole generate calls, one per (rows,
#: prompt_len) bucket, decode settings and model storage
GENERATE_GRAPHS = GraphCache("generate", maxsize=8)


def _to_bundle(value):
    from sparkdl_torch.models.gpt import GPTConfig

    if (
        isinstance(value, tuple)
        and len(value) == 2
        and isinstance(value[0], GPTConfig)
        and isinstance(value[1], Mapping)
    ):
        return value
    raise TypeError(
        "model must be a (GPTConfig, state_dict) tuple, e.g. from "
        "models.gpt.load_hf_gpt2(...) or (cfg, init_gpt_(GPTLMHeadModel(cfg))"
        ".state_dict())"
    )


def _model(cfg, state_dict, device: str):
    """The module for (weights, config, device), built once per process."""
    from sparkdl_torch.models.gpt import GPTLMHeadModel

    key = (_fingerprint(state_dict), cfg, device)
    module = _MODEL_CACHE.get(key)
    if module is None:
        module = GPTLMHeadModel(cfg, device=device)
        module.load_state_dict(state_dict)
        module = _MODEL_CACHE[key] = module.eval()
    return module


def left_pad_group(group, row_buckets, len_buckets):
    """A group of prompts as the (rows, prompt_len) bucket it decodes in:
    int64 ids and a bool mask, each prompt left-padded into its row; the
    bucket's spare rows get one real token (id 0) in the last column."""
    nb = pick_bucket(len(group), row_buckets)
    lp = pick_bucket(max(len(g) for g in group), len_buckets)
    ids = np.zeros((nb, lp), np.int64)
    mask = np.zeros((nb, lp), np.bool_)
    for i, g in enumerate(group):
        ids[i, lp - len(g):] = g
        mask[i, lp - len(g):] = True
    mask[len(group):, -1] = True  # pad rows: 1 real token
    return ids, mask


def graphed_generate(module, ids: torch.Tensor, mask: torch.Tensor,
                     max_new_tokens: int, *, temperature: float = 0.0,
                     top_k=None, top_p=None,
                     generator: "torch.Generator | None" = None
                     ) -> torch.Tensor:
    """``generate(module, ids, max_new_tokens, attention_mask=mask, ...)``
    as :class:`DeepTextGenerator` runs it. On the card: one CUDA graph of
    the whole call per (rows, prompt_len) bucket and settings
    (``GENERATE_GRAPHS``), captured at first use after the call ran
    eagerly, replayed afterwards; a sampling ``generator`` is registered
    with the graph, so a replay draws what the eager call would from the
    same state. ``mask`` is not read back: it must be left-padded with a
    real last column, as the transformer builds it. On the CPU: the eager
    ``generate``."""
    from sparkdl_torch.models.gpt import (
        check_generate_args,
        generate,
        generate_unchecked,
    )

    if ids.device.type != "cuda":
        return generate(module, ids, max_new_tokens, attention_mask=mask,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        generator=generator)
    max_len = check_generate_args(
        module.config, ids.shape, max_new_tokens, temperature=temperature,
        top_k=top_k, top_p=top_p, generator=generator)

    def run(ids, mask, generator=None):
        return generate_unchecked(
            module, ids, max_new_tokens, max_len, attention_mask=mask,
            temperature=temperature, top_k=top_k, top_p=top_p,
            generator=generator)

    key = (module.config, max_new_tokens, temperature, top_k, top_p,
           storage_key(module))
    with torch.inference_mode():
        return GENERATE_GRAPHS(run, (ids, mask.bool()), key,
                               generator=generator)


def _group_generator(seed: int, counter: int, device) -> torch.Generator:
    """The sampling generator of one prompt group: a function of (seed,
    group counter) only, so re-running a partition reproduces it."""
    g = torch.Generator(device=device)
    return g.manual_seed((seed * 1_000_003 + counter) % (1 << 63))


class DeepTextGenerator(Transformer, HasInputCol, HasOutputCol, HasBatchSize):
    """prompt token ids (array<int>) -> generated token ids (array<int>).

    ``temperature=0`` (default) decodes greedily — deterministic, and each
    row matches its unbatched decode. ``temperature>0`` samples with
    optional ``topK``/``topP``; draws are deterministic per (seed, group
    of ``batchSize`` prompts), so re-running a partition reproduces its
    outputs.
    """

    model = Param(None, "model", "(GPTConfig, state_dict) decoder bundle",
                  _to_bundle)
    maxNewTokens = Param(None, "maxNewTokens",
                         "number of tokens to generate per row",
                         SparkDLTypeConverters.toInt)
    maxLength = Param(
        None, "maxLength",
        "prompt cap: longer prompts keep their LAST maxLength tokens "
        "(the continuation-relevant tail)", SparkDLTypeConverters.toInt)
    temperature = Param(None, "temperature",
                        "0 = greedy; >0 = sampled softmax temperature",
                        SparkDLTypeConverters.toFloat)
    topK = Param(None, "topK", "sample from the top-K logits only",
                 SparkDLTypeConverters.toInt)
    topP = Param(None, "topP", "nucleus sampling mass in (0, 1]",
                 SparkDLTypeConverters.toFloat)
    seed = Param(None, "seed", "sampling seed", SparkDLTypeConverters.toInt)
    device = Param(None, "device", "'cuda' (default) or 'cpu'",
                   SparkDLTypeConverters.toDevice)

    def __init__(self, inputCol=None, outputCol=None, model=None,
                 maxNewTokens=None, maxLength=None, temperature=None,
                 topK=None, topP=None, seed=None, batchSize=None,
                 device=None):
        super().__init__()
        self._setDefault(maxNewTokens=32, maxLength=128, temperature=0.0,
                         seed=0, batchSize=16, device="cuda")
        self._set(inputCol=inputCol, outputCol=outputCol, model=model,
                  maxNewTokens=maxNewTokens, maxLength=maxLength,
                  temperature=temperature, topK=topK, topP=topP, seed=seed,
                  batchSize=batchSize, device=device)

    def setModel(self, value):
        return self._set(model=value)

    def _transform(self, dataset):
        cfg, state_dict = self.getOrDefault("model")
        max_new = self.getOrDefault("maxNewTokens")
        max_len = self.getOrDefault("maxLength")
        temperature = self.getOrDefault("temperature")
        top_k = (self.getOrDefault("topK")
                 if self.isDefined("topK") else None)
        top_p = (self.getOrDefault("topP")
                 if self.isDefined("topP") else None)
        seed = self.getOrDefault("seed")
        batch_size = self.getBatchSize()
        device = self.getOrDefault("device")
        input_col = self.getInputCol()
        output_col = self.getOutputCol()
        if cfg.positions == "learned" and max_len + max_new > cfg.max_seq_len:
            raise ValueError(
                f"maxLength {max_len} + maxNewTokens {max_new} exceeds the "
                f"learned position table (max_seq_len={cfg.max_seq_len}); "
                "lower them or use a RoPE config"
            )
        if temperature <= 0 and (top_k is not None or top_p is not None):
            # fail fast, before any partition runs: generate() would raise
            # the same contract deep inside partition execution
            raise ValueError(
                "topK/topP only apply when sampling — set temperature > 0"
            )
        row_buckets = default_buckets(batch_size, min_bucket=4)
        len_buckets = default_buckets(max_len, min_bucket=8)

        def extract(row):
            ids = np.asarray(row[input_col], dtype=np.int64)
            if ids.ndim != 1 or ids.size == 0:
                raise ValueError(
                    f"prompt must be a non-empty 1-D id array, got shape "
                    f"{ids.shape}")
            return ids[-max_len:]  # keep the continuation-relevant tail

        class _GenRunner:
            """run_partition_with_passthrough adapter: groups prompts,
            buckets (rows, prompt_len) per group, generates, yields the
            per-row generated ids in order."""

            def __init__(self, module):
                self._module = module
                self._device = next(module.parameters()).device

            def run(self, prompts):
                valid = list(prompts)
                for counter, first in enumerate(
                        range(0, len(valid), batch_size)):
                    group = valid[first:first + batch_size]
                    ids, mask = left_pad_group(group, row_buckets,
                                               len_buckets)
                    lp = ids.shape[1]
                    gen = (_group_generator(seed, counter, self._device)
                           if temperature > 0 else None)
                    out = graphed_generate(
                        self._module,
                        torch.from_numpy(ids).to(self._device),
                        torch.from_numpy(mask).to(self._device),
                        max_new,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        generator=gen,
                    )[:len(group), lp:].cpu().numpy()
                    yield from out

        def partition_fn(rows):
            rows = list(rows)
            if not rows:
                return iter(())
            runner = _GenRunner(_model(cfg, state_dict, device))
            return run_partition_with_passthrough(
                rows, extract, runner, output_col,
                postprocess=lambda o: np.asarray(o).tolist(),
                input_cols=(input_col,),
            )

        return transform_partitions(
            dataset, partition_fn, [(output_col, "array<int>")]
        )
