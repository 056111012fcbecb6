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

With the default ``device="cuda"`` a group is spread over the host's
cards, as the reference's ``generate`` runs SPMD over its local chips:
the group size rounds down, and the row buckets up, to multiples of the
card count (the smallest bucket 4), each card holds its own copy of the
model, and generates its contiguous rows of the group with its own graphs
on its own stream. Greedy tokens are the one-card run's (each row decodes
alone; only a library's choice of kernel for another row count could
tell them apart, ROADMAP C15).
"""

from __future__ import annotations

import contextlib
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
#: per-process placements (key: weights fingerprint + config + devices):
#: their replicas' streams and graph caches outlive a partition
_REPLICA_CACHE: _LruCache = _LruCache(maxsize=8)


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
                     generator: "torch.Generator | None" = None,
                     graphs: "GraphCache | None" = None
                     ) -> torch.Tensor:
    """``generate(module, ids, max_new_tokens, attention_mask=mask, ...)``
    as :class:`DeepTextGenerator` runs it. On the card: one CUDA graph of
    the whole call per (rows, prompt_len) bucket and settings
    (``GENERATE_GRAPHS``), captured at first use after the call ran
    eagerly, replayed afterwards; a sampling ``generator`` is registered
    with the graph, so a replay draws what the eager call would from the
    same state. ``mask`` is not read back: it must be left-padded with a
    real last column, as the transformer builds it. ``graphs``: the cache
    to use (default ``GENERATE_GRAPHS``; a replica sharing a card with
    another passes its own, so that their replays never share static
    buffers). On the CPU: the eager ``generate``."""
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
    graphs = GENERATE_GRAPHS if graphs is None else graphs
    with torch.inference_mode():
        return graphs(run, (ids, mask.bool()), key, generator=generator)


def _group_generator(seed: int, counter: int, device) -> torch.Generator:
    """The sampling generator of one prompt group: a function of (seed,
    group counter) only, so re-running a partition reproduces it."""
    g = torch.Generator(device=device)
    return g.manual_seed((seed * 1_000_003 + counter) % (1 << 63))


class _GenReplica:
    """One device of a generator's placement: its module, and on a card
    of a placement over several its own stream and graph cache (the
    first keeps ``GENERATE_GRAPHS``)."""

    def __init__(self, module, index: int, n: int):
        self.module = module
        self.device = next(module.parameters()).device
        own = n > 1 and self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if own else None
        self.graphs = (GraphCache("generate", maxsize=8)
                       if own and index > 0 else None)

    def scope(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


def _generate_group(replicas, ids: np.ndarray, mask: np.ndarray, max_new: int,
                    *, seed: int, counter: int, **decode) -> np.ndarray:
    """One left-padded group over the replicas: replica ``i`` generates
    its contiguous rows (the group's rows divide their count), all
    enqueued before any is read back; the rows come back in order. A
    sampled run draws on replica ``i`` from the generator of group
    ``counter * n + i``."""
    n = len(replicas)
    m = ids.shape[0] // n
    outs = []
    for i, r in enumerate(replicas):
        with r.scope():
            gen = (_group_generator(seed, counter * n + i, r.device)
                   if decode["temperature"] > 0 else None)
            out = graphed_generate(
                r.module, torch.from_numpy(ids[i * m:(i + 1) * m]).to(r.device),
                torch.from_numpy(mask[i * m:(i + 1) * m]).to(r.device),
                max_new, generator=gen, graphs=r.graphs, **decode)
            outs.append(out)
    parts = []
    for r, out in zip(replicas, outs):
        with r.scope():
            parts.append(out.cpu().numpy())
    return np.concatenate(parts)


class DeepTextGenerator(Transformer, HasInputCol, HasOutputCol, HasBatchSize):
    """prompt token ids (array<int>) -> generated token ids (array<int>).

    ``temperature=0`` (default) decodes greedily — deterministic, and each
    row matches its unbatched decode. ``temperature>0`` samples with
    optional ``topK``/``topP``; draws are deterministic per (seed, group
    of prompts, card count), so re-running a partition reproduces its
    outputs. Over several cards each card draws for its rows from its own
    generator: a sampled run depends on the card count, a greedy one does
    not.
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

    @staticmethod
    def _devices(device: str, batch_size: int) -> "list[str]":
        """Where a group is generated: every card (at most ``batch_size``)
        for ``cuda`` on a host with several, else ``device`` alone."""
        n = torch.cuda.device_count() if device == "cuda" else 1
        n = max(1, min(n, batch_size))
        return [device] if n == 1 else [f"cuda:{i}" for i in range(n)]

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
        devices = self._devices(device, batch_size)
        n = len(devices)
        chunk, row_buckets = batch_size, default_buckets(batch_size, min_bucket=4)
        if n > 1:
            # the runner's dp bucket rule: the group rounds DOWN to a
            # multiple of the cards, the row buckets UP
            chunk = max(n, batch_size // n * n)
            row_buckets = tuple(sorted({
                -(-b // n) * n for b in default_buckets(chunk, min_bucket=4)}))
        len_buckets = default_buckets(max_len, min_bucket=8)
        decode = dict(temperature=temperature, top_k=top_k, top_p=top_p)

        def extract(row):
            ids = np.asarray(row[input_col], dtype=np.int64)
            if ids.ndim != 1 or ids.size == 0:
                raise ValueError(
                    f"prompt must be a non-empty 1-D id array, got shape "
                    f"{ids.shape}")
            return ids[-max_len:]  # keep the continuation-relevant tail

        class _GenRunner:
            """run_partition_with_passthrough adapter: groups prompts,
            buckets (rows, prompt_len) per group, generates over the
            replicas, yields the per-row generated ids in order."""

            def __init__(self, replicas):
                self._replicas = replicas

            def run(self, prompts):
                valid = list(prompts)
                for counter, first in enumerate(range(0, len(valid), chunk)):
                    group = valid[first:first + chunk]
                    ids, mask = left_pad_group(group, row_buckets,
                                               len_buckets)
                    lp = ids.shape[1]
                    out = _generate_group(self._replicas, ids, mask, max_new,
                                          seed=seed, counter=counter, **decode)
                    yield from out[:len(group), lp:]

        def partition_fn(rows):
            rows = list(rows)
            if not rows:
                return iter(())
            key = (_fingerprint(state_dict), cfg, tuple(devices))
            replicas = _REPLICA_CACHE.get(key)
            if replicas is None:
                replicas = _REPLICA_CACHE[key] = [
                    _GenReplica(_model(cfg, state_dict, d), i, n)
                    for i, d in enumerate(devices)]
            runner = _GenRunner(replicas)
            return run_partition_with_passthrough(
                rows, extract, runner, output_col,
                postprocess=lambda o: np.asarray(o).tolist(),
                input_cols=(input_col,),
            )

        return transform_partitions(
            dataset, partition_fn, [(output_col, "array<int>")]
        )
