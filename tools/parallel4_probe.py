#!/usr/bin/env python3
"""Model parallelism across the GPUs of one host, against one GPU.

    python3 tools/parallel4_probe.py                    # four cards, NCCL
    python3 tools/parallel4_probe.py --platform cpu --tiny   # four gloo processes

``TorchRunner(np=-4)`` starts four ranks, one card each. Every check
holds a parallel layout against one card's run of the same weights
(random, from seed 0), which each rank also computes:

- ``sp_prefill`` at sp = 2 and 4 (GPT-2 small widths with RoPE, one
  4096-token prompt): ring logits within 1e-4 of the "full" forward
  (relative to its largest), all-gather logits too, with whether they
  are bitwise and their largest difference (ROADMAP C15), then 32 greedy
  tokens from the cache against plain ``generate``'s;
- GPT-2 small at tp = 2 and 4 (``attn_impl="flash"``, flash decode; heads
  split): forward logits within 1e-4, 32 greedy tokens identical;
- BERT-base fine-tuning (B=32, L=128, 8 steps, flash) at dp=2 x tp=2 and
  at tp=4 through ``SPMDPartitioner(BERT_RULES)``: losses within 1e-5
  relative of one card's, the step's median ms, its train dispatches
  (one CUDA graph a step) and the all-reduces a step runs;
- the mixture-of-experts GPT-2 small of chip_smoke's [moe] at ep = 4
  (8 experts, 2 a rank, each rank its quarter of the batch): logits
  within 1e-4 and 16 greedy tokens identical;
- ``pipeline_apply`` at pp = 4 over GPT-2 small's 12 blocks (3 a stage),
  8 microbatches: within 1e-5 of the sequential blocks;
- train steps over every mesh axis (plain SGD, so that a gradient summed
  over the wrong ranks or divided by the wrong count shows in the next
  loss), each held within 1e-5 relative per step of one card's losses,
  with the median step ms and the collectives a step: ViT-B/16 (flash,
  B=32, 8 steps) and BERT-base at fsdp=2 x tp=2 through VIT_RULES and
  BERT_RULES, BERT-base's ring at dp=2 x sp=2 (against one card's "full"
  attention), the MoE GPT-2 small as a classifier at ep=4 (the batch over
  ep too) and GPT-2 small's 12 blocks as four pipeline stages (their
  optimizer state one stage a rank); and ViT-B/16's forward at tp=2 and
  tp=4 within 1e-4 of one card's features;
- then, in the driving process over every card, chip_smoke's [dp] phase:
  data-parallel featurization and generation against one card;
- and chip_smoke's [sp_serve] phase over the cards: the continuous
  engine's sequence-parallel prefill at sp = 2 (cuda:0-1) and sp = 4
  (cuda:0-3), each shard on its own card, with its checks (tokens equal
  to sp=1's and to batch-1 generate, the final chunk's logits within
  1e-4, every request handed off, no request lost under injected
  ``sp.permute``/``sp.gather`` faults) plus each card's kernel time for
  one prompt's prefill and the staging bytes resident on each card, and
  the cross-card readback: the first token of a prompt whose last real
  row sits on a later card, read while every card but cuda:0 spins on
  its stream, and a scalar fetched from the last card with cuda:0
  current.
  ``--only-sp`` runs this section alone.

Prints one line a check and exits non-zero when one fails. chip_smoke's
[parallel] phase runs the same checks where it finds two or more cards.
``--platform cpu --tiny`` rehearses the control flow on the CPU (gloo,
the kernels' plain versions, tiny widths).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

TOL = 1e-4        # logits after 12 float32 layers, sums reordered across ranks
PIPE_TOL = 1e-5   # the same blocks, microbatched
LOSS_TOL = 1e-5   # relative, per step


def sizes(tiny: bool) -> dict:
    if tiny:
        return dict(gpt=dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
                             intermediate_size=128, max_seq_len=256),
                    bert=dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                              num_attention_heads=4, intermediate_size=64,
                              max_position_embeddings=64, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0),
                    ring_len=64, new=8, rows=8, length=16, batch=8, steps=3)
    return dict(gpt={}, bert={}, ring_len=4096, new=32, rows=8, length=128, batch=32,
                steps=8)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _device():
    import torch

    from sparkdl_torch.runtime.mesh import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return rank_device()


def _gpt(cfg, state, dev, mesh=None):
    from sparkdl_torch.models.convert import shard_state_dict
    from sparkdl_torch.models.gpt import GPTLMHeadModel
    from sparkdl_torch.partition.rules import GPT_RULES

    m = GPTLMHeadModel(cfg, device=dev, mesh=mesh)
    m.load_state_dict(shard_state_dict(state, m, GPT_RULES))
    return m.eval()


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def check_sp_prefill(s: dict, dev) -> dict:
    import torch
    import torch.distributed as dist

    from sparkdl_torch.models.gpt import (
        GPTConfig,
        GPTLMHeadModel,
        generate,
        generate_from_cache,
        init_gpt_,
        sp_prefill,
    )
    from sparkdl_torch.partition import make_mesh

    world = dist.get_world_size()
    cfg = GPTConfig(**s["gpt"])
    state = init_gpt_(GPTLMHeadModel(cfg, device="cpu"), seed=0).state_dict()
    plain = _gpt(cfg, state, dev)
    ids = torch.randint(0, cfg.vocab_size, (1, s["ring_len"]),
                        generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.inference_mode():
        full = plain(ids)[0]
    want = generate(plain, ids, s["new"])[:, ids.shape[1]:]
    out = {}
    for sp in (2, 4):
        if world % sp:
            continue
        mesh = make_mesh(dp=world // sp, sp=sp)
        for mode in ("ring", "allgather"):
            model = _gpt(dataclasses.replace(cfg, attn_impl="ring", sp_mode=mode), state,
                         dev, mesh)
            sp_prefill(model, ids, mesh)  # warm: the communicators
            _sync(dev)
            t0 = time.perf_counter()
            logits, cache = sp_prefill(model, ids, mesh)
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            toks = generate_from_cache(model, logits, cache, s["new"])
            out[f"sp{sp}_{mode}"] = {
                "rel": _rel(logits, full), "bitwise": bool(torch.equal(logits, full)),
                "max_diff": float((logits - full).abs().max()), "ms": ms,
                "tokens_equal": bool(torch.equal(toks, want)),
                "argmax_equal": bool(torch.equal(logits.argmax(-1), full.argmax(-1)))}
            del model, logits, cache
    return out


def check_tp(s: dict, dev) -> dict:
    import torch
    import torch.distributed as dist

    from sparkdl_torch.models.gpt import GPTConfig, GPTLMHeadModel, generate, init_gpt_
    from sparkdl_torch.partition import make_mesh

    world = dist.get_world_size()
    cfg = GPTConfig(**s["gpt"], attn_impl="flash", flash_decode=True)
    state = init_gpt_(GPTLMHeadModel(cfg, device="cpu"), seed=0).state_dict()
    plain = _gpt(cfg, state, dev)
    ids = torch.randint(0, cfg.vocab_size, (s["rows"], s["length"]),
                        generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.inference_mode():
        ref = plain(ids)[0]
    want = generate(plain, ids, s["new"])
    out = {}
    for tp in (2, 4):
        if world % tp or cfg.num_heads % tp:
            continue
        model = _gpt(cfg, state, dev, make_mesh(dp=world // tp, tp=tp))
        with torch.inference_mode():
            logits = model(ids)[0]
            _sync(dev)
            t0 = time.perf_counter()
            model(ids)
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
        toks = generate(model, ids, s["new"])
        out[f"tp{tp}"] = {"rel": _rel(logits, ref), "tokens_equal": bool(torch.equal(toks, want)),
                          "forward_ms": ms, "heads": model.local_heads}
        del model
    return out


def _bert_batches(s: dict, vocab: int) -> "list[dict]":
    import numpy as np

    rng = np.random.default_rng(9)
    out = []
    for _ in range(s["steps"]):
        lens = rng.integers(s["length"] // 8, s["length"] + 1, s["batch"])
        mask = (np.arange(s["length"])[None, :] < lens[:, None]).astype(np.int64)
        out.append({"input_ids": rng.integers(0, vocab, (s["batch"], s["length"])) * mask,
                    "attention_mask": mask, "labels": rng.integers(0, 2, s["batch"])})
    return out


def _count_all_reduces(model, batch, dev) -> int:
    """All-reduces one eager forward + backward of ``model`` runs."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    calls = [0]
    real = dist.all_reduce

    def counting(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    dist.all_reduce = counting
    try:
        inputs = {k: torch.as_tensor(v).to(dev) for k, v in batch.items() if k != "labels"}
        F.cross_entropy(model(**inputs), torch.as_tensor(batch["labels"]).to(dev)).backward()
    finally:
        dist.all_reduce = real
    model.zero_grad(set_to_none=True)
    return calls[0]


def check_bert(s: dict, dev) -> dict:
    import torch.distributed as dist

    from sparkdl_torch.models.bert import BertConfig, BertForSequenceClassification, init_bert_
    from sparkdl_torch.models.convert import shard_state_dict
    from sparkdl_torch.partition import SPMDPartitioner, SingleDevicePartitioner, make_mesh
    from sparkdl_torch.partition.rules import BERT_RULES
    from sparkdl_torch.runtime.dispatch import dispatch_count
    from sparkdl_torch.train import finetune_classifier

    world = dist.get_world_size()
    cfg = BertConfig.base(**s["bert"], attn_impl="flash")
    state = init_bert_(BertForSequenceClassification(cfg, device="cpu"), seed=0).state_dict()
    batches = _bert_batches(s, cfg.vocab_size)
    ref_model = BertForSequenceClassification(cfg, device=dev)
    ref_model.load_state_dict(state)
    _, hist = finetune_classifier(ref_model, batches, learning_rate=2e-5,
                                  partitioner=SingleDevicePartitioner(dev))
    out = {"one_card": [h["loss"] for h in hist],
           "one_card_step_ms": sorted(h["step_time_s"] for h in hist[1:])[
               (len(hist) - 1) // 2] * 1e3}
    for dp, tp in ((2, 2), (1, 4)):
        if dp * tp != world:
            continue
        mesh = make_mesh(dp=dp, tp=tp)
        model = BertForSequenceClassification(cfg, device=dev, mesh=mesh)
        model.load_state_dict(shard_state_dict(state, model, BERT_RULES))
        part = SPMDPartitioner(mesh, BERT_RULES)
        n = s["batch"] // dp
        i = part.data_index()
        local = [{k: v[i * n:(i + 1) * n] for k, v in b.items()} for b in batches]
        reduces = _count_all_reduces(model, local[0], dev)
        d0 = dispatch_count("train")
        _, hist = finetune_classifier(model, local, learning_rate=2e-5, partitioner=part)
        losses = [h["loss"] for h in hist]
        out[f"dp{dp}_tp{tp}"] = {
            "losses": losses,
            "rel": max(abs(a - b) / abs(b) for a, b in zip(losses, out["one_card"])),
            "step_ms": sorted(h["step_time_s"] for h in hist[1:])[(len(hist) - 1) // 2] * 1e3,
            "dispatches": int(dispatch_count("train") - d0),
            "tp_all_reduces": reduces}
        del model
    return out


def check_moe(s: dict, dev) -> dict:
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from sparkdl_torch.models.gpt import GPTLMHeadModel, generate, init_gpt_
    from sparkdl_torch.partition import make_mesh

    world = dist.get_world_size()
    cfg = dataclasses.replace(cs._moe_config(), **s["gpt"])
    state = init_gpt_(GPTLMHeadModel(cfg, device="cpu"), seed=0).state_dict()
    plain = _gpt(cfg, state, dev)
    ids = torch.randint(0, cfg.vocab_size, (s["rows"], s["length"]),
                        generator=torch.Generator().manual_seed(3)).to(dev)
    model = _gpt(cfg, state, dev, make_mesh(dp=1, ep=world))
    n = s["rows"] // world
    r = dist.get_rank()
    with torch.inference_mode():
        ref = plain(ids)[0]
        mine = model(ids[r * n:(r + 1) * n])[0].contiguous()
        logits = torch.empty_like(ref)
        dist.all_gather_into_tensor(logits, mine)
    want = generate(plain, ids, s["new"] // 2)
    toks = generate(model, ids, s["new"] // 2)
    return {"rel": _rel(logits, ref), "tokens_equal": bool(torch.equal(toks, want)),
            "local_experts": int(model.h[1].moe_mlp.wi.shape[0])}


def check_pipeline(s: dict, dev) -> dict:
    import torch
    import torch.distributed as dist
    from torch.func import functional_call

    from sparkdl_torch.models.gpt import GPTConfig, GPTLMHeadModel, init_gpt_
    from sparkdl_torch.parallel import pipeline_apply
    from sparkdl_torch.parallel.pipeline import stack_stage_params
    from sparkdl_torch.partition import make_mesh

    world = dist.get_world_size()
    cfg = GPTConfig(**s["gpt"])
    model = init_gpt_(GPTLMHeadModel(cfg, device="cpu"), seed=0).to(dev).eval()
    per = cfg.num_layers // world
    template = model.h[0]

    def stage(params, x):
        for j in range(per):
            x = functional_call(template, params[f"b{j}"], (x,))
        return x

    stages = [{f"b{j}": {k: v.detach() for k, v in
                         model.h[st * per + j].named_parameters()} for j in range(per)}
              for st in range(world)]
    x = torch.randn((16, s["length"], cfg.hidden_size),
                    generator=torch.Generator().manual_seed(4)).to(dev)
    with torch.inference_mode():
        want = x
        for blk in model.h:
            want = blk(want)
    with torch.no_grad():
        got = pipeline_apply(stage, stack_stage_params(stages), x, make_mesh(dp=1, pp=world),
                             num_microbatches=8)
    return {"rel": _rel(got, want), "stages": world, "blocks_a_stage": per}


# -- train steps over every mesh axis ------------------------------------------

STEP_LR = 1e-2  # plain SGD: the update is the gradient, so a wrongly summed
                # or divided gradient shows in the next step's loss
LABELS = 10


def _step_sizes(tiny: bool) -> dict:
    if tiny:
        return dict(vit=dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
                             num_heads=4, intermediate_size=64), rows=8, length=16,
                    steps=3, microbatches=2)
    return dict(vit={}, rows=32, length=128, steps=8, microbatches=8)


def _vit(cfg_kw: dict, dev, mesh=None, classes: int = 0):
    """ViT-B/16 (flash) features, with a LABELS-way head when ``classes``."""
    import torch

    from sparkdl_torch.models.vit import ViTConfig, ViTModel

    vit = ViTModel(ViTConfig(attn_impl="flash", **cfg_kw), include_top=False,
                   device=dev, mesh=mesh)
    if not classes:
        return vit

    class Classifier(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.vit = vit
            self.head = torch.nn.Linear(vit.config.hidden_size, classes, device=dev)

        def forward(self, pixel_values):
            return self.head(self.vit(pixel_values)[0])

    return Classifier()


def _gpt_classifier(cfg, dev, mesh=None, pipeline_mb: int = 0):
    """The GPT's logits at the last position over the first LABELS tokens:
    a classifier. ``pipeline_mb``: its blocks as pipeline_apply stages
    over the mesh's pp axis (their parameters stacked a stage a row), in
    that many microbatches."""
    import torch
    import torch.nn.functional as F
    from torch.func import functional_call

    from sparkdl_torch.models.gpt import GPTLMHeadModel
    from sparkdl_torch.parallel import pipeline_apply

    class Classifier(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.gpt = GPTLMHeadModel(cfg, device=dev, mesh=mesh)

        def forward(self, input_ids):
            return self.gpt(input_ids)[0][:, -1, :LABELS]

    class Pipelined(torch.nn.Module):
        def __init__(self):
            super().__init__()
            gpt = GPTLMHeadModel(cfg, device=dev)
            self.wte, self.wpe, self.ln_f = gpt.wte, gpt.wpe, gpt.ln_f
            self.pp = mesh.shape["pp"]
            self.per = cfg.num_layers // self.pp
            self.template = [gpt.h[0]]
            self.names = [n for n, _ in gpt.h[0].named_parameters()]
            self.stages = torch.nn.ParameterDict({
                f"b{j}_{i}": torch.nn.Parameter(torch.stack(
                    [gpt.h[st * self.per + j].get_parameter(n).detach()
                     for st in range(self.pp)]))
                for j in range(self.per) for i, n in enumerate(self.names)})

        def from_whole(self, state: dict) -> dict:
            out = {k[4:]: v for k, v in state.items()
                   if k.split(".")[1] in ("wte", "wpe", "ln_f")}
            for j in range(self.per):
                for i, n in enumerate(self.names):
                    out[f"stages.b{j}_{i}"] = torch.stack(
                        [state[f"gpt.h.{st * self.per + j}.{n}"] for st in range(self.pp)])
            return out

        def stage(self, params, x):
            for j in range(self.per):
                x = functional_call(self.template[0], {
                    n: params[f"b{j}_{i}"] for i, n in enumerate(self.names)}, (x,))
            return x

        def forward(self, input_ids):
            pos = torch.arange(input_ids.shape[1], device=input_ids.device)
            x = self.wte(input_ids) + self.wpe(pos)
            x = pipeline_apply(self.stage, dict(self.stages), x, mesh,
                               num_microbatches=pipeline_mb)
            return F.linear(self.ln_f(x), self.wte.weight).float()[:, -1, :LABELS]

    return Pipelined() if pipeline_mb else Classifier()


_COLLECTIVES = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
                "all_to_all_single", "broadcast", "send", "recv", "batch_isend_irecv")


def _collectives_a_step(model, part, batch, dev) -> int:
    """The collectives one step runs: an eager forward and backward,
    counted, plus the optimizer's (its flat all-reduces, and per shard
    bucket a reduce-scatter unless its ranks hold the whole gradient, an
    all-reduce over the rest, an all-gather) and the metrics' all-reduce.
    Run it after the model's graphed steps, not before: an MoE block keeps
    its last forward's losses, and so that forward's gradient-accumulation
    nodes, on this (default) stream, and a step captured after it on
    another stream would wait on this one, which breaks the capture."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    calls = [0]
    real = {n: getattr(dist, n) for n in _COLLECTIVES}

    def counting(fn):
        def wrapped(*a, **kw):
            calls[0] += 1
            return fn(*a, **kw)
        return wrapped

    for n, fn in real.items():
        setattr(dist, n, counting(fn))
    try:
        inputs = {k: torch.as_tensor(v).to(dev) for k, v in batch.items() if k != "labels"}
        F.cross_entropy(model(**inputs).float(),
                        torch.as_tensor(batch["labels"]).to(dev)).backward()
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)
    model.zero_grad(set_to_none=True)
    opt = part.shard_opt_state(torch.optim.SGD(model.parameters(), lr=0.0), model)
    n = calls[0] + sum(g is not None for g, *_ in opt._grad_flats)
    for b in opt._buckets:
        n += (0 if b.copy else 1) + (b.rest_group is not None) + 1
    return n + (part._data_group() is not None and part.grad_terms > 1)


def _flash_launches() -> "tuple[int, int, int]":
    from sparkdl_torch.ops.flash_attention import flash_attention, flash_attention_bwd

    return (flash_attention.launches, flash_attention_bwd.launches_dq,
            flash_attention_bwd.launches_dkv)


def _run_steps(model, batches, part) -> dict:
    """finetune_classifier's losses, median step ms, train dispatches and
    this rank's flash forward / dq / dkv launches over the run (graph
    replays included)."""
    import torch

    from sparkdl_torch.runtime.dispatch import dispatch_count
    from sparkdl_torch.train import finetune_classifier

    d0, l0 = dispatch_count("train"), _flash_launches()
    _, hist = finetune_classifier(model, batches, partitioner=part,
                                  optimizer=torch.optim.SGD(model.parameters(), lr=STEP_LR))
    return {"losses": [h["loss"] for h in hist],
            "step_ms": sorted(h["step_time_s"] for h in hist[1:])[(len(hist) - 1) // 2] * 1e3,
            "dispatches": int(dispatch_count("train") - d0),
            "launches": [b - a for a, b in zip(l0, _flash_launches())]}


def _rows(batches: "list[dict]", part) -> "list[dict]":
    n = len(batches[0]["labels"]) // part.data_axis_size
    i = part.data_index()
    return [{k: v[i * n:(i + 1) * n] for k, v in b.items()} for b in batches]


def _held(got: dict, want: "list[float]", collectives: int) -> dict:
    got["rel"] = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want))
    got["collectives"] = collectives
    return got


def _case(out: dict, key: str, fn) -> None:
    """``out[key] = fn()``, printed by rank 0 as it lands (a later case
    that fails or hangs keeps the earlier ones visible); an error is kept
    as ``{"error": ...}`` and the cases after it still run."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    try:
        out[key] = fn()
    except Exception as e:  # reported with the other checks' failures
        out[key] = {"error": f"{type(e).__name__}: {e}"[:600]}
    out[key]["seconds"] = time.perf_counter() - t0
    if dist.get_rank() == 0:
        print(f"[parallel4] step case {key}: {out[key]}", flush=True)


def check_steps(s: dict, dev, tiny: bool = False) -> dict:
    """The (b) cases against one card's losses (every rank computes those
    itself): ViT's forward at tp 2 and 4; ViT-B/16 and BERT-base at
    fsdp=2 x tp=2 through their rule tables; BERT-base's ring at
    dp=2 x sp=2; the MoE classifier at ep=4; GPT-2 small's 12 blocks as 4
    pipeline stages."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from sparkdl_torch.models.bert import (
        BertConfig,
        BertForSequenceClassification,
        init_bert_,
    )
    from sparkdl_torch.models.convert import shard_state_dict
    from sparkdl_torch.models.gpt import GPTConfig, init_gpt_
    from sparkdl_torch.models.vit import init_vit_
    from sparkdl_torch.partition import (
        DataParallelPartitioner,
        PartitionSpec as P,
        SingleDevicePartitioner,
        SPMDPartitioner,
        make_mesh,
    )
    from sparkdl_torch.partition.rules import BERT_RULES, GPT_RULES, VIT_RULES

    world = dist.get_world_size()
    st = _step_sizes(tiny)
    one_card = SingleDevicePartitioner(dev)
    rng = np.random.default_rng(10)
    out = {}

    # ViT-B/16: the forward at tp 2 and 4, then fine-tuning at fsdp=2 x tp=2
    vit_cfg = dict(st["vit"])
    whole = _vit(vit_cfg, "cpu", classes=LABELS)
    init_vit_(whole.vit, 0)
    vstate = whole.state_dict()
    size = whole.vit.config.image_size
    x = torch.from_numpy(rng.standard_normal((8, size, size, 3)).astype(np.float32)).to(dev)
    ref = _vit(vit_cfg, dev)
    ref.load_state_dict({k[4:]: v for k, v in vstate.items() if k.startswith("vit.")})
    with torch.inference_mode():
        want = ref(x)[0]
    for tp in (2, 4):
        if world % tp:
            continue
        m = _vit(vit_cfg, dev, make_mesh(dp=world // tp, tp=tp))
        m.load_state_dict(shard_state_dict(
            {k[4:]: v for k, v in vstate.items() if k.startswith("vit.")}, m, VIT_RULES))
        with torch.inference_mode():
            l0 = _flash_launches()[0]
            got = m(x)[0]
            out[f"vit_tp{tp}"] = {"rel": _rel(got, want),
                                  "launches": _flash_launches()[0] - l0}
        del m
    images = [{"pixel_values": rng.standard_normal((st["rows"], size, size, 3))
               .astype(np.float32), "labels": rng.integers(0, LABELS, st["rows"])}
              for _ in range(st["steps"])]
    m = _vit(vit_cfg, dev, classes=LABELS)
    m.load_state_dict(vstate)
    vit_one = _run_steps(m, images, one_card)["losses"]
    del m

    # BERT-base
    bcfg = BertConfig.base(**s["bert"], attn_impl="flash")
    bstate = init_bert_(BertForSequenceClassification(bcfg, device="cpu"), seed=0).state_dict()
    texts = _bert_batches(dict(s, batch=st["rows"], steps=st["steps"],
                               length=st["length"]), bcfg.vocab_size)
    m = BertForSequenceClassification(dataclasses.replace(bcfg, attn_impl="full"), device=dev)
    m.load_state_dict(bstate)
    bert_full = _run_steps(m, texts, one_card)["losses"]
    m = BertForSequenceClassification(bcfg, device=dev)
    m.load_state_dict(bstate)
    bert_one = _run_steps(m, texts, one_card)["losses"]
    del m

    def spmd(build, state, rules, batches, want):
        mesh = make_mesh(dp=1, fsdp=2, tp=2)
        m = build(mesh)
        m.load_state_dict(shard_state_dict(state, m, rules))
        part = SPMDPartitioner(mesh, rules)
        local = _rows(batches, part)
        got = _run_steps(m, local, part)
        return _held(got, want, _collectives_a_step(m, part, local[0], dev))

    def ring():
        # each data shard's rows, each sp peer its block of their tokens
        mesh = make_mesh(dp=2, sp=2)
        m = BertForSequenceClassification(dataclasses.replace(bcfg, attn_impl="ring"),
                                          device=dev, mesh=mesh)
        m.load_state_dict(bstate)
        part = DataParallelPartitioner(mesh)
        c, n_tok = mesh.coordinate("sp"), st["length"] // 2
        local = [{k: v if k == "labels" else v[:, c * n_tok:(c + 1) * n_tok]
                  for k, v in b.items()} for b in _rows(texts, part)]
        got = _run_steps(m, local, part)
        return _held(got, bert_full, _collectives_a_step(m, part, local[0], dev))

    if world == 4:
        _case(out, "vit_fsdp2_tp2", lambda: spmd(
            lambda mesh: _vit(vit_cfg, dev, mesh, LABELS), vstate, VIT_RULES, images,
            vit_one))
        _case(out, "bert_fsdp2_tp2", lambda: spmd(
            lambda mesh: BertForSequenceClassification(bcfg, device=dev, mesh=mesh),
            bstate, BERT_RULES, texts, bert_one))
        _case(out, "bert_ring_dp2_sp2", ring)

    # the MoE classifier at ep = world, and GPT-2 small's blocks as stages
    mcfg = dataclasses.replace(cs._moe_config(), **s["gpt"])
    gcfg = GPTConfig(positions="learned", attn_impl="flash", **s["gpt"])
    tokens = [{"input_ids": rng.integers(0, gcfg.vocab_size, (st["rows"], st["length"])),
               "labels": rng.integers(0, LABELS, st["rows"])} for _ in range(st["steps"])]
    def gpt_case(key, cfg):
        whole = _gpt_classifier(cfg, "cpu")
        init_gpt_(whole.gpt, seed=0)
        state = whole.state_dict()
        m = _gpt_classifier(cfg, dev)
        m.load_state_dict(state)
        want = _run_steps(m, tokens, one_card)["losses"]
        if key == "moe_ep":
            mesh = make_mesh(dp=1, ep=world)
            m = _gpt_classifier(cfg, dev, mesh)
            m.load_state_dict(shard_state_dict(state, m, GPT_RULES))
            part = SPMDPartitioner(mesh, GPT_RULES, batch_axes=("dp", "fsdp", "ep"))
            local = _rows(tokens, part)
            got = {"local_experts": int(m.gpt.h[1].moe_mlp.wi.shape[0])}
        else:
            mesh = make_mesh(dp=1, pp=world)
            m = _gpt_classifier(cfg, dev, mesh, pipeline_mb=st["microbatches"])
            m.load_state_dict(m.from_whole(state))
            part = SPMDPartitioner(mesh, ((r"^stages\.", P("pp")), (r".*", P())))
            local = tokens
            got = {"blocks_a_stage": m.per}
        got.update(_run_steps(m, local, part))
        return _held(got, want, _collectives_a_step(m, part, local[0], dev))

    _case(out, "pipeline_pp", lambda: gpt_case("pipeline_pp", gcfg))
    _case(out, "moe_ep", lambda: gpt_case("moe_ep", mcfg))
    return out


def probe_worker(tiny: bool = False) -> dict:
    """Rank body: every check, in order."""
    s = sizes(tiny)
    dev = _device()
    out = {}
    for name, fn in (("sp_prefill", check_sp_prefill), ("tp", check_tp), ("bert", check_bert),
                     ("moe", check_moe), ("pipeline", check_pipeline)):
        t0 = time.perf_counter()
        out[name] = fn(s, dev)
        out[name + "_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["steps"] = check_steps(s, dev, tiny)
    out["steps_s"] = time.perf_counter() - t0
    return out


def run_checks(card: str, np: int = 4, platform: str = "cuda", tiny: bool = False) -> bool:
    """Run :func:`probe_worker` on ``np`` ranks and print its lines;
    returns whether every check passed (raises with the failures)."""
    from sparkdl_torch import TorchRunner

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import parallel4_probe as this  # by reference: each rank imports it

    t0 = time.perf_counter()
    r = TorchRunner(np=-np, local_platform=platform, timeout_s=900).run(
        this.probe_worker, tiny=tiny)
    fails = []
    for key, m in r["sp_prefill"].items():
        # ring and all-gather alike: bitwise is measured, not promised
        # (ROADMAP C15), so both are held within TOL and bitwise is reported
        fails += [] if m["rel"] <= TOL and m["tokens_equal"] else [f"sp_prefill {key}"]
        print(f"[parallel4] {card}: sp_prefill {key}: logits rel {m['rel']:.3e} (tol {TOL}), "
              f"bitwise the 'full' forward {m['bitwise']} (max diff {m['max_diff']:.3e}), "
              f"argmax equal {m['argmax_equal']}, greedy tokens equal to "
              f"plain generate {m['tokens_equal']}, prefill {m['ms']:.1f} ms host wall")
    for key, m in r["tp"].items():
        fails += [] if m["rel"] <= TOL and m["tokens_equal"] else [f"GPT {key}"]
        print(f"[parallel4] {card}: GPT-2 small {key} ({m['heads']} heads a rank, flash): "
              f"logits rel {m['rel']:.3e} (tol {TOL}), greedy tokens equal {m['tokens_equal']}, "
              f"forward {m['forward_ms']:.2f} ms host wall")
    b = r["bert"]
    for key in [k for k in b if k.startswith("dp")]:
        m = b[key]
        fails += [] if m["rel"] <= LOSS_TOL else [f"BERT {key}"]
        print(f"[parallel4] {card}: BERT-base fine-tune {key} (SPMDPartitioner(BERT_RULES), "
              f"flash): losses {[round(x, 6) for x in m['losses']]}, one card "
              f"{[round(x, 6) for x in b['one_card']]}, max rel {m['rel']:.3e} (tol {LOSS_TOL}); "
              f"step {m['step_ms']:.2f} ms median (one card {b['one_card_step_ms']:.2f}), "
              f"{m['dispatches']} train dispatches, {m['tp_all_reduces']} all-reduces in a "
              "step's forward and backward")
    m = r["moe"]
    fails += [] if m["rel"] <= TOL and m["tokens_equal"] else ["MoE ep"]
    print(f"[parallel4] {card}: MoE GPT-2 small at ep={np} ({m['local_experts']} experts a "
          f"rank): logits rel {m['rel']:.3e} (tol {TOL}), greedy tokens equal "
          f"{m['tokens_equal']}")
    m = r["pipeline"]
    fails += [] if m["rel"] <= PIPE_TOL else ["pipeline"]
    print(f"[parallel4] {card}: pipeline_apply pp={m['stages']} ({m['blocks_a_stage']} GPT-2 "
          f"blocks a stage, 8 microbatches): rel {m['rel']:.3e} of the sequential blocks "
          f"(tol {PIPE_TOL})")
    for key, m in r["steps"].items():
        if key.startswith("vit_tp"):
            fails += [] if m["rel"] <= TOL else [f"ViT {key}"]
            print(f"[parallel4] {card}: ViT-B/16 features {key} (flash): rel {m['rel']:.3e} "
                  f"of one card's (tol {TOL}); {m['launches']} flash forward launches a "
                  "rank")
            continue
        if "error" in m:
            fails.append(f"step {key}")
            print(f"[parallel4] {card}: train step {key} FAILED: {m['error']}")
            continue
        fails += [] if m["rel"] <= LOSS_TOL else [f"step {key}"]
        extra = "".join(f", {k.replace('_', ' ')} {m[k]}" for k in ("local_experts",
                                                                     "blocks_a_stage")
                        if k in m)
        print(f"[parallel4] {card}: train step {key} (SGD lr {STEP_LR}{extra}): losses "
              f"{[round(x, 6) for x in m['losses']]}, max rel {m['rel']:.3e} of one card's "
              f"(tol {LOSS_TOL}); step {m['step_ms']:.2f} ms median, {m['dispatches']} "
              f"train dispatches, {m['collectives']} collectives a step; flash forward/dq/"
              f"dkv launches a rank over the run {m['launches']}")
    print(f"[parallel4] seconds per check: " + ", ".join(
        f"{k[:-2]} {v:.1f}" for k, v in r.items() if k.endswith("_s"))
          + f"; {time.perf_counter() - t0:.1f} s for the job")
    if fails:
        raise AssertionError("[parallel4] failed: " + ", ".join(fails))
    return True


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--np", type=int, default=4)
    ap.add_argument("--only-sp", action="store_true",
                    help="only the continuous engine's sp section (cards)")
    args = ap.parse_args()
    t0 = time.time()
    if args.platform == "cuda":
        import chip_smoke as cs

        card = cs.phase_card()
        if not args.only_sp:
            cs.phase_build()
    else:
        card = "cpu (gloo)"
    try:
        if not args.only_sp:
            run_checks(card, np=args.np, platform=args.platform, tiny=args.tiny)
    finally:
        if args.platform == "cuda":  # over every card, in this process
            if not args.only_sp:
                cs.phase_dp(card, {})
            cs.phase_sp_serve(card, sps=tuple(n for n in (2, 4) if n <= args.np),
                              cards=True)
        print("probe seconds", round(time.time() - t0, 1))
