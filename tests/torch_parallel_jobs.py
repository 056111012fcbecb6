"""Rank bodies for the multi-process tests of ``sparkdl_torch.parallel``
and the models and partitioner that use it (``TorchRunner`` jobs over
gloo).

Like ``tests/torch_dist_jobs.py``, kept apart from the test files so a
worker imports numpy, torch and ``sparkdl_torch`` only, never jax or
``sparkdl_tpu``. The test process computes the JAX side and passes its
inputs and weights in as numpy arrays; one job per world size runs every
check and returns rank 0's view, each rank's local results gathered.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _t(a):
    import torch

    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _gathered(x):
    """Every rank's ``x`` (any picklable value), in rank order."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, x)
    return out


def _mesh(**axes):
    from sparkdl_torch.partition import make_mesh

    return make_mesh(**axes)


# -- collectives ----------------------------------------------------------------

def collectives_checks(inp: dict) -> dict:
    """The reference's collective tests, at this world size: each rank
    feeds its own row of ``per_rank`` (or the replicated ``g``)."""
    import torch
    import torch.distributed as dist

    from sparkdl_torch.parallel import (
        all_gather_params,
        cross_replica_mean,
        psum_grads,
        reduce_scatter_grads,
    )
    from sparkdl_torch.parallel.collectives import global_norm

    rank, world = dist.get_rank(), dist.get_world_size()
    dp = _mesh(dp=world)
    fsdp = _mesh(dp=1, fsdp=world)
    mine = _t(inp["per_rank"][rank])
    g = _t(inp["g"])
    tree = {"w": g, "b": torch.arange(3.0)}
    shard = reduce_scatter_grads(tree, "fsdp", mesh=fsdp)
    back = all_gather_params(shard, "fsdp", mesh=fsdp,
                             full_shapes={"w": g.shape, "b": (3,)})
    x = mine.clone().requires_grad_(True)
    summed = psum_grads({"g": x}, "dp", mesh=dp)["g"]
    summed.sum().backward()
    return {
        "mean": _gathered(_np(cross_replica_mean({"g": mine}, "dp", mesh=dp)["g"])),
        "psum": _np(summed),
        "psum_grad": _np(x.grad),
        "norm": float(global_norm({"g": mine}, "dp", mesh=dp)),
        "rs_shard": _gathered(_np(shard["w"])),
        "rs_bias": _np(shard["b"]),
        "roundtrip_w": _np(back["w"]),
        "roundtrip_b": _np(back["b"]),
        "unsharded_gather": tuple(all_gather_params(
            {"w": _t(inp["g"][:2])}, "fsdp", mesh=fsdp)["w"].shape),
    }


# -- ring and all-gather attention ------------------------------------------------

def attention_checks(inp: dict) -> dict:
    """ring_attention on the global tensors (causal and not, with and
    without a key mask, and the causal gradients), and the local
    all-gather schedule against the one-rank dense path, bitwise."""
    import torch
    import torch.distributed as dist

    from sparkdl_torch.parallel import ring_attention
    from sparkdl_torch.parallel.ring_attention import allgather_self_attention
    from sparkdl_torch.runtime.mesh import single_device_mesh

    world = dist.get_world_size()
    mesh = _mesh(dp=1, sp=world)
    q, k, v = (_t(inp[n]) for n in "qkv")
    mask = _t(inp["mask"])
    out = {}
    for causal in (False, True):
        out[f"ring_causal{int(causal)}"] = _np(ring_attention(q, k, v, mesh, causal=causal))
        out[f"ring_mask_causal{int(causal)}"] = _np(
            ring_attention(q, k, v, mesh, kv_mask=mask, causal=causal))
        # the all-gather schedule on this rank's shard, and the whole
        # sequence on one rank: the same operations on the same rows
        n = q.shape[1] // world
        sl = slice(dist.get_rank() * n, (dist.get_rank() + 1) * n)
        local = allgather_self_attention(q[:, sl], k[:, sl], v[:, sl], mask[:, sl],
                                         causal=causal, mesh=mesh)
        whole = allgather_self_attention(q, k, v, mask, causal=causal,
                                         mesh=single_device_mesh())
        out[f"allgather_causal{int(causal)}"] = np.concatenate(
            _gathered(_np(local)), axis=1)
        out[f"allgather_bitwise_causal{int(causal)}"] = all(
            _gathered(bool(torch.equal(local, whole[:, sl]))))
    gq, gk, gv = (_t(inp[n]).requires_grad_(True) for n in ("gq", "gk", "gv"))
    (ring_attention(gq, gk, gv, mesh, causal=True) ** 2).sum().backward()
    out["grads"] = [_np(t.grad) for t in (gq, gk, gv)]
    every = _gathered(out["grads"])
    out["grads_same_on_every_rank"] = all(
        np.array_equal(a, b) for r in every for a, b in zip(r, every[0]))
    return out


# -- tensor parallel ----------------------------------------------------------------

def tp_mlp_check(inp: dict) -> dict:
    """TPMlpBlock over a tp axis of the whole world, loaded with this
    rank's slices of the whole weights: output, and the gradients of
    sum(y**2) (the slices gathered back whole) and of x."""
    import torch
    import torch.distributed as dist

    from sparkdl_torch.models.convert import shard_state_dict
    from sparkdl_torch.parallel import TPMlpBlock

    world = dist.get_world_size()
    w = inp["weights"]
    blk = TPMlpBlock(w["up.weight"].shape[1], w["up.weight"].shape[0],
                     w["down.weight"].shape[0], mesh=_mesh(dp=1, tp=world), device="cpu")
    blk.load_state_dict(shard_state_dict({k: _t(a) for k, a in w.items()}, blk))
    x = _t(inp["x"]).requires_grad_(True)
    y = blk(x)
    (y ** 2).sum().backward()
    grads = {}
    for name, p in blk.named_parameters():
        parts = _gathered(_np(p.grad))
        dim = {"up.weight": 0, "up.bias": 0, "down.weight": 1}.get(name)
        grads[name] = parts[0] if dim is None else np.concatenate(parts, axis=dim)
    return {"y": _np(y), "grads": grads, "x_grad": _np(x.grad),
            "local_shapes": {n: tuple(p.shape) for n, p in blk.named_parameters()}}


# -- experts ----------------------------------------------------------------------

def moe_block_check(inp: dict) -> dict:
    """MoEMlpBlock over an ep axis of the whole world: each rank feeds its
    own groups of the input and holds its experts; outputs and aux losses
    gathered, and the gradients of sum(y**2) summed over the ranks (the
    router's) or gathered whole (the experts')."""
    import torch
    import torch.distributed as dist

    from sparkdl_torch.models.convert import shard_state_dict
    from sparkdl_torch.parallel import MoEMlpBlock, moe_aux_losses

    rank, world = dist.get_rank(), dist.get_world_size()
    w = inp["weights"]
    e, m, h = w["wi"].shape
    blk = MoEMlpBlock(m, e, h, k=inp["k"], capacity_factor=inp["cf"],
                      mesh=_mesh(dp=1, ep=world), device="cpu")
    blk.load_state_dict(shard_state_dict({k: _t(a) for k, a in w.items()}, blk))
    x = _t(inp["x"])
    n = x.shape[0] // world
    y = blk(x[rank * n:(rank + 1) * n])
    losses = moe_aux_losses(blk)
    (y ** 2).sum().backward()
    router = blk.router.weight.grad.clone()
    dist.all_reduce(router)
    return {"y": np.concatenate(_gathered(_np(y))),
            "aux_loss": float(np.mean(_gathered(float(losses["aux_loss"])))),
            "router_z_loss": float(np.mean(_gathered(float(losses["router_z_loss"])))),
            "grads": {"router.weight": _np(router),
                      "wi": np.concatenate(_gathered(_np(blk.wi.grad))),
                      "wo": np.concatenate(_gathered(_np(blk.wo.grad)))},
            "local_experts": int(blk.wi.shape[0])}


# -- pipeline -----------------------------------------------------------------------

def _stage(params, x):
    import torch

    return torch.tanh(x @ params["w"] + params["b"])


def pipeline_check(inp: dict) -> dict:
    """pipeline_apply over a pp axis of the whole world, and the gradients
    of sum(out**2) for the stacked params and the input."""
    import torch.distributed as dist

    from sparkdl_torch.parallel import pipeline_apply

    world = dist.get_world_size()
    mesh = _mesh(dp=1, pp=world)
    stacked = {"w": _t(inp["w"]).requires_grad_(True),
               "b": _t(inp["b"]).requires_grad_(True)}
    x = _t(inp["x"]).requires_grad_(True)
    out = pipeline_apply(_stage, stacked, x, mesh, num_microbatches=inp["num_mb"])
    (out ** 2).sum().backward()
    try:
        pipeline_apply(_stage, stacked, x[:-1], mesh, num_microbatches=inp["num_mb"])
        bad = None
    except ValueError as err:
        bad = str(err)
    return {"out": _np(out), "grad_w": _np(stacked["w"].grad),
            "grad_b": _np(stacked["b"].grad), "grad_x": _np(x.grad),
            "bad_microbatches": bad}


# -- GPT ----------------------------------------------------------------------------

def _gpt(cfg_kw: dict, state: dict, mesh=None, **over):
    from sparkdl_torch.models.convert import shard_state_dict
    from sparkdl_torch.models.gpt import GPTConfig, GPTLMHeadModel
    from sparkdl_torch.partition.rules import GPT_RULES

    model = GPTLMHeadModel(GPTConfig.tiny(**{**cfg_kw, **over}), device="cpu",
                           mesh=mesh)
    model.load_state_dict(shard_state_dict({k: _t(a) for k, a in state.items()},
                                           model, GPT_RULES))
    return model.eval()


def gpt_ring_check(inp: dict) -> dict:
    """The uncached ring forward of each sp_mode: this rank's token shard
    (global positions by default), logits gathered."""
    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = _mesh(dp=1, sp=world)
    ids = _t(inp["ids"]).long()
    n = ids.shape[1] // world
    out = {}
    with torch.no_grad():
        full = _gpt(inp["cfg"], inp["state"])(ids)[0]
        for mode in ("ring", "allgather"):
            model = _gpt(inp["cfg"], inp["state"], mesh, attn_impl="ring", sp_mode=mode)
            logits = model(ids[:, rank * n:(rank + 1) * n])[0]
            out[mode] = np.concatenate(_gathered(_np(logits)), axis=1)
            out[mode + "_bitwise_full"] = all(_gathered(bool(torch.equal(
                logits, full[:, rank * n:(rank + 1) * n]))))
    return out


def sp_prefill_check(inp: dict) -> dict:
    """sp_prefill of an sp-divisible prompt and of a remainder prompt
    under each sp_mode, then greedy tokens from its cache."""
    import torch
    import torch.distributed as dist

    from sparkdl_torch.models.gpt import generate, generate_from_cache, sp_prefill

    mesh = _mesh(dp=1, sp=dist.get_world_size())
    plain = _gpt(inp["cfg"], inp["state"])
    out = {}
    for key in ("even", "odd"):
        ids = _t(inp[key]).long()
        with torch.no_grad():
            full = plain(ids)[0]
        want = generate(plain, ids, inp["new_tokens"])[:, ids.shape[1]:]
        for mode in ("ring", "allgather"):
            model = _gpt(inp["cfg"], inp["state"], mesh, attn_impl="ring", sp_mode=mode)
            logits, cache = sp_prefill(model, ids)
            toks = generate_from_cache(model, logits, cache, inp["new_tokens"])
            out[f"{key}_{mode}"] = {
                "logits": _np(logits), "k": _np(cache["k"]), "v": _np(cache["v"]),
                "idx": cache["idx"], "tokens": _np(toks),
                "tokens_equal_generate": bool(torch.equal(toks, want)),
                "bitwise_full": bool(torch.equal(logits, full)),
            }
    return out


def gpt_tp_check(inp: dict) -> dict:
    """GPT over a tp axis of the whole world (heads split): logits and
    greedy tokens, and the KV cache's heads per rank."""
    import torch
    import torch.distributed as dist

    from sparkdl_torch.models.gpt import generate

    world = dist.get_world_size()
    model = _gpt(inp["cfg"], inp["state"], _mesh(dp=1, tp=world))
    ids = _t(inp["ids"]).long()
    with torch.no_grad():
        logits = model(ids)[0]
    toks = generate(model, ids[:, :4], inp["new_tokens"])
    return {"logits": _np(logits), "tokens": _np(toks),
            "local_heads": model.local_heads,
            "q_rows": int(model.h[0].attn.q_proj.weight.shape[0])}


def moe_gpt_check(inp: dict) -> dict:
    """The MoE GPT over an ep axis of the whole world: each rank's batch
    rows through the forward (logits gathered), and greedy generation of
    the same prompts on every rank."""
    import torch
    import torch.distributed as dist

    from sparkdl_torch.models.gpt import generate

    rank, world = dist.get_rank(), dist.get_world_size()
    model = _gpt(inp["cfg"], inp["state"], _mesh(dp=1, ep=world))
    ids = _t(inp["ids"]).long()
    n = ids.shape[0] // world
    with torch.no_grad():
        logits = model(ids[rank * n:(rank + 1) * n])[0]
    toks = generate(model, ids[:, :4], inp["new_tokens"])
    return {"logits": np.concatenate(_gathered(_np(logits))), "tokens": _np(toks),
            "local_experts": int(model.h[1].moe_mlp.wi.shape[0])}


# -- BERT ---------------------------------------------------------------------------

def bert_ring_check(inp: dict) -> dict:
    """BertModel with attn_impl='ring' over sp = the whole world: this
    rank's token shard with its key mask, global positions by default."""
    import torch
    import torch.distributed as dist

    from sparkdl_torch.models.bert import BertConfig, BertModel

    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = dataclasses.replace(BertConfig(**inp["cfg"]), attn_impl="ring")
    model = BertModel(cfg, device="cpu", mesh=_mesh(dp=1, sp=world))
    model.load_state_dict({k: _t(a) for k, a in inp["state"].items()})
    ids, mask = _t(inp["ids"]).long(), _t(inp["mask"]).long()
    n = ids.shape[1] // world
    sl = slice(rank * n, (rank + 1) * n)
    with torch.no_grad():
        seq = model(ids[:, sl], mask[:, sl])[0]
    return {"seq": np.concatenate(_gathered(_np(seq)), axis=1)}


def finetune_tp_check(inp: dict, dp: int, tp: int) -> dict:
    """finetune_classifier over tiny BERT on a dp x tp mesh through
    SPMDPartitioner(BERT_RULES): each data shard's rows, the losses, and
    the all-reduces a step's tensor-parallel layers run."""
    import torch.distributed as dist

    import torch_dist_jobs as jobs
    from sparkdl_torch.models.bert import BertConfig, BertForSequenceClassification
    from sparkdl_torch.models.convert import shard_state_dict
    from sparkdl_torch.partition import SPMDPartitioner
    from sparkdl_torch.partition.rules import BERT_RULES
    from sparkdl_torch.train import finetune_classifier

    mesh = _mesh(dp=dp, tp=tp)
    model = BertForSequenceClassification(BertConfig.tiny(vocab_size=jobs.VOCAB),
                                          device="cpu", mesh=mesh)
    model.load_state_dict(shard_state_dict(
        {k: _t(a) for k, a in inp["state"].items()}, model, BERT_RULES))
    part = SPMDPartitioner(mesh, BERT_RULES)
    _, hist = finetune_classifier(
        model, jobs.local_shard(jobs.toy_batches(), part.data_index(), dp),
        learning_rate=1e-3, partitioner=part)
    return {"losses": [h["loss"] for h in hist],
            "rank_losses_equal": len({tuple(h) for h in _gathered(
                [x["loss"] for x in hist])}) == 1,
            "world": dist.get_world_size()}


# -- train steps over every mesh axis ------------------------------------------------

LABELS = 4  # the image and GPT classifiers' classes
STEP_BATCH = 16  # the global batch of those steps
STEP_LR = 0.1  # their SGD learning rate


def vit_classifier(mesh=None):
    """Tiny ViT features (no top) under ``mesh`` with a ``LABELS``-way
    linear head: ``model(pixel_values) -> logits``."""
    import torch

    from sparkdl_torch.models.vit import ViTConfig, ViTModel

    class _ViTClassifier(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.vit = ViTModel(ViTConfig.tiny(), include_top=False, mesh=mesh)
            self.head = torch.nn.Linear(32, LABELS)

        def forward(self, pixel_values):
            return self.head(self.vit(pixel_values)[0])

    return _ViTClassifier()


def vit_batches(steps: int = 3, seed: int = 5) -> "list[dict]":
    """Global batches of random 32x32 images and labels."""
    r = np.random.default_rng(seed)
    return [{"pixel_values": r.standard_normal((STEP_BATCH, 32, 32, 3)).astype(np.float32),
             "labels": r.integers(0, LABELS, STEP_BATCH).astype(np.int64)}
            for _ in range(steps)]


def gpt_classifier(cfg_kw: dict, mesh=None, pipeline: bool = False):
    """A tiny GPT (``GPTConfig.tiny(**cfg_kw)``, learned positions) as a
    classifier: its logits at the last position, over the first
    ``LABELS`` tokens of the vocabulary. ``pipeline``: its blocks run as
    ``pipeline_apply`` stages over the ``pp`` axis of ``mesh``, their
    parameters stacked one stage a row (``stages.b{j}_{i}``: the i-th
    parameter of a stage's j-th block)."""
    import torch
    import torch.nn.functional as F
    from torch.func import functional_call

    from sparkdl_torch.models.gpt import GPTConfig, GPTLMHeadModel
    from sparkdl_torch.parallel import pipeline_apply

    cfg = GPTConfig.tiny(positions="learned", **cfg_kw)

    class _Classifier(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.gpt = GPTLMHeadModel(cfg, device="cpu", mesh=mesh)

        def forward(self, input_ids):
            return self.gpt(input_ids)[0][:, -1, :LABELS]

    class _Pipelined(torch.nn.Module):
        def __init__(self):
            super().__init__()
            gpt = GPTLMHeadModel(cfg, device="cpu")
            self.wte, self.wpe, self.ln_f = gpt.wte, gpt.wpe, gpt.ln_f
            pp = mesh.shape["pp"]
            self.per = cfg.num_layers // pp
            self.template = [gpt.h[0]]  # its structure only
            self.names = [n for n, _ in gpt.h[0].named_parameters()]
            self.stages = torch.nn.ParameterDict({
                f"b{j}_{i}": torch.nn.Parameter(torch.stack(
                    [gpt.h[st * self.per + j].get_parameter(n).detach()
                     for st in range(pp)]))
                for j in range(self.per) for i, n in enumerate(self.names)})

        def from_whole(self, state: dict) -> dict:
            """The :func:`gpt_classifier` state dict ``state`` in this
            form: each block parameter stacked over the stages."""
            out = {k[4:]: v for k, v in state.items()
                   if k.split(".")[1] in ("wte", "wpe", "ln_f")}
            for j in range(self.per):
                for i, n in enumerate(self.names):
                    out[f"stages.b{j}_{i}"] = torch.stack(
                        [state[f"gpt.h.{st * self.per + j}.{n}"]
                         for st in range(mesh.shape["pp"])])
            return out

        def stage(self, params, x):
            for j in range(self.per):
                x = functional_call(self.template[0], {
                    n: params[f"b{j}_{i}"] for i, n in enumerate(self.names)}, (x,))
            return x

        def forward(self, input_ids):
            l = input_ids.shape[1]
            x = self.wte(input_ids) + self.wpe(torch.arange(l, device=input_ids.device))
            x = pipeline_apply(self.stage, dict(self.stages), x, mesh,
                               num_microbatches=2)
            return F.linear(self.ln_f(x), self.wte.weight).float()[:, -1, :LABELS]

    return _Pipelined() if pipeline else _Classifier()


def gpt_batches(vocab: int = 128, steps: int = 3, seed: int = 6) -> "list[dict]":
    r = np.random.default_rng(seed)
    return [{"input_ids": r.integers(0, vocab, (STEP_BATCH, 8)).astype(np.int64),
             "labels": r.integers(0, LABELS, STEP_BATCH).astype(np.int64)}
            for _ in range(steps)]


def step_losses(model, batches, part) -> "list[float]":
    """finetune_classifier's losses under ``part``, with plain SGD: its
    update is the gradient itself, so a gradient summed or divided wrong
    shows in the next loss (Adam's would normalize the error away)."""
    import torch

    from sparkdl_torch.train import finetune_classifier

    _, hist = finetune_classifier(
        model, batches, partitioner=part,
        optimizer=torch.optim.SGD(model.parameters(), lr=STEP_LR))
    return [h["loss"] for h in hist]


def _losses(model, batches, part) -> dict:
    """:func:`step_losses` on this rank, and whether every rank saw the
    same."""
    import torch.distributed as dist

    losses = step_losses(model, batches, part)
    return {"losses": losses, "world": dist.get_world_size(),
            "rank_losses_equal": len({tuple(x) for x in _gathered(losses)}) == 1}


def _rows_of(batches: "list[dict]", part) -> "list[dict]":
    n = STEP_BATCH // part.data_axis_size
    i = part.data_index()
    return [{k: v[i * n:(i + 1) * n] for k, v in b.items()} for b in batches]


def vit_tp_check(inp: dict) -> dict:
    """Tiny ViT (with its top) at tp = the whole world, loaded with this
    rank's slices through VIT_RULES: features and probabilities."""
    import torch
    import torch.distributed as dist

    from sparkdl_torch.models.convert import shard_state_dict
    from sparkdl_torch.models.vit import ViTConfig, ViTModel
    from sparkdl_torch.partition.rules import VIT_RULES

    mesh = _mesh(dp=1, tp=dist.get_world_size())
    model = ViTModel(ViTConfig.tiny(), num_classes=inp["classes"], mesh=mesh)
    model.load_state_dict(shard_state_dict({k: _t(a) for k, a in inp["state"].items()},
                                           model, VIT_RULES))
    with torch.no_grad():
        f, p = model.eval()(_t(inp["x"]))
    return {"features": _np(f), "probs": _np(p),
            "q_rows": int(model.layer[0].attention.query.weight.shape[0])}


def spmd_step_check(inp: dict, kind: str, **axes) -> dict:
    """finetune_classifier of ``kind`` (``vit`` or ``bert``) on a mesh of
    ``axes`` through SPMDPartitioner of the model's rules, each data
    shard feeding its rows of the global batches."""
    import torch_dist_jobs as djobs
    from sparkdl_torch.models.bert import BertConfig, BertForSequenceClassification
    from sparkdl_torch.models.convert import shard_state_dict
    from sparkdl_torch.partition import SPMDPartitioner
    from sparkdl_torch.partition.rules import BERT_RULES, VIT_RULES

    mesh = _mesh(**axes)
    if kind == "vit":
        model, rules, batches = vit_classifier(mesh), VIT_RULES, vit_batches()
    else:
        model = BertForSequenceClassification(BertConfig.tiny(vocab_size=djobs.VOCAB),
                                              device="cpu", mesh=mesh)
        rules, batches = BERT_RULES, djobs.toy_batches()
    model.load_state_dict(shard_state_dict(
        {k: _t(a) for k, a in inp[kind].items()}, model, rules))
    part = SPMDPartitioner(mesh, rules)
    out = _losses(model, _rows_of(batches, part), part)
    import torch

    out["sharded"] = sorted({s.name.split(".")[-2] for s in part.shard_opt_state(
        torch.optim.SGD(model.parameters(), lr=0.0), model).sharded})
    return out


def ring_step_check(inp: dict, sp: int) -> dict:
    """BERT fine-tuning with ring attention over ``sp``: each data shard's
    rows, each sp peer its block of their tokens, the labels whole."""
    import torch.distributed as dist

    import torch_dist_jobs as djobs
    from sparkdl_torch.models.bert import BertConfig, BertForSequenceClassification
    from sparkdl_torch.partition import DataParallelPartitioner

    mesh = _mesh(dp=dist.get_world_size() // sp, sp=sp)
    cfg = BertConfig.tiny(vocab_size=djobs.VOCAB, attn_impl="ring")
    model = BertForSequenceClassification(cfg, device="cpu", mesh=mesh)
    model.load_state_dict({k: _t(a) for k, a in inp["bert"].items()})
    part = DataParallelPartitioner(mesh)
    c, n = mesh.coordinate("sp"), djobs.LENGTH // sp
    batches = [{k: v if k == "labels" else v[:, c * n:(c + 1) * n] for k, v in b.items()}
               for b in _rows_of(djobs.toy_batches(), part)]
    return _losses(model, batches, part)


def moe_step_check(inp: dict) -> dict:
    """The MoE GPT classifier with its experts split over ep = the whole
    world, the batch over ep too (GPT_RULES)."""
    import torch.distributed as dist

    from sparkdl_torch.models.convert import shard_state_dict
    from sparkdl_torch.partition import SPMDPartitioner
    from sparkdl_torch.partition.rules import GPT_RULES

    mesh = _mesh(dp=1, ep=dist.get_world_size())
    model = gpt_classifier(inp["moe_cfg"], mesh)
    model.load_state_dict(shard_state_dict({k: _t(a) for k, a in inp["moe"].items()},
                                           model, GPT_RULES))
    part = SPMDPartitioner(mesh, GPT_RULES, batch_axes=("dp", "fsdp", "ep"))
    out = _losses(model, _rows_of(gpt_batches(), part), part)
    out["local_experts"] = int(model.gpt.h[1].moe_mlp.wi.shape[0])
    return out


def pipeline_step_check(inp: dict) -> dict:
    """The GPT classifier's blocks as pipeline stages over pp = the whole
    world, every rank feeding the same rows; the stacked stages'
    optimizer state one stage a rank."""
    import torch.distributed as dist

    from sparkdl_torch.partition import PartitionSpec as P, SPMDPartitioner

    world = dist.get_world_size()
    mesh = _mesh(dp=1, pp=world)
    model = gpt_classifier(inp["cfg"], mesh, pipeline=True)
    model.load_state_dict(model.from_whole({k: _t(a) for k, a in inp["gpt"].items()}))
    part = SPMDPartitioner(mesh, ((r"^stages\.", P("pp")), (r".*", P())))
    return _losses(model, gpt_batches(), part)


# -- the jobs -----------------------------------------------------------------------

def two_rank_job(inp: dict) -> dict:
    """Every 2-rank check, in one job (a job's start costs seconds)."""
    return {
        "collectives": collectives_checks(inp["collectives"]),
        "attention": attention_checks(inp["attention"]),
        "tp_mlp": tp_mlp_check(inp["tp_mlp"]),
        "moe_block": moe_block_check(inp["moe_block"]),
        "pipeline": pipeline_check(inp["pipeline"]),
        "gpt_ring": gpt_ring_check(inp["gpt"]),
        "sp_prefill": sp_prefill_check(inp["gpt"]),
        "gpt_tp": gpt_tp_check(inp["gpt"]),
        "moe_gpt": moe_gpt_check(inp["moe_gpt"]),
        "finetune_tp": finetune_tp_check(inp["bert_finetune"], dp=1, tp=2),
        "vit_tp": vit_tp_check(inp["vit_tp"]),
        "ring_step": ring_step_check(inp["steps"], sp=2),
        "moe_step": moe_step_check(inp["steps"]),
        "pipeline_step": pipeline_step_check(inp["steps"]),
    }


def four_rank_job(inp: dict) -> dict:
    """Every 4-rank check, in one job."""
    return {
        "collectives": collectives_checks(inp["collectives"]),
        "attention": attention_checks(inp["attention"]),
        "pipeline": pipeline_check(inp["pipeline"]),
        "gpt_ring": gpt_ring_check(inp["gpt"]),
        "sp_prefill": sp_prefill_check(inp["gpt"]),
        "bert_ring": bert_ring_check(inp["bert_ring"]),
        "finetune_tp": finetune_tp_check(inp["bert_finetune"], dp=2, tp=2),
        "vit_fsdp_tp": spmd_step_check(inp["steps"], "vit", dp=1, fsdp=2, tp=2),
        "bert_fsdp_tp": spmd_step_check(inp["steps"], "bert", dp=1, fsdp=2, tp=2),
        "ring_step": ring_step_check(inp["steps"], sp=2),
    }
