"""The JAX side of the multi-rank parallel tests: inputs made from numpy
seeds, the JAX package's weights as numpy trees and torch state dicts,
and the JAX functions' outputs on them, for a job of ``world`` ranks
(``tests/torch_parallel_jobs.py``) to be held against.

The JAX functions run as the JAX package's own tests run them: the
sharded ones under ``shard_map`` on the conftest's virtual CPU devices,
the rest on one device.
"""

from __future__ import annotations

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from torch_parity import gpt_variables

NEW_TOKENS = 8
GPT_EVEN, GPT_ODD = 24, 21  # the remainder prompt divides no sp > 1


def _mesh(**axes):
    from sparkdl_tpu.partition.mesh_factory import make_mesh

    n = int(np.prod(list(axes.values())))
    return make_mesh(devices=jax.devices()[:n], **axes)


def _smap(fn, mesh, in_specs, out_specs):
    from sparkdl_tpu.compat import shard_map

    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


def _kernel_to_weight(tree: dict) -> dict:
    """A Flax Dense tree {name: {kernel, bias}} as torch Linear keys."""
    out = {}
    for name, fields in tree.items():
        out[f"{name}.weight"] = np.ascontiguousarray(np.asarray(fields["kernel"]).T)
        if "bias" in fields:
            out[f"{name}.bias"] = np.asarray(fields["bias"])
    return out


# -- collectives ----------------------------------------------------------------

def collectives(world: int) -> "tuple[dict, dict]":
    from sparkdl_tpu.parallel.collectives import (
        all_gather_params,
        cross_replica_mean,
        global_norm,
        psum_grads,
        reduce_scatter_grads,
    )

    rng = np.random.default_rng(0)
    per_rank = rng.standard_normal((world, 3)).astype(np.float32)
    g = rng.standard_normal((4 * world, 4)).astype(np.float32)
    dp, fsdp = _mesh(dp=world), _mesh(dp=1, fsdp=world)
    mean = _smap(lambda t: cross_replica_mean({"g": t}, "dp")["g"], dp,
                 P("dp"), P("dp"))(per_rank)
    summed, norm = _smap(
        lambda t: (psum_grads({"g": t}, "dp")["g"],
                   jnp.broadcast_to(global_norm({"g": t}, "dp"), (1,))),
        dp, P("dp"), (P("dp"), P("dp")))(per_rank)
    tree = {"w": jnp.asarray(g), "b": jnp.arange(3.0)}
    shapes = jax.eval_shape(lambda t: t, tree)

    def body(t):
        shard = reduce_scatter_grads(t, "fsdp")
        return shard, all_gather_params(shard, "fsdp", full_shapes=shapes)

    shard, back = _smap(body, fsdp, P(), ({"w": P("fsdp"), "b": P()}, P()))(tree)
    want = {"mean": np.asarray(mean), "psum": np.asarray(summed)[:1],
            "norm": float(np.asarray(norm)[0]), "rs_w": np.asarray(shard["w"]),
            "rs_b": np.asarray(shard["b"]), "roundtrip_w": np.asarray(back["w"]),
            "roundtrip_b": np.asarray(back["b"])}
    return {"per_rank": per_rank, "g": g}, want


# -- attention --------------------------------------------------------------------

def attention(world: int) -> "tuple[dict, dict]":
    from sparkdl_tpu.parallel.ring_attention import (
        allgather_self_attention,
        ring_attention,
    )

    rng = np.random.default_rng(0)
    b, l, h, d = 2, 8 * world, 2, 8
    q, k, v = (rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, l), bool)
    mask[0, l // 2:] = False  # a row half padding
    mask[1, 3:] = False
    gq, gk, gv = (rng.standard_normal((2, 4 * world, 2, 4)).astype(np.float32)
                  for _ in range(3))
    mesh = _mesh(dp=1, sp=world)
    spec = P(None, "sp")
    want = {}
    for causal in (False, True):
        c = int(causal)
        want[f"ring_causal{c}"] = np.asarray(ring_attention(q, k, v, mesh, causal=causal))
        want[f"ring_mask_causal{c}"] = np.asarray(
            ring_attention(q, k, v, mesh, kv_mask=mask, causal=causal))
        want[f"allgather_causal{c}"] = np.asarray(_smap(
            lambda q_, k_, v_, m_, causal=causal: allgather_self_attention(
                q_, k_, v_, m_, causal=causal), mesh, (spec,) * 4, spec)(q, k, v, mask))

    def loss(q_, k_, v_):
        return jnp.sum(ring_attention(q_, k_, v_, mesh, causal=True) ** 2)

    want["grads"] = [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(gq, gk, gv)]
    return ({"q": q, "k": k, "v": v, "mask": mask, "gq": gq, "gk": gk, "gv": gv},
            want)


# -- tensor parallel, experts, pipeline ---------------------------------------------

def tp_mlp() -> "tuple[dict, dict]":
    from sparkdl_tpu.parallel.tensor_parallel import TPMlpBlock

    model = TPMlpBlock(hidden_features=32, out_features=16)
    x = np.random.default_rng(0).standard_normal((4, 8, 16)).astype(np.float32)
    params = jax.device_get(flax.core.meta.unbox(model.init(jax.random.PRNGKey(0), x)))

    def loss(p, x_):
        return jnp.sum(model.apply(p, x_) ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    want = {"y": np.asarray(model.apply(params, x)),
            "grads": _kernel_to_weight(jax.device_get(gp)["params"]),
            "x_grad": np.asarray(gx)}
    return {"weights": _kernel_to_weight(params["params"]), "x": x}, want


def _moe_weights(tree: dict) -> dict:
    return {"router.weight": np.ascontiguousarray(np.asarray(tree["router"]["kernel"]).T),
            "wi": np.asarray(tree["wi"]), "wo": np.asarray(tree["wo"])}


def moe_block(cf: float = 1.0) -> "tuple[dict, dict]":
    """A capacity factor of 1 drops tokens: overflow is part of the test."""
    from sparkdl_tpu.parallel.expert_parallel import MoEMlpBlock, moe_aux_losses

    model = MoEMlpBlock(num_experts=4, hidden_features=32, k=2, capacity_factor=cf)
    x = np.random.default_rng(1).standard_normal((4, 16, 8)).astype(np.float32)
    params = jax.device_get(flax.core.meta.unbox(model.init(jax.random.PRNGKey(0), x)))
    y, inters = model.apply(params, x, mutable=["intermediates"])
    aux = moe_aux_losses(inters["intermediates"])
    g = jax.grad(lambda p: jnp.sum(model.apply(p, x) ** 2))(params)
    want = {"y": np.asarray(y), "aux_loss": float(aux["aux_loss"]),
            "router_z_loss": float(aux["router_z_loss"]),
            "grads": _moe_weights(jax.device_get(g)["params"])}
    return {"weights": _moe_weights(params["params"]), "x": x, "k": 2, "cf": cf}, want


def pipeline(world: int) -> "tuple[dict, dict]":
    from sparkdl_tpu.parallel.pipeline import pipeline_apply, stack_stage_params

    def stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    rng = np.random.default_rng(0)
    d, batch, num_mb = 8, 16, 4
    stages = [{"w": rng.standard_normal((d, d)).astype(np.float32) * 0.5,
               "b": rng.standard_normal((d,)).astype(np.float32) * 0.1}
              for _ in range(world)]
    stacked = jax.device_get(stack_stage_params(stages))
    x = rng.standard_normal((batch, d)).astype(np.float32)
    mesh = _mesh(dp=1, pp=world)

    def loss(s, x_):
        return jnp.sum(pipeline_apply(stage, s, x_, mesh, num_microbatches=num_mb) ** 2)

    gs, gx = jax.grad(loss, argnums=(0, 1))(stacked, x)
    want = {"out": np.asarray(pipeline_apply(stage, stacked, x, mesh,
                                             num_microbatches=num_mb)),
            "grad_w": np.asarray(gs["w"]), "grad_b": np.asarray(gs["b"]),
            "grad_x": np.asarray(gx)}
    return {"w": np.asarray(stacked["w"]), "b": np.asarray(stacked["b"]), "x": x,
            "num_mb": num_mb}, want


# -- GPT ----------------------------------------------------------------------------

def gpt(world: int, **cfg_kw) -> "tuple[dict, dict]":
    """Tiny GPT weights and the JAX side of the ring, sp_prefill and tp
    checks: the ring GPT under shard_map (each sp_mode), the unsharded
    forward and its init_cache prefill K/V, and greedy generate. (The
    tokens after sp_prefill are held to the port's plain generate, which
    tests/test_torch_gpt.py holds to this one.)"""
    from sparkdl_tpu.models.gpt import GPTConfig, GPTLMHeadModel, generate, init_cache

    from sparkdl_torch.models import gpt as tgpt
    from sparkdl_torch.models.convert import gpt_flax_to_torch

    cfg = GPTConfig.tiny(**cfg_kw)
    variables = gpt_variables(cfg)
    module = tgpt.GPTLMHeadModel(tgpt.GPTConfig.tiny(**cfg_kw), device="cpu")
    state = {k: v.numpy() for k, v in gpt_flax_to_torch(variables, module=module).items()}
    model = GPTLMHeadModel(cfg)
    rng = np.random.default_rng(3)
    inp = {"cfg": cfg_kw, "state": state, "new_tokens": NEW_TOKENS,
           "ids": rng.integers(1, cfg.vocab_size, (2, 8 * world)).astype(np.int32),
           "even": rng.integers(1, cfg.vocab_size, (2, GPT_EVEN)).astype(np.int32),
           "odd": rng.integers(1, cfg.vocab_size, (2, GPT_ODD)).astype(np.int32)}
    want = {"ids_logits": np.asarray(model.apply(variables, inp["ids"])[0]),
            "ids_tokens": np.asarray(generate(model, variables, inp["ids"][:, :4],
                                              NEW_TOKENS))}
    if world > 1 and not cfg_kw:
        mesh = _mesh(dp=1, sp=world)
        l = inp["ids"].shape[1]
        pos = np.broadcast_to(np.arange(l), (2, l))
        for mode in ("ring", "allgather"):
            ring = GPTLMHeadModel(dataclasses.replace(cfg, attn_impl="ring", sp_mode=mode))
            want[f"ring_{mode}"] = np.asarray(_smap(
                lambda i, p, ring=ring: ring.apply(variables, i, positions=p)[0],
                mesh, (P(None, "sp"),) * 2, P(None, "sp"))(inp["ids"], pos))
        for key in ("even", "odd"):
            ids = inp[key]
            cache = init_cache(cfg, 2, ids.shape[1])
            logits, cache = model.apply(variables, ids, cache=cache)
            want[key] = {"logits": np.asarray(logits), "k": np.asarray(cache["k"]),
                         "v": np.asarray(cache["v"])}
    return inp, want


# -- BERT ---------------------------------------------------------------------------

def bert_ring(world: int) -> "tuple[dict, dict]":
    from sparkdl_tpu.models.bert import BertConfig, BertModel

    from sparkdl_torch.models import bert as tbert
    from sparkdl_torch.models.convert import bert_flax_to_torch

    cfg = BertConfig.tiny()
    rng = np.random.default_rng(2)
    b, l = 2, 8 * world
    ids = rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    mask[0, l - 5:] = 0
    mask[1, l // 2:] = 0  # whole shards of padding
    model = BertModel(cfg)
    variables = jax.device_get(flax.core.meta.unbox(
        model.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))))
    module = tbert.BertModel(tbert.BertConfig.tiny(), device="cpu")
    state = {k: v.numpy() for k, v in bert_flax_to_torch(variables, module=module).items()}
    cfg_kw = {f.name: getattr(tbert.BertConfig.tiny(), f.name)
              for f in dataclasses.fields(tbert.BertConfig) if f.name != "dtype"}
    want = {"seq": np.asarray(model.apply(variables, ids, mask)[0])}
    return {"cfg": cfg_kw, "state": state, "ids": ids, "mask": mask}, want


def bert_finetune() -> dict:
    """The tiny fine-tune's starting weights (JAX init, converted), as
    tests/test_torch_finetune_dist.py makes them."""
    import torch_dist_jobs as jobs
    from sparkdl_tpu.models.bert import BertConfig, BertForSequenceClassification

    from sparkdl_torch.models import bert as tbert
    from sparkdl_torch.models.convert import bert_flax_to_torch

    b = jobs.toy_batches()[0]
    v = BertForSequenceClassification(BertConfig.tiny(vocab_size=jobs.VOCAB),
                                      num_labels=2).init(
        jax.random.PRNGKey(0), jnp.asarray(b["input_ids"][:2]),
        jnp.asarray(b["attention_mask"][:2]))
    variables = jax.device_get(flax.core.meta.unbox(v))
    m = tbert.BertForSequenceClassification(
        tbert.BertConfig.tiny(vocab_size=jobs.VOCAB), device="cpu")
    return {"state": {k: t.numpy()
                      for k, t in bert_flax_to_torch(variables, module=m).items()}}


def one_process_finetune(state: dict) -> "list[float]":
    """The port's one-process fine-tune of the global batches."""
    import torch

    import torch_dist_jobs as jobs
    from sparkdl_torch.partition import SingleDevicePartitioner
    from sparkdl_torch.train import finetune_classifier

    model = jobs.tiny_bert({k: torch.from_numpy(v) for k, v in state.items()})
    _, hist = finetune_classifier(model, jobs.toy_batches(), learning_rate=1e-3,
                                  partitioner=SingleDevicePartitioner("cpu"))
    return [h["loss"] for h in hist]


# -- ViT at tp, and the train steps over every mesh axis ---------------------------

VIT_CLASSES = 5


def vit_tp() -> "tuple[dict, dict]":
    """Tiny ViT (JAX init, converted) and the JAX forward's features and
    probabilities on random images."""
    from sparkdl_tpu.models import vit as jvit

    from sparkdl_torch.models.convert import vit_flax_to_torch
    from sparkdl_torch.models.vit import ViTConfig, ViTModel

    model = jvit.ViTModel(config=jvit.ViTConfig.tiny(), num_classes=VIT_CLASSES)
    variables = jax.device_get(flax.core.meta.unbox(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))))
    module = ViTModel(ViTConfig.tiny(), num_classes=VIT_CLASSES)
    state = {k: v.numpy() for k, v in vit_flax_to_torch(variables, module=module).items()}
    x = np.random.default_rng(11).standard_normal((3, 32, 32, 3)).astype(np.float32)
    f, p = model.apply(variables, x)
    return ({"state": state, "x": x, "classes": VIT_CLASSES},
            {"features": np.asarray(f), "probs": np.asarray(p)})


def step_states(bert_state: dict) -> dict:
    """The starting weights of the step checks (``tests/torch_parallel_jobs``
    ``*_step_check``): the port's seeded inits, and the BERT fine-tune's."""
    import torch_parallel_jobs as pjobs

    from sparkdl_torch.models.gpt import init_gpt_
    from sparkdl_torch.models.vit import init_vit_

    def numpy(module):
        return {k: v.numpy().copy() for k, v in module.state_dict().items()}

    vit = pjobs.vit_classifier()
    init_vit_(vit.vit, 0)
    moe_cfg = dict(num_experts=4, moe_every=2)
    moe, gpt = pjobs.gpt_classifier(moe_cfg), pjobs.gpt_classifier({})
    init_gpt_(moe.gpt, 0)
    init_gpt_(gpt.gpt, 1)
    return {"vit": numpy(vit), "bert": bert_state, "moe": numpy(moe),
            "moe_cfg": moe_cfg, "gpt": numpy(gpt), "cfg": {}}


def one_process_steps(states: dict) -> dict:
    """The port's one-process losses of each step check's model, over the
    global batches (``pjobs.step_losses``)."""
    import torch

    import torch_dist_jobs as djobs
    import torch_parallel_jobs as pjobs
    from sparkdl_torch.partition import SingleDevicePartitioner

    def run(model, key, batches):
        model.load_state_dict({k: torch.from_numpy(v) for k, v in states[key].items()})
        return pjobs.step_losses(model, batches, SingleDevicePartitioner("cpu"))

    return {"vit": run(pjobs.vit_classifier(), "vit", pjobs.vit_batches()),
            "bert": run(djobs.tiny_bert({k: torch.from_numpy(v) for k, v in
                                         states["bert"].items()}), "bert", djobs.toy_batches()),
            "moe": run(pjobs.gpt_classifier(states["moe_cfg"]), "moe", pjobs.gpt_batches()),
            "gpt": run(pjobs.gpt_classifier(states["cfg"]), "gpt", pjobs.gpt_batches())}
