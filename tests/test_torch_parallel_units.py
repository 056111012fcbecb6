"""``sparkdl_torch.parallel`` and the models that use it in one process:
the expert routing and the MoE block and GPT against the JAX package on
the same numpy-seeded inputs and converted weights, the weight bridge's
expert leaves, one rank's slice of a state dict, and what a world of one
(or no mesh) does. The multi-rank paths run in
``test_torch_parallel_{two,four}_ranks.py``.

Tolerances: ``top_k_dispatch``'s dispatch exactly, its combine and aux
loss 1e-6 (float32 products of the same gates); the MoE block 1e-5 (its
combine sums k experts' outputs in another order); the tiny MoE GPT's
logits 1e-5 and its greedy tokens exactly.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_torch.models import gpt as tgpt
from sparkdl_torch.models.convert import (
    gpt_flax_to_torch,
    gpt_torch_to_flax,
    shard_state_dict,
)
from sparkdl_torch.parallel import (
    ColumnParallelDense,
    MoEMlpBlock,
    RowParallelDense,
    TPMlpBlock,
    moe_aux_losses,
    pipeline_apply,
    top_k_dispatch,
)
from sparkdl_torch.parallel.collectives import axis_group, cross_replica_mean
from sparkdl_torch.partition import make_mesh
from sparkdl_torch.partition.rules import GPT_RULES, match_partition_rules
from sparkdl_torch.runtime.mesh import MeshShapeError, MeshSpec, mesh_context
from sparkdl_tpu.models import gpt as jgpt
from sparkdl_tpu.parallel import expert_parallel as jep
from torch_parallel_refs import moe_block
from torch_parity import gpt_variables, left_pad

MOE = dict(num_experts=4, moe_every=2)


def _gates(g, s, e, seed, underflow=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((g, s, e)).astype(np.float32) * 2
    gates = np.array(jax.nn.softmax(logits, axis=-1))
    if underflow:  # rows whose remaining gates are exactly zero
        gates[:, ::3, 2:] = 0.0
        gates[:, ::3] /= gates[:, ::3].sum(-1, keepdims=True)
    return gates


@pytest.mark.parametrize("g,s,e,k,capacity,underflow", [
    (2, 16, 4, 2, 32, False),   # ample capacity: every pick lands
    (2, 64, 4, 2, 8, False),    # overflow: dropped picks
    (3, 20, 8, 1, 2, False),
    (2, 12, 4, 3, 6, True),     # underflowed gates counted once
    (1, 9, 4, 4, 3, True),
])
def test_top_k_dispatch_matches_jax(g, s, e, k, capacity, underflow):
    gates = _gates(g, s, e, seed=s + k, underflow=underflow)
    jc, jd, jaux = jep.top_k_dispatch(jnp.asarray(gates), k, capacity)
    tc, td, taux = top_k_dispatch(torch.from_numpy(gates), k, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    with pytest.raises(ValueError, match="k="):
        top_k_dispatch(torch.from_numpy(gates), e + 1, capacity)


@pytest.mark.parametrize("two_d", [False, True])
def test_moe_block_at_ep1_matches_jax(two_d):
    inp, want = moe_block()
    w = inp["weights"]
    e, m, h = w["wi"].shape
    blk = MoEMlpBlock(m, e, h, k=inp["k"], capacity_factor=inp["cf"], device="cpu")
    blk.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    x = torch.from_numpy(inp["x"])
    if two_d:  # a 2-D input is one group: the reference's on x[0]
        y = blk(x[0])
        assert y.shape == x[0].shape
        jblk = jep.MoEMlpBlock(num_experts=e, hidden_features=h, k=inp["k"],
                               capacity_factor=inp["cf"])
        params = {"params": {"router": {"kernel": w["router.weight"].T},
                             "wi": w["wi"], "wo": w["wo"]}}
        np.testing.assert_allclose(y.detach().numpy(),
                                   np.asarray(jblk.apply(params, inp["x"][0])), atol=1e-5)
        return
    y = blk(x)
    losses = moe_aux_losses(blk)
    np.testing.assert_allclose(y.detach().numpy(), want["y"], atol=1e-5)
    np.testing.assert_allclose(float(losses["aux_loss"]), want["aux_loss"], rtol=1e-6)
    np.testing.assert_allclose(float(losses["router_z_loss"]), want["router_z_loss"],
                               rtol=1e-6)
    (y ** 2).sum().backward()
    for name, p in blk.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want["grads"][name],
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert blk.capacity(16) == 8 and blk.capacity(1) == 1


def test_dropped_tokens_get_zero_output():
    blk = MoEMlpBlock(4, 2, 8, k=1, capacity_factor=1e-9, device="cpu")
    y = blk(torch.ones((1, 6, 4)))
    # one slot per expert: at most 2 of 6 tokens get an output
    assert int((y[0] != 0).any(dim=-1).sum()) <= 2


@pytest.fixture(scope="module")
def moe_pair():
    cfg = jgpt.GPTConfig.tiny(**MOE)
    variables = gpt_variables(cfg)
    module = tgpt.GPTLMHeadModel(tgpt.GPTConfig.tiny(**MOE), device="cpu")
    module.load_state_dict(gpt_flax_to_torch(variables, module=module))
    return jgpt.GPTLMHeadModel(cfg), variables, module.eval()


def test_moe_gpt_logits_match_jax(moe_pair):
    jmodel, variables, module = moe_pair
    assert "moe_mlp" in variables["params"]["h_1"]
    assert "moe_mlp" not in variables["params"]["h_0"]
    ids = np.random.default_rng(1).integers(0, 128, (2, 12)).astype(np.int32)
    want = np.asarray(jmodel.apply(variables, ids)[0])
    with torch.no_grad():
        got = module(torch.from_numpy(ids).long())[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("impl", ["full", "flash"])
def test_moe_gpt_greedy_tokens_match_jax(moe_pair, impl):
    """Prefill groups are whole rows, a decode step's group one token
    (capacity 1): the reference's grouping, ragged prompts included. The
    port's flash route runs the kernels' plain versions here."""
    jmodel, variables, module = moe_pair
    ids, mask = left_pad([[5, 3, 9, 2, 7], [6, 8, 6], [1, 2, 3, 4, 5, 6, 7]])
    want = np.asarray(jgpt.generate(jmodel, variables, jnp.asarray(ids), 8,
                                    attention_mask=jnp.asarray(mask)))
    cfg = tgpt.GPTConfig.tiny(**MOE, attn_impl=impl, flash_decode=impl == "flash")
    m = tgpt.GPTLMHeadModel(cfg, device="cpu")
    m.load_state_dict(module.state_dict())
    got = tgpt.generate(m, torch.from_numpy(ids).long(), 8,
                        attention_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_weight_bridge_carries_the_expert_leaves(moe_pair):
    _, variables, module = moe_pair
    sd = gpt_flax_to_torch(variables, module=module)
    assert sd["h.1.moe_mlp.wi"].shape == (4, 32, 64)
    assert sd["h.1.moe_mlp.router.weight"].shape == (4, 32)
    back = gpt_torch_to_flax(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    bad = flax.core.unfreeze(variables)
    bad["params"]["h_1"]["moe_mlp"]["extra"] = np.zeros(1)
    with pytest.raises(ValueError, match="moe_mlp"):
        gpt_flax_to_torch(bad)


def test_gpt_rules_split_the_expert_stacks_on_ep(moe_pair):
    _, variables, module = moe_pair
    specs = match_partition_rules(GPT_RULES, module.state_dict(), count_hits=False)
    assert tuple(specs["h.1.moe_mlp.wi"]) == ("ep",)
    assert tuple(specs["h.1.moe_mlp.wo"]) == ("ep",)
    assert tuple(specs["h.1.moe_mlp.router.weight"]) == (None, "fsdp")
    assert tuple(specs["h.0.up.weight"]) == ("tp", "fsdp")


def test_shard_state_dict_slices_what_the_layers_hold(moe_pair):
    """Built under a mesh (no process group needed to build): each rank's
    slice of the same whole state dict, by its coordinates."""
    _, _, module = moe_pair
    whole = module.state_dict()
    mesh = make_mesh(dp=1, tp=2, ep=2, devices=[0, 1, 2, 3])
    cfg = tgpt.GPTConfig.tiny(**MOE)
    rank3 = mesh.devices.reshape(-1)[-1]
    assert (mesh.coordinate("tp", rank3), mesh.coordinate("ep", rank3)) == (1, 1)
    model = tgpt.GPTLMHeadModel(cfg, device="cpu", mesh=mesh)
    mine = shard_state_dict(whole, model, GPT_RULES)  # this process is rank 0
    model.load_state_dict(mine)
    assert model.local_heads == 1
    torch.testing.assert_close(mine["h.0.attn.q_proj.weight"],
                               whole["h.0.attn.q_proj.weight"][:16], rtol=0, atol=0)
    torch.testing.assert_close(mine["h.0.attn.out_proj.weight"],
                               whole["h.0.attn.out_proj.weight"][:, :16], rtol=0, atol=0)
    torch.testing.assert_close(mine["h.1.moe_mlp.wi"], whole["h.1.moe_mlp.wi"][:2],
                               rtol=0, atol=0)
    assert mine["wte.weight"].shape == whole["wte.weight"].shape  # held whole
    no_tp = tuple(r for r in GPT_RULES if "q_proj" not in r[0])
    with pytest.raises(ValueError, match="does not name"):
        shard_state_dict(whole, model, no_tp)
    with pytest.raises(MeshShapeError, match="TorchRunner"):
        model(torch.tensor([[1, 2]]))  # a 4-rank mesh needs 4 processes
    with pytest.raises(ValueError, match="not divisible"):
        tgpt.GPTLMHeadModel(tgpt.GPTConfig.tiny(num_heads=1, hidden_size=32),
                            device="cpu", mesh=mesh)


def test_return_kv_is_the_cached_prefill(moe_pair):
    jmodel, variables, module = moe_pair
    ids = np.random.default_rng(4).integers(0, 128, (2, 10)).astype(np.int32)
    with torch.no_grad():
        _, kv = module(torch.from_numpy(ids).long(), return_kv=True)
        cache = tgpt.init_cache(module.config, 2, 10, device="cpu")
        module(torch.from_numpy(ids).long(), cache=cache)
    torch.testing.assert_close(kv["k"], cache["k"], rtol=0, atol=0)
    torch.testing.assert_close(kv["v"], cache["v"], rtol=0, atol=0)
    jcache = jgpt.init_cache(jmodel.config, 2, 10)
    _, jcache = jmodel.apply(variables, ids, cache=jcache)
    np.testing.assert_allclose(kv["k"].numpy(), np.asarray(jcache["k"]), atol=1e-5)


def test_sp_prefill_on_one_rank_and_its_guards():
    """sp = 1: the all-gather schedule IS the full forward, bit for bit,
    and decoding from its cache is generate's continuation."""
    cfg = tgpt.GPTConfig.tiny(attn_impl="ring", sp_mode="allgather")
    model = tgpt.init_gpt_(tgpt.GPTLMHeadModel(cfg, device="cpu"))
    plain = tgpt.GPTLMHeadModel(tgpt.GPTConfig.tiny(), device="cpu")
    plain.load_state_dict(model.state_dict())
    ids = torch.randint(0, 128, (2, 9), generator=torch.Generator().manual_seed(0))
    logits, cache = tgpt.sp_prefill(model, ids, MeshSpec(dp=1).build())
    with torch.no_grad():
        assert torch.equal(logits, plain(ids)[0])
    assert cache["k"].shape == (2, 2, 9, 2, 16) and cache["idx"] == 9
    toks = tgpt.generate_from_cache(model, logits, cache, 6)
    assert torch.equal(toks, tgpt.generate(plain, ids, 6)[:, 9:])
    short = tgpt.GPTLMHeadModel(dataclasses.replace(cfg, positions="learned",
                                                    max_seq_len=8), device="cpu")
    with pytest.raises(ValueError, match="position table"):
        tgpt.sp_prefill(short, ids, MeshSpec(dp=1).build())


def test_world_of_one_and_unbound_axes():
    """Without a mesh an axis is unbound (the reference's error outside
    shard_map); on a one-rank mesh every collective is the identity."""
    x = {"g": torch.arange(3.0)}
    with pytest.raises(ValueError, match="unbound"):
        cross_replica_mean(x)
    with mesh_context(MeshSpec(dp=1).build()):
        assert torch.equal(cross_replica_mean(x)["g"], x["g"])
        assert axis_group("sp").size == 1
        with pytest.raises(ValueError, match="not in the mesh axes"):
            axis_group("nope")

        def stage(p, h):
            return torch.tanh(h @ p["w"])

        w = torch.randn(1, 4, 4, requires_grad=True)
        h = torch.randn(6, 4)
        out = pipeline_apply(stage, {"w": w}, h, num_microbatches=3)
        torch.testing.assert_close(out, torch.tanh(h @ w[0]))
        out.sum().backward()
        assert w.grad.shape == (1, 4, 4)
        with pytest.raises(ValueError, match="not divisible by microbatches"):
            pipeline_apply(stage, {"w": w}, h, num_microbatches=4)


def test_mesh_axis_ranks_and_ring_neighbours():
    mesh = make_mesh(dp=2, sp=4, devices=list(range(8)))
    assert mesh.axis_ranks("sp", rank=5) == [4, 5, 6, 7]
    assert mesh.axis_ranks("dp", rank=5) == [1, 5]
    # this process is rank 0
    assert mesh.ring_neighbours("sp") == (3, 1)


def test_init_gpt_follows_flax_for_the_expert_stacks():
    m = tgpt.init_gpt_(tgpt.GPTLMHeadModel(
        tgpt.GPTConfig.tiny(**MOE, hidden_size=64, intermediate_size=256),
        device="cpu"), seed=0)
    blk = m.h[1].moe_mlp
    assert blk.router.bias is None
    # flax's fan-in of an [E, in, out] kernel is in * E
    for w, fan_in in ((blk.wi, 64 * 4), (blk.wo, 256 * 4)):
        assert abs(float(w.std()) - fan_in ** -0.5) < 0.05 * fan_in ** -0.5


@pytest.mark.parametrize("path", ["tools/parallel4_probe.py", "tests/torch_parallel_jobs.py"])
def test_the_probe_and_the_rank_bodies_import_no_jax(path):
    """What runs on the card's machine (no JAX there) or in a worker
    process (which must not import it) imports neither JAX nor the JAX
    package."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parents[1] / path).read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "flax", "optax", "sparkdl_tpu"}, roots


def test_a_tp_slice_sharded_on_fsdp_too_raises_a8_parallel():
    """A tp slice whose rule also names a sharded fsdp axis is ported (no
    "A8 parallel" raise): its optimizer state is this rank's slice cut
    again on fsdp, beside the fsdp shards of the parameters held whole.
    The four-rank test holds such a step to one process's."""
    from sparkdl_torch.models.bert import BertConfig, BertForSequenceClassification
    from sparkdl_torch.partition import SPMDPartitioner
    from sparkdl_torch.partition.rules import BERT_RULES

    mesh = make_mesh(dp=1, fsdp=2, tp=2, devices=[0, 1, 2, 3])
    model = BertForSequenceClassification(BertConfig.tiny(), device="cpu", mesh=mesh)
    part = SPMDPartitioner(mesh, BERT_RULES, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    sharded = {s.name: s for s in part.shard_opt_state(opt, model).sharded}
    q = sharded["bert.layer.0.attention.query.weight"]
    assert q.axes == ("fsdp",) and q.dim == 1
    assert tuple(q.owned.shape) == (16, 16)  # [32/tp, 32/fsdp]
    assert sharded["bert.embeddings.word_embeddings.weight"].axes == ("fsdp",)
    assert "bert.layer.0.attention.query.bias" not in sharded  # tp only
    plain = BertForSequenceClassification(BertConfig.tiny(), device="cpu")
    with pytest.raises(ValueError, match="no tensor-parallel layer"):
        part.shard_params(plain)


@pytest.mark.parametrize("build", [
    lambda **kw: MoEMlpBlock(8, 4, 16, **kw),
    lambda **kw: TPMlpBlock(8, 16, 8, **kw),
    lambda **kw: ColumnParallelDense(8, 16, **kw),
    lambda **kw: RowParallelDense(16, 8, **kw),
], ids=["MoEMlpBlock", "TPMlpBlock", "ColumnParallelDense", "RowParallelDense"])
def test_bare_parallel_layers_are_built_on_the_card(build, monkeypatch):
    """Built with no ``device=``, a layer asks for the card, and raises
    where CUDA is absent; ``device="cpu"`` builds it on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()
    assert {p.device.type for p in build(device="cpu").parameters()} == {"cpu"}


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_a_tp_layer_runs_four_all_reduces_a_step(family, monkeypatch):
    """Under tp = 2 one forward and backward of a transformer layer runs
    four tp all-reduces: the attention's and the MLP's row-parallel
    outputs forward, and in the backward one for the input q, k and v
    share and one for the MLP's input."""
    from sparkdl_torch.models import bert as tbert
    from sparkdl_torch.parallel import tensor_parallel as tpm
    from sparkdl_torch.parallel.collectives import AxisGroup

    calls = []
    monkeypatch.setattr(tpm, "_all_reduce", lambda x, ag: calls.append(ag) or x)
    mesh = make_mesh(dp=1, tp=2, devices=[0, 1])
    ids = torch.randint(0, 64, (2, 8), generator=torch.Generator().manual_seed(0))
    if family == "gpt":
        model = tgpt.GPTLMHeadModel(tgpt.GPTConfig.tiny(vocab_size=64), device="cpu",
                                    mesh=mesh)
        layers = model.config.num_layers
    else:
        model = tbert.BertModel(tbert.BertConfig.tiny(vocab_size=64), device="cpu", mesh=mesh)
        layers = model.config.num_hidden_layers
    tp_layers = [m for m in model.modules() if isinstance(m, tpm._TPLinear)]
    assert len(tp_layers) == 6 * layers
    for m in tp_layers:  # rank 0 of two, its reduces counted (and not run)
        m._ag = AxisGroup(2, 0, (0, 1))
    out = model(ids)
    (out[0] if isinstance(out, tuple) else out).sum().backward()
    assert len(calls) == 4 * layers
