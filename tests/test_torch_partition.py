"""The port's partition layer (sparkdl_torch/partition, runtime/mesh.py)
against the JAX package's, from the reference's tests/partition suite:
mesh shapes and MeshShapeError; each rule table, name by name, against
the JAX table over the same model's Flax tree (the port's names and
dims through the weight converters of models/convert.py); the ZeRO
specs and bytes per rank; ``pad_batch_to_multiple``; and the
Partitioner surface. Specs compare exactly (they are data)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from sparkdl_torch.partition import (
    BERT_RULES,
    GENERIC_RULES,
    GPT_RULES,
    VIT_RULES,
    DataParallelPartitioner,
    MeshShapeError,
    PartitionRuleError,
    PartitionSpec as P,
    SingleDevicePartitioner,
    SPMDPartitioner,
    axis_sizes,
    default_rules_for,
    make_custom_mesh,
    make_mesh,
    match_partition_rules,
    opt_state_bytes_per_chip,
    rule_hit_counts,
    zero_partition_specs,
)
from sparkdl_torch.partition.rules import tree_path_names
from sparkdl_torch.runtime.mesh import MeshSpec, batch_sharding, spec_placements
from sparkdl_tpu.partition import rules as jrules
from sparkdl_tpu.partition import zero as jzero

EIGHT = list(range(8))


# -- meshes -------------------------------------------------------------------

def test_make_mesh_infers_dp_and_matches_the_jax_factory():
    from sparkdl_tpu.partition import axis_sizes as jax_sizes
    from sparkdl_tpu.partition import make_mesh as jax_make_mesh

    for kw in (dict(tp=4), dict(dp=2, tp=2, fsdp=2), dict(dp=4, fsdp=2),
               dict(dp=1, sp=2, tp=4)):
        assert axis_sizes(make_mesh(devices=EIGHT, **kw)) == jax_sizes(
            jax_make_mesh(**kw))
    mesh = make_mesh(dp=4, fsdp=2, devices=EIGHT)
    assert mesh.devices.tolist() == np.arange(8).reshape(4, 1, 2, 1, 1, 1).tolist()
    assert mesh.coordinate("fsdp", rank=5) == 1 and mesh.coordinate("dp", rank=5) == 2
    assert axis_sizes(make_mesh()) == dict(dp=1, pp=1, fsdp=1, sp=1, tp=1, ep=1)


@pytest.mark.parametrize("kw,match", [
    (dict(tp=3), "8 devices"),
    (dict(dp=2, tp=2), "device count 8"),
    (dict(dp=0), "dp=0"),
    (dict(tp=2.5), "tp=2.5"),
])
def test_bad_mesh_raises_typed_with_the_device_count(kw, match):
    with pytest.raises(MeshShapeError, match=match):
        make_mesh(devices=EIGHT, **kw)


def test_meshspec_and_custom_meshes():
    with pytest.raises(MeshShapeError, match="-1"):
        MeshSpec(dp=-1, fsdp=-1).resolve(8)
    with pytest.raises(ValueError):
        MeshSpec(dp=3).resolve(8)
    with pytest.raises(MeshShapeError, match="overlapping.*'x'"):
        make_custom_mesh([("x", 2), ("y", 2), ("x", 2)], devices=EIGHT)
    mesh = make_custom_mesh([("rows", 2), ("cols", -1)], devices=EIGHT)
    assert axis_sizes(mesh) == {"rows": 2, "cols": 4}
    with pytest.raises(MeshShapeError, match="device count 8"):
        make_custom_mesh([("x", 2), ("y", 2)], devices=EIGHT)


def test_shardings_are_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_mesh(dp=4, fsdp=2, devices=EIGHT)
    assert batch_sharding(mesh) == (Shard(0), Replicate(), Shard(0),
                                    Replicate(), Replicate(), Replicate())
    assert spec_placements(P(None, "fsdp"), mesh)[2] == Shard(1)
    with pytest.raises(MeshShapeError, match="two dims"):
        spec_placements(P("fsdp", "fsdp"), mesh)


# -- rule tables, name by name against the reference -----------------------------

def _flax_leaf(inverse, key, value):
    """(Flax path, leaf) of one state_dict entry, through the inverse
    converter; None where the entry has no Flax counterpart."""
    tree = inverse({key: value})
    names = [(n, leaf) for n, leaf in jrules.tree_path_names(tree)]
    return names[0] if names else None


def _torch_spec(flax_spec, flax_path, ndim):
    """The reference's spec of a Flax leaf, in the port's dim order."""
    parts = tuple(flax_spec) + (None,) * (ndim - len(flax_spec))
    if flax_path.endswith("kernel"):
        if ndim == 2:
            return parts[::-1]
        if ndim == 4:  # HWIO -> OIHW
            return (parts[3], parts[2], parts[0], parts[1])
    return parts


def _check_table(port_rules, jax_rules, state_dict, inverse, variables):
    want = dict(jrules.tree_path_names(
        jrules.match_partition_rules(jax_rules, variables, count_hits=False)))
    got = dict(tree_path_names(match_partition_rules(
        port_rules, state_dict, count_hits=False)))
    assert set(got) == set(state_dict)  # exhaustive
    checked = 0
    for key, value in state_dict.items():
        leaf = _flax_leaf(inverse, key, value)
        if leaf is None:
            continue  # e.g. a scale-free BN's unit weight, no Flax leaf
        path, _ = leaf
        flax_spec = want[path]
        mine = tuple(got[key]) + (None,) * (value.dim() - len(got[key]))
        assert mine == _torch_spec(flax_spec, path, value.dim()), (key, path)
        checked += 1
    return checked


def test_gpt_table_places_like_the_reference():
    from torch_parity import gpt_variables

    from sparkdl_torch.models.convert import gpt_flax_to_torch, gpt_torch_to_flax
    from sparkdl_tpu.models.gpt import GPTConfig

    variables = gpt_variables(GPTConfig.tiny())
    sd = gpt_flax_to_torch(variables)
    assert _check_table(GPT_RULES, jrules.GPT_RULES, sd, gpt_torch_to_flax,
                        variables) == len(sd)


def test_bert_table_places_like_the_reference():
    import flax

    from sparkdl_torch.models.convert import bert_flax_to_torch, bert_torch_to_flax
    from sparkdl_tpu.models.bert import BertConfig, BertForSequenceClassification

    ids = jnp.zeros((1, 8), jnp.int32)
    variables = jax.device_get(flax.core.meta.unbox(
        BertForSequenceClassification(BertConfig.tiny(), num_labels=2).init(
            jax.random.PRNGKey(0), ids, jnp.ones_like(ids))))
    sd = bert_flax_to_torch(variables)
    assert _check_table(BERT_RULES, jrules.BERT_RULES, sd, bert_torch_to_flax,
                        variables) == len(sd)


def test_vit_table_places_like_the_reference():
    import flax

    from sparkdl_torch.models.convert import vit_flax_to_torch, vit_torch_to_flax
    from sparkdl_tpu.models.vit import ViTConfig, ViTModel

    cfg = ViTConfig.tiny()
    x = jnp.zeros((1, cfg.image_size, cfg.image_size, 3), jnp.float32)
    variables = jax.device_get(flax.core.meta.unbox(
        ViTModel(cfg).init(jax.random.PRNGKey(0), x)))
    sd = vit_flax_to_torch(variables)
    assert _check_table(VIT_RULES, jrules.VIT_RULES, sd, vit_torch_to_flax,
                        variables) == len(sd)


def test_generic_table_places_like_the_reference():
    """GENERIC over InceptionV3's convolutions, BNs and head."""
    from torch_parity import inception_variables

    from sparkdl_torch.models.convert import flax_to_torch, torch_to_flax

    variables = inception_variables()
    sd = flax_to_torch(variables)
    # every entry but the scale-free BNs' unit weights and step counts
    # has a Flax leaf
    unit_bn = [k for k in sd if k.startswith("bn") and (
        k.endswith(".weight") or k.endswith(".num_batches_tracked"))]
    assert _check_table(GENERIC_RULES, jrules.GENERIC_RULES, sd, torch_to_flax,
                        variables) == len(sd) - len(unit_bn) > 0


def test_first_match_wins_and_rank_decides_applicability():
    tree = {"a": {"weight": torch.zeros(4, 4)}, "n": {"weight": torch.zeros(4)}}
    rules = ((r"a\.weight$", P("tp", None)), (r"weight$", P("fsdp", None)),
             (r".*", P()))
    specs = match_partition_rules(rules, tree, count_hits=False)
    assert specs["a"]["weight"] == P("tp", None)
    assert specs["n"]["weight"] == P()  # a 2-d spec skips a 1-d weight
    specs = match_partition_rules(tuple(reversed(rules[:2])) + rules[2:], tree,
                                  count_hits=False)
    assert specs["a"]["weight"] == P("fsdp", None)


def test_unmatched_param_fails_loud_and_scalars_need_no_rule():
    with pytest.raises(PartitionRuleError, match="mystery.weights"):
        match_partition_rules(((r"kernel$", P("fsdp")),),
                              {"mystery": {"weights": torch.zeros(4, 4)}})
    tree = {"count": torch.zeros(()), "one": torch.zeros(1),
            "weight": torch.zeros(4, 2)}
    specs = match_partition_rules(((r"weight$", P("fsdp", None)),), tree)
    assert specs["count"] == P() and specs["one"] == P()
    assert specs["weight"] == P("fsdp", None)


def test_rule_hits_and_default_tables():
    from sparkdl_torch.models.gpt import GPTConfig, GPTLMHeadModel

    module = GPTLMHeadModel(GPTConfig.tiny(), device="cpu")
    key = r"attn\.(q_proj|k_proj|v_proj)\.weight$"
    before = rule_hit_counts().get(key, 0)
    match_partition_rules(GPT_RULES, module)
    assert rule_hit_counts()[key] - before == 6  # 2 layers x q, k, v
    assert default_rules_for("GPT2-medium") is GPT_RULES
    assert default_rules_for("vit_b16") is VIT_RULES
    assert default_rules_for("resnet50") is GENERIC_RULES


# -- ZeRO ---------------------------------------------------------------------------

def test_zero_specs_match_the_reference_leaf_by_leaf():
    shapes = {"k": (16, 8), "b": (8,), "odd": (3,), "s": (), "big": (6, 32),
              "c": (4, 4, 2, 64)}
    tree = {n: torch.zeros(s) for n, s in shapes.items()}
    jtree = {n: np.zeros(s, np.float32) for n, s in shapes.items()}
    for n in (2, 4):
        got = zero_partition_specs(tree, axis="fsdp", axis_size=n)
        want = jzero.zero_partition_specs(jtree, axis="fsdp", axis_size=n)
        for name in shapes:
            assert tuple(got[name]) == tuple(want[name]), (n, name)
    base = {n: P() for n in shapes}
    base["k"] = P("fsdp", None)
    got = zero_partition_specs(tree, axis="fsdp", axis_size=2, base_specs=base)
    assert got["k"] == P("fsdp", None)
    assert tuple(jzero.zero_leaf_spec((16, 8), axis="fsdp", axis_size=2,
                                      base=JP(None, "fsdp"))) == (None, "fsdp")


def test_opt_state_bytes_per_rank():
    opt = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(16, 8))])
    opt.zero_grad()
    opt.param_groups[0]["params"][0].grad = torch.zeros(16, 8)
    opt.step()
    # exp_avg + exp_avg_sq float32 and a float32 step
    assert opt_state_bytes_per_chip(opt) == 2 * 16 * 8 * 4 + 4


def test_zero_optimizer_owns_half_the_state_on_a_two_rank_mesh():
    """A ZeRO partitioner on a 2-rank mesh (laid over ranks without a
    process group: specs and bytes only) gives this rank half of every
    evenly split leaf."""
    from sparkdl_torch.train.finetune import materialize_optimizer_state

    model = torch.nn.Sequential(torch.nn.Linear(16, 8), torch.nn.Linear(8, 3))
    repl = DataParallelPartitioner(make_mesh(dp=2, devices=[0, 1]),
                                   device="cpu")
    zero = DataParallelPartitioner(make_mesh(dp=1, fsdp=2, devices=[0, 1]),
                                   zero_axis="fsdp", device="cpu")
    sizes = {}
    for name, part in (("repl", repl), ("zero", zero)):
        opt = part.shard_opt_state(torch.optim.AdamW(model.parameters()), model)
        materialize_optimizer_state(opt)
        sizes[name] = opt_state_bytes_per_chip(opt.optimizer)
    # the 8x16, 8 and 3x8 leaves halve; the 3-element bias stays whole
    n_split = 16 * 8 + 8 + 3 * 8
    assert sizes["repl"] - sizes["zero"] == 2 * 4 * n_split // 2


# -- padding and the Partitioner surface ----------------------------------------------

@pytest.mark.parametrize("n,multiple", [(5, 4), (8, 4), (1, 8), (13, 2)])
def test_pad_batch_to_multiple_matches_the_reference(n, multiple):
    from sparkdl_torch.runtime.batching import pad_batch_to_multiple
    from sparkdl_tpu.runtime.batching import pad_batch_to_multiple as jax_pad

    arrays = {"x": np.arange(n * 3, dtype=np.float32).reshape(n, 3),
              "ids": np.arange(n, dtype=np.int32)}
    got, want = pad_batch_to_multiple(arrays, multiple), jax_pad(arrays, multiple)
    assert (got.n_valid, got.bucket) == (want.n_valid, want.bucket)
    for k in arrays:
        np.testing.assert_array_equal(got.arrays[k], want.arrays[k])


def test_describe_keys_match_the_reference():
    from sparkdl_tpu.partition import DataParallelPartitioner as JDP
    from sparkdl_tpu.partition import SPMDPartitioner as JSPMD
    from sparkdl_tpu.partition import make_mesh as jax_make_mesh

    part = DataParallelPartitioner(make_mesh(dp=4, fsdp=2, devices=EIGHT),
                                   zero_axis="fsdp", device="cpu")
    want = JDP(jax_make_mesh(dp=4, fsdp=2), zero_axis="fsdp").describe()
    assert part.describe() == want
    spmd = SPMDPartitioner(make_mesh(dp=1, fsdp=8, devices=EIGHT),
                           GENERIC_RULES, device="cpu")
    assert set(spmd.describe()) == set(
        JSPMD(jax_make_mesh(dp=1, fsdp=8), jrules.GENERIC_RULES).describe())
    assert spmd.describe()["n_rules"] == len(GENERIC_RULES)


def test_shard_batch_keeps_this_ranks_rows_and_checks_divisibility():
    part = DataParallelPartitioner(make_mesh(dp=8, devices=EIGHT), device="cpu")
    batch = {"x": np.arange(16 * 2, dtype=np.float32).reshape(16, 2)}
    got = part.shard_batch(batch)  # rank 0 of 8: rows 0, 1
    assert torch.equal(got["x"], torch.tensor([[0.0, 1.0], [2.0, 3.0]]))
    assert part.shard_batch(batch, local=True)["x"].shape == (16, 2)
    with pytest.raises(MeshShapeError, match="leading dim 12"):
        part.shard_batch({"x": np.ones((12, 4), np.float32)})
    assert part.data_axis_size == 8


def test_batch_axes_must_exist_and_model_axes_raise():
    mesh = make_custom_mesh([("data", 8)], devices=EIGHT)
    with pytest.raises(MeshShapeError, match="dp"):
        DataParallelPartitioner(mesh)
    assert DataParallelPartitioner(mesh, batch_axes=("data",),
                                   device="cpu").data_axis_size == 8
    # tp is ported: the batch splits over dp only, the model over tp
    assert DataParallelPartitioner(make_mesh(dp=4, tp=2, devices=EIGHT),
                                   device="cpu").data_axis_size == 4
    # sp, pp and ep train too: the batch still splits over dp only, and a
    # gradient sums over the axes whose ranks' losses are terms of the
    # total (every split axis but tp and pp)
    for kw, terms in ((dict(sp=2), 8), (dict(pp=2), 4), (dict(ep=2), 8)):
        part = DataParallelPartitioner(make_mesh(dp=4, devices=EIGHT, **kw),
                                       device="cpu")
        assert (part.data_axis_size, part.grad_terms) == (4, terms)
    # an axis that is neither a batch axis nor a model axis would feed
    # every rank the same rows for nothing
    with pytest.raises(MeshShapeError, match="neither batch axes"):
        DataParallelPartitioner(make_mesh(dp=4, fsdp=2, devices=EIGHT),
                                batch_axes=("dp",), device="cpu")


def test_spmd_divisibility_error_names_the_param():
    part = SPMDPartitioner(make_mesh(dp=1, fsdp=8, devices=EIGHT),
                           GENERIC_RULES, device="cpu")
    bad = torch.nn.Linear(6, 4)  # weight [4, 6]: in-dim 6 on 8-way fsdp
    with pytest.raises(MeshShapeError, match="weight"):
        part.shard_params(bad)


def test_single_device_partitioner_is_the_identity_step():
    part = SingleDevicePartitioner("cpu")
    step = lambda b: b  # noqa: E731
    assert part.wrap_step(step) is step
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1)
    assert part.shard_opt_state(opt, torch.nn.Linear(1, 1)) is opt
    assert part.data_axis_size == 1 and part.describe()["device"] == "cpu"


# -- the device, the mesh's ranks and the one-way step --------------------------------

def test_partitioner_is_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """With no process group a partitioner is on the card, as
    SingleDevicePartitioner is, and raises where there is none; the CPU
    only when asked for."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DataParallelPartitioner(make_mesh(dp=1, fsdp=1), zero_axis="fsdp")
    cpu = DataParallelPartitioner(make_mesh(dp=1, fsdp=1), device="cpu")
    assert cpu.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    part = DataParallelPartitioner(make_mesh(dp=1, fsdp=1), zero_axis="fsdp")
    assert part.device.type == "cuda"


class _OnTheCard(torch.nn.Module):
    """A module whose one parameter reports the card (this build has
    none), recording every ``to``."""

    def __init__(self):
        super().__init__()
        self.moves = []

    def parameters(self, recurse=True):
        yield types.SimpleNamespace(device=torch.device("cuda", 0))

    def buffers(self, recurse=True):
        return iter(())

    def to(self, *args, **kwargs):
        self.moves.append((args, kwargs))
        return self


def test_a_cpu_partitioner_never_moves_a_card_model_off_the_card():
    model = _OnTheCard()
    part = DataParallelPartitioner(make_mesh(dp=1, fsdp=1), zero_axis="fsdp",
                                   device="cpu")
    with pytest.raises(ValueError, match="does not move a model off it"):
        part.shard_params(model)
    assert model.moves == []


def test_a_step_over_ranks_needs_their_process_group():
    """A mesh laid over two ranks with no process group gives specs and
    bytes, but a step over it raises: alone, this rank would train only
    its half of every sharded parameter."""
    from sparkdl_torch.train import finetune_classifier

    def part():
        return DataParallelPartitioner(make_mesh(dp=1, fsdp=2, devices=[0, 1]),
                                       zero_axis="fsdp", device="cpu")

    model = torch.nn.Linear(4, 2)
    with pytest.raises(MeshShapeError, match="process group of 2 ranks"):
        part().wrap_step(lambda batch: batch)
    with pytest.raises(MeshShapeError, match="process group of 2 ranks"):
        finetune_classifier(model, [], partitioner=part())
    opt = part().shard_opt_state(torch.optim.AdamW(model.parameters()), model)
    assert opt.sharded
    model(torch.ones(3, 4)).sum().backward()
    before = [p.detach().clone() for p in model.parameters()]
    with pytest.raises(MeshShapeError, match="process group of 2 ranks"):
        opt.step()
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), before))


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank in this process."""
    import torch.distributed as dist

    from sparkdl_torch.runner.backends import free_port

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_one_way_data_axis_takes_the_plain_step(world_of_one):
    """On a one-rank data axis the step has no collectives and no flat
    gradient buffers: ``wrap_step`` returns the step itself, and the
    sharded optimizer's steps are the plain optimizer's, bitwise."""
    part = DataParallelPartitioner(make_mesh(dp=1, fsdp=1), zero_axis="fsdp")
    assert part.device.type == "cpu"  # gloo's
    step = lambda batch: batch  # noqa: E731
    assert part.wrap_step(step) is step
    torch.manual_seed(0)
    a, b = torch.nn.Linear(4, 3), torch.nn.Linear(4, 3)
    b.load_state_dict(a.state_dict())
    sharded = part.shard_opt_state(torch.optim.AdamW(a.parameters(), lr=0.1), a)
    plain = torch.optim.AdamW(b.parameters(), lr=0.1)
    assert sharded._grad_flats == [] and sharded.sharded == []
    x = torch.randn(5, 4)
    for _ in range(3):
        for model, opt in ((a, sharded), (b, plain)):
            opt.zero_grad()
            model(x).pow(2).sum().backward()
            opt.step()
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
