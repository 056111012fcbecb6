"""Regex partition rules over parameter names: the port of
``sparkdl_tpu.partition.rules``.

An ordered table of ``(regex, PartitionSpec)`` pairs matched with
``re.search`` against ``.``-joined names (a ``state_dict``'s keys, or the
joined path of a nested dict), **first match wins**. Scalars and size-1
leaves are never partitioned; a non-scalar leaf no rule matches raises
:class:`PartitionRuleError` (tables end with an explicit ``(".*", P())``
catch-all where replication is the intent).

The port's names are the torch modules' ``state_dict`` keys, and a
``nn.Linear`` weight is ``[out, in]`` where a Flax kernel is ``[in, out]``
(a conv weight OIHW where Flax's is HWIO). Each table below gives each
parameter the placement the reference's table gives its Flax counterpart,
with the dims permuted accordingly: the reference's column-parallel
``P("fsdp", "tp")`` kernel is ``P("tp", "fsdp")`` here. A rule whose spec
names more dims than a leaf has does not apply to that leaf and matching
goes on: the reference tells kernels from norm scales by their names
(``kernel``/``scale``), the port's modules call both ``weight``, so the
trailing ``weight$`` rules reach only the weights of their rank.

Because matching is a search, the same table places the optimizer state
that mirrors the parameters (``exp_avg`` keyed under the parameter's
name). Every match lands in ``sparkdl_partition_rule_hits_total{rule}``.
"""

from __future__ import annotations

import re
from typing import Any, Sequence

from sparkdl_torch.observability.registry import registry
from sparkdl_torch.runtime.mesh import PartitionSpec as P

__all__ = [
    "PartitionRuleError",
    "match_partition_rules",
    "tree_path_names",
    "unflatten_names",
    "rule_hit_counts",
    "GPT_RULES",
    "BERT_RULES",
    "VIT_RULES",
    "GENERIC_RULES",
    "KV_POOL_RULES",
    "sequence_activation_spec",
    "default_rules_for",
]

_HITS = None


def _rule_hits():
    global _HITS
    if _HITS is None:
        _HITS = registry().counter(
            "sparkdl_partition_rule_hits_total",
            "params matched by each partition rule", labels=("rule",))
    return _HITS


class PartitionRuleError(ValueError):
    """A non-scalar param leaf matched no rule in the table."""


def tree_path_names(tree: Any) -> "list[tuple[str, Any]]":
    """Flatten ``tree`` to ``[(name, leaf), ...]`` in order: a module's
    named parameters, or the ``.``-joined paths of nested dicts, lists
    and tuples (a flat ``state_dict`` keeps its keys)."""
    import torch

    if isinstance(tree, torch.nn.Module):
        return list(tree.named_parameters())
    out: "list[tuple[str, Any]]" = []

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)) and not isinstance(node, P):
            items = enumerate(node)
        else:
            out.append((prefix, node))
            return
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else str(k))

    walk(tree, "")
    return out


def unflatten_names(tree: Any, leaves: "list[Any]") -> Any:
    """``leaves`` (in :func:`tree_path_names` order) put back into the
    structure of ``tree`` (a module's parameters come back as a
    ``{name: leaf}`` dict)."""
    import torch

    it = iter(leaves)
    if isinstance(tree, torch.nn.Module):
        return {name: next(it) for name, _ in tree.named_parameters()}

    def build(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not isinstance(node, P):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(tree)


def _numel(shape: "tuple[int, ...]") -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def match_partition_rules(
    rules: "Sequence[tuple[str, P]]", tree: Any, *,
    count_hits: bool = True,
) -> Any:
    """Tree of :class:`PartitionSpec` for ``tree``, first applicable rule
    wins (a rule applies where its regex matches the name and its spec
    has no more dims than the leaf).

    Scalar / single-element leaves get ``P()`` without consulting the
    table. A non-scalar leaf that no rule matches raises
    :class:`PartitionRuleError` naming the param.
    """
    specs = []
    for name, leaf in tree_path_names(tree):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 0 or _numel(shape) == 1:
            specs.append(P())
            continue
        for rule, spec in rules:
            if len(spec) <= len(shape) and re.search(rule, name) is not None:
                if count_hits:
                    _rule_hits().inc(rule=rule)
                specs.append(spec)
                break
        else:
            raise PartitionRuleError(
                f"no partition rule matched param {name!r} "
                f"(shape {shape}); add a rule or an explicit "
                f"('.*', P()) catch-all if replication is intended"
            )
    return unflatten_names(tree, specs)


def rule_hit_counts() -> "dict[str, float]":
    """``{rule_pattern: hits}`` accumulated so far (registry-sourced)."""
    fam = registry().get("sparkdl_partition_rule_hits_total")
    if fam is None:
        return {}
    return fam.labelled_values("rule")


#: GPT decoder family (models/gpt.py names). q/k/v and the MLP up
#: projection column-parallel (out dim on tp), out_proj and the MLP down
#: projection row-parallel (in dim on tp): the Megatron pairing. The
#: expert stacks of a mixture-of-experts layer (``moe_mlp.wi``/``wo``,
#: [E, ...]) split their expert dim over ep; their rule comes first, as
#: the ``(up|wi)``/``(down|wo)`` rules, written for ``.weight`` names,
#: never reach them.
GPT_RULES: "tuple[tuple[str, P], ...]" = (
    (r"moe_mlp\.(wi|wo)$", P("ep")),
    (r"attn\.(q_proj|k_proj|v_proj)\.weight$", P("tp", "fsdp")),
    (r"attn\.out_proj\.weight$", P("fsdp", "tp")),
    (r"(^|\.)(up|wi)\.weight$", P("tp", "fsdp")),
    (r"(^|\.)(down|wo)\.weight$", P("fsdp", "tp")),
    (r"(q_proj|k_proj|v_proj|up|wi)\.bias$", P("tp")),
    (r"wte\.weight$", P("tp", "fsdp")),
    (r"wpe\.weight$", P(None, "fsdp")),
    (r"ln_.*\.(weight|bias)$", P()),
    (r"weight$", P(None, "fsdp")),
    (r".*", P()),
)

#: BERT encoder family (models/bert.py names).
BERT_RULES: "tuple[tuple[str, P], ...]" = (
    (r"attention\.(query|key|value)\.weight$", P("tp", "fsdp")),
    (r"attention\.output_dense\.weight$", P("fsdp", "tp")),
    (r"intermediate\.weight$", P("tp", "fsdp")),
    (r"(query|key|value|intermediate)\.bias$", P("tp")),
    (r"layer\.\d+\.output\.weight$", P("fsdp", "tp")),
    (r"embeddings\.\w+_embeddings\.weight$", P("tp", "fsdp")),
    (r"LayerNorm\.(weight|bias)$", P()),
    (r"weight$", P(None, "fsdp")),
    (r".*", P()),
)

#: ViT encoder family (models/vit.py names); the patch embedding is an
#: OIHW conv weight, its output channels on fsdp.
VIT_RULES: "tuple[tuple[str, P], ...]" = (
    (r"attention\.(query|key|value)\.weight$", P("tp", "fsdp")),
    (r"attention\.output_dense\.weight$", P("fsdp", "tp")),
    (r"intermediate\.weight$", P("tp", "fsdp")),
    (r"(query|key|value|intermediate)\.bias$", P("tp")),
    (r"layer\.\d+\.output\.weight$", P("fsdp", "tp")),
    (r"patch_embed\.weight$", P("fsdp", None, None, None)),
    (r"(cls_token|pos_embed)", P()),
    (r"layernorm\w*\.(weight|bias)$", P()),
    (r"weight$", P(None, "fsdp")),
    (r".*", P()),
)

#: Model-agnostic fallback: the reference row-shards every kernel on
#: fsdp (a dense kernel's input dim, a conv kernel's H), embeddings'
#: feature dim, and replicates the rest.
GENERIC_RULES: "tuple[tuple[str, P], ...]" = (
    (r"embed\w*\.weight$", P(None, "fsdp")),
    (r"weight$", P(None, None, "fsdp", None)),
    (r"weight$", P(None, "fsdp")),
    (r".*", P()),
)

#: Sequence-axis placement for the paged KV block pool: the k/v pool
#: arrays ``[layers, n_blocks, block_size, H, D]`` (and the int8 scale
#: arrays ``[layers, n_blocks, block_size]``) shard their block axis on
#: ``sp``, contiguous shards. ``sp`` shards tokens, never weights.
KV_POOL_RULES: "tuple[tuple[str, P], ...]" = (
    (r"(^|\.)(k|v)$", P(None, "sp")),
    (r"_scale$", P(None, "sp")),
    (r".*", P()),
)


def sequence_activation_spec(*, ndim: int, seq_dim: int = 1,
                             sp_axis: str = "sp",
                             batch_axes: "Sequence[str]" = ()) -> P:
    """:class:`PartitionSpec` placing an activation's SEQUENCE dim on the
    ``sp`` axis (and optionally its batch dim on ``batch_axes``): token
    ids ``[B, L]`` (``ndim=2``), logits ``[B, L, V]`` (``ndim=3``), or
    per-layer K/V ``[layers, B, L, H, D]`` (``ndim=5, seq_dim=2``).
    Contiguous token shards: rank ``c`` holds columns
    ``[c*L/sp, (c+1)*L/sp)``."""
    if not 0 <= seq_dim < ndim:
        raise ValueError(
            f"seq_dim {seq_dim} out of range for ndim {ndim}")
    parts: "list" = [None] * ndim
    if batch_axes:
        parts[0] = tuple(batch_axes)
    parts[seq_dim] = sp_axis
    return P(*parts)


_TABLES = {
    "gpt": GPT_RULES,
    "bert": BERT_RULES,
    "vit": VIT_RULES,
    "generic": GENERIC_RULES,
}


def default_rules_for(model: str) -> "tuple[tuple[str, P], ...]":
    """Rule table for a model family name (``gpt``/``bert``/``vit``),
    :data:`GENERIC_RULES` for anything unrecognized."""
    key = model.lower()
    for name, table in _TABLES.items():
        if name in key:
            return table
    return GENERIC_RULES
