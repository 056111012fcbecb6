"""The weight bridge: Flax zoo variables <-> torch state_dicts.

Both zoos name their layers in construction order (``conv000``,
``bn000``, ``dense000``; models/common.py ``Namer``), so conversion is a
per-type map with no name table:

  - conv  ``kernel`` HWIO -> ``weight`` OIHW, ``bias`` as is;
  - BN    ``bias`` -> ``bias``, ``batch_stats`` ``mean``/``var`` ->
          ``running_mean``/``running_var``, ``scale`` -> ``weight`` (a unit
          ``weight`` when the BN has no scale, as the zoo's Keras BNs);
  - dense ``kernel`` [in, out] -> ``weight`` [out, in], ``bias`` as is.

Inputs are nested dicts of numpy arrays (``jax.device_get`` of the Flax
variables); nothing here imports JAX.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LAYER = re.compile(r"^(conv|bn|dense)\d{3}$")


def flax_to_torch(variables: dict, module: "torch.nn.Module | None" = None) -> dict:
    """``{'params': ..., 'batch_stats': ...}`` numpy trees -> a state_dict.

    Raises on any leaf it does not consume (an unknown layer or field) and
    on incomplete BN entries; with ``module`` given, also on any key of
    ``module.state_dict()`` the variables do not provide.
    """
    params = dict(variables.get("params", {}))
    stats = dict(variables.get("batch_stats", {}))
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise ValueError(f"unexpected variable collections {sorted(extra)}")
    out: dict[str, torch.Tensor] = {}

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    for name in sorted(set(params) | set(stats)):
        if not _LAYER.match(name):
            raise ValueError(f"unknown layer {name!r}: not a Namer name")
        p = dict(params.get(name, {}))
        kind = name[:-3]
        if kind == "bn":
            s = dict(stats.get(name, {}))
            if "mean" not in s or "var" not in s or "bias" not in p:
                raise ValueError(f"{name}: BN needs bias, mean and var")
            out[f"{name}.running_mean"] = t(s.pop("mean"))
            out[f"{name}.running_var"] = t(s.pop("var"))
            out[f"{name}.bias"] = t(p.pop("bias"))
            out[f"{name}.weight"] = (t(p.pop("scale")) if "scale" in p
                                     else torch.ones_like(out[f"{name}.bias"]))
            out[f"{name}.num_batches_tracked"] = torch.tensor(0)
            leftover = sorted(s)
        else:
            if name in stats:
                raise ValueError(f"{name}: batch_stats on a non-BN layer")
            if "kernel" not in p:
                raise ValueError(f"{name}: no kernel")
            k = np.asarray(p.pop("kernel"))
            out[f"{name}.weight"] = t(k.transpose(3, 2, 0, 1) if kind == "conv"
                                      else k.T)
            if "bias" in p:
                out[f"{name}.bias"] = t(p.pop("bias"))
            leftover = []
        leftover += sorted(p)
        if leftover:
            raise ValueError(f"{name}: unconsumed fields {leftover}")
    if module is not None:
        want = set(module.state_dict())
        missing, unexpected = sorted(want - set(out)), sorted(set(out) - want)
        if missing or unexpected:
            raise ValueError(
                f"variables do not match {type(module).__name__}: missing "
                f"{missing[:8]}, unexpected {unexpected[:8]}"
            )
    return out


def torch_to_flax(state_dict: dict) -> dict:
    """The inverse of :func:`flax_to_torch`: a state_dict -> numpy
    ``{'params': ..., 'batch_stats': ...}`` trees (unit BN weights are
    dropped again, as scale-free Flax BNs have none)."""
    params: dict = {}
    stats: dict = {}
    for key, v in state_dict.items():
        name, field = key.split(".", 1)
        if not _LAYER.match(name):
            raise ValueError(f"unknown layer {name!r}: not a Namer name")
        a = v.detach().cpu().numpy()
        kind = name[:-3]
        if kind == "bn":
            if field == "num_batches_tracked":
                continue
            if field in ("running_mean", "running_var"):
                stats.setdefault(name, {})[field[8:]] = a
            elif field == "weight":
                if not np.all(a == 1.0):
                    params.setdefault(name, {})["scale"] = a
            else:
                params.setdefault(name, {})[field] = a
        elif field == "weight":
            params.setdefault(name, {})["kernel"] = (
                a.transpose(2, 3, 1, 0) if kind == "conv" else a.T)
        else:
            params.setdefault(name, {})[field] = a
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# GPT (models/gpt.py): Flax GPTLMHeadModel variables <-> torch state_dict
# ---------------------------------------------------------------------------
#
# Flax path (params/...)              torch key
#   wte|wpe / embedding                 wte|wpe.weight
#   ln_f / scale|bias                   ln_f.weight|bias
#   h_{i} / ln_1|ln_2 / scale|bias      h.{i}.ln_1|ln_2.weight|bias
#   h_{i} / attn / {q,k,v,out}_proj     h.{i}.attn.{q,k,v,out}_proj
#   h_{i} / up|down                     h.{i}.up|down
#     kernel [in, out] | bias             .weight [out, in] | .bias

_GPT_MODULE = re.compile(
    r"^(wte|wpe|ln_f|h_(\d+)/(ln_1|ln_2|attn/(q|k|v|out)_proj|up|down))$")
_GPT_FIELDS = {"embedding": ("weight",), "scale": ("weight", "bias"),
               "kernel": ("weight", "bias")}


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flatten(v, path) if isinstance(v, dict) else {path: v})
    return out


def gpt_flax_to_torch(variables: dict,
                      module: "torch.nn.Module | None" = None) -> dict:
    """``{'params': ...}`` numpy tree of the JAX ``GPTLMHeadModel`` -> a
    state_dict for ``sparkdl_torch.models.gpt.GPTLMHeadModel``.

    Raises on any leaf it does not consume, on a layer whose fields are
    incomplete, and, with ``module`` given, on any key of
    ``module.state_dict()`` the variables do not provide (or the reverse).
    """
    extra = set(variables) - {"params"}
    if extra:
        raise ValueError(f"unexpected variable collections {sorted(extra)}")
    by_module: dict[str, dict] = {}
    for path, leaf in _flatten(dict(variables.get("params", {}))).items():
        mod, _, field = path.rpartition("/")
        if not _GPT_MODULE.match(mod):
            raise ValueError(f"unknown GPT parameter {path!r}")
        by_module.setdefault(mod, {})[field] = leaf
    out: dict[str, torch.Tensor] = {}
    for mod, fields in sorted(by_module.items()):
        kind = next((f for f in _GPT_FIELDS if f in fields), None)
        want = {"embedding"} if kind == "embedding" else {kind, "bias"}
        if kind is None or set(fields) != want:
            raise ValueError(
                f"{mod}: fields {sorted(fields)} are not one of "
                "{embedding}, {scale, bias}, {kernel, bias}")
        key = re.sub(r"^h_(\d+)", r"h.\1", mod).replace("/", ".")
        w = np.asarray(fields[kind], dtype=np.float32)
        out[f"{key}.weight"] = torch.from_numpy(
            np.array(w.T if kind == "kernel" else w, order="C"))
        if "bias" in fields:
            out[f"{key}.bias"] = torch.from_numpy(
                np.array(fields["bias"], dtype=np.float32))
    if module is not None:
        want = set(module.state_dict())
        missing, unexpected = sorted(want - set(out)), sorted(set(out) - want)
        if missing or unexpected:
            raise ValueError(
                f"variables do not match {type(module).__name__}: missing "
                f"{missing[:8]}, unexpected {unexpected[:8]}"
            )
    return out


def gpt_torch_to_flax(state_dict: dict) -> dict:
    """The inverse of :func:`gpt_flax_to_torch`: a GPT state_dict -> the
    numpy ``{'params': ...}`` tree of the JAX ``GPTLMHeadModel``."""
    params: dict = {}
    for key, v in state_dict.items():
        mod, _, field = key.rpartition(".")
        path = re.sub(r"^h\.(\d+)", r"h_\1", mod).replace(".", "/")
        if not _GPT_MODULE.match(path) or field not in ("weight", "bias"):
            raise ValueError(f"unknown GPT parameter {key!r}")
        a = v.detach().cpu().float().numpy()
        if field == "bias":
            name = "bias"
        elif path in ("wte", "wpe"):
            name = "embedding"
        elif "ln_" in path:
            name = "scale"
        else:
            name, a = "kernel", a.T
        node = params
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(a)
    return {"params": params}


# ---------------------------------------------------------------------------
# BERT (models/bert.py): Flax Bert* variables <-> torch state_dict
# ---------------------------------------------------------------------------
#
# Flax path (params/[bert/]...)                  torch key ([bert.]...)
#   embeddings / {word,position,token_type}_embeddings / embedding
#                                                  embeddings.*_embeddings.weight
#   embeddings / LayerNorm / scale|bias            embeddings.LayerNorm.weight|bias
#   layer_{i} / attention / {query,key,value,output_dense}
#   layer_{i} / intermediate|output                layer.{i}.<same>
#     kernel [in, out] | bias                        .weight [out, in] | .bias
#   layer_{i} / attention_LayerNorm|output_LayerNorm / scale|bias
#   pooler, classifier / kernel|bias               pooler|classifier.weight|bias

_BERT_MODULE = re.compile(
    r"^((bert/)?(embeddings/(word_embeddings|position_embeddings|"
    r"token_type_embeddings|LayerNorm)|layer_\d+/(attention/(query|key|value|"
    r"output_dense)|attention_LayerNorm|intermediate|output|output_LayerNorm)"
    r"|pooler)|classifier)$")


def bert_flax_to_torch(variables: dict,
                       module: "torch.nn.Module | None" = None) -> dict:
    """``{'params': ...}`` numpy tree of the JAX ``BertModel`` or
    ``BertForSequenceClassification`` -> a state_dict for the module of the
    same name in ``sparkdl_torch.models.bert``.

    Raises on any leaf it does not consume, on a layer whose fields are
    incomplete, and, with ``module`` given, on any key of
    ``module.state_dict()`` the variables do not provide (or the reverse).
    """
    extra = set(variables) - {"params"}
    if extra:
        raise ValueError(f"unexpected variable collections {sorted(extra)}")
    by_module: dict[str, dict] = {}
    for path, leaf in _flatten(dict(variables.get("params", {}))).items():
        mod, _, field = path.rpartition("/")
        if not _BERT_MODULE.match(mod):
            raise ValueError(f"unknown BERT parameter {path!r}")
        by_module.setdefault(mod, {})[field] = leaf
    out: dict[str, torch.Tensor] = {}
    for mod, fields in sorted(by_module.items()):
        kind = next((f for f in _GPT_FIELDS if f in fields), None)
        want = {"embedding"} if kind == "embedding" else {kind, "bias"}
        if kind is None or set(fields) != want:
            raise ValueError(
                f"{mod}: fields {sorted(fields)} are not one of "
                "{embedding}, {scale, bias}, {kernel, bias}")
        key = re.sub(r"layer_(\d+)", r"layer.\1", mod).replace("/", ".")
        w = np.asarray(fields[kind], dtype=np.float32)
        out[f"{key}.weight"] = torch.from_numpy(
            np.array(w.T if kind == "kernel" else w, order="C"))
        if "bias" in fields:
            out[f"{key}.bias"] = torch.from_numpy(
                np.array(fields["bias"], dtype=np.float32))
    if module is not None:
        want = set(module.state_dict())
        missing, unexpected = sorted(want - set(out)), sorted(set(out) - want)
        if missing or unexpected:
            raise ValueError(
                f"variables do not match {type(module).__name__}: missing "
                f"{missing[:8]}, unexpected {unexpected[:8]}"
            )
    return out


def bert_torch_to_flax(state_dict: dict) -> dict:
    """The inverse of :func:`bert_flax_to_torch`: a BERT state_dict -> the
    numpy ``{'params': ...}`` tree of the JAX module."""
    params: dict = {}
    for key, v in state_dict.items():
        mod, _, field = key.rpartition(".")
        path = re.sub(r"layer\.(\d+)", r"layer_\1", mod).replace(".", "/")
        if not _BERT_MODULE.match(path) or field not in ("weight", "bias"):
            raise ValueError(f"unknown BERT parameter {key!r}")
        a = v.detach().cpu().float().numpy()
        if field == "bias":
            name = "bias"
        elif path.endswith("_embeddings"):
            name = "embedding"
        elif path.endswith("LayerNorm"):
            name = "scale"
        else:
            name, a = "kernel", a.T
        node = params
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(a)
    return {"params": params}
