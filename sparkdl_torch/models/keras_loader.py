"""Keras models as plain data, and Keras weights for the zoo.

One reader, two consumers. :func:`read_keras_model` is the only function
of the port that reads a Keras object or file: it turns a ``keras.Model``
(or a ``.h5``/``.keras`` file) into a :class:`KerasGraph`, the model's
``get_config()`` dict and each weight-bearing layer's ``get_weights()`` as
numpy. It uses nothing else of Keras (no ``stateless_call``), so it does
not depend on the Keras backend, and nothing after it imports Keras. The
consumers:

- the zoo converter, :func:`keras_to_flax_variables` (a copy of
  ``sparkdl_tpu.models.keras_loader``'s, reading a ``KerasGraph``) chained
  with ``models/convert.flax_to_torch`` (:func:`load_keras_weights`);
- ``models/keras_graph.KerasGraphModule``, which runs any model of its
  layer surface as torch ops.

Matching for the zoo is by construction order per layer type (see
``models/common.Namer``): the k-th Keras Conv2D maps to ``conv{k:03d}``
and so on. Layouts:

  Keras Conv2D kernel   (kh, kw, in, out)      == Flax Conv kernel
  Keras Dense kernel    (in, out)              == Flax Dense kernel
  Keras DepthwiseConv2D (kh, kw, in, mult)     -> transpose to (kh, kw, mult, in)
  Keras SeparableConv2D depthwise + pointwise  -> sepdwNNN + seppwNNN pair
  Keras BatchNormalization gamma/beta          -> params scale/bias
                           moving mean/var     -> batch_stats mean/var

:func:`write_keras_weights` goes the other way for the estimator: a
trained ``KerasGraphModule``'s weights into the Keras model, saved.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np

from sparkdl_torch.models.common import Namer


@dataclasses.dataclass
class KerasGraph:
    """A Keras model as plain data: ``config`` is ``model.get_config()``
    (a Sequential's or a functional model's), ``weights`` maps each
    weight-bearing layer's name to its ``get_weights()`` (numpy, Keras
    layouts and order)."""

    config: dict
    weights: dict

    @property
    def sequential(self) -> bool:
        return "input_layers" not in self.config

    @property
    def layers(self) -> list:
        """The layer entries of the config, in Keras's (topological) order."""
        return self.config["layers"]

    @property
    def input_shape(self) -> tuple:
        """The model input's shape, batch dimension first (None)."""
        if self.sequential:
            first = self.layers[0] if self.layers else {}
            if first.get("class_name") == "InputLayer":
                return tuple(first["config"]["batch_shape"])
            if self.config.get("build_input_shape") is None:
                raise ValueError("the Sequential model has no input shape; "
                                 "build it (keras.Input) before saving")
            return tuple(self.config["build_input_shape"])
        inputs = self.config["input_layers"]
        if inputs and not isinstance(inputs[0], str):
            if len(inputs) != 1:
                raise NotImplementedError(
                    "models with several inputs are outside the port's "
                    "Keras surface (ROADMAP A3)")
            inputs = inputs[0]
        for layer in self.layers:
            if layer_name(layer) == inputs[0]:
                return tuple(layer["config"]["batch_shape"])
        raise ValueError(f"input layer {inputs[0]!r} not in the config")


def layer_name(entry: dict) -> str:
    return entry["config"]["name"]


def read_keras_model(model_or_file) -> KerasGraph:
    """A ``keras.Model``, or the path of a ``.h5``/``.keras`` file, as a
    :class:`KerasGraph` (the model's config and each layer's weights as
    float32 numpy)."""
    model = model_or_file
    if isinstance(model_or_file, str):
        model = load_keras_model_file(model_or_file)
    weights = {}
    for lyr in model.layers:
        w = lyr.get_weights()
        if w:
            weights[lyr.name] = [np.asarray(a, dtype=np.float32) for a in w]
    return KerasGraph(config=model.get_config(), weights=weights)


def load_keras_model_file(path: str):
    """Load a Keras model from .h5 / .keras file (compile=False)."""
    import os

    if not os.path.isfile(path):
        raise FileNotFoundError(f"no Keras model file at {path!r}")
    import keras

    return keras.models.load_model(path, compile=False)


# ---------------------------------------------------------------------------
# the zoo converter
# ---------------------------------------------------------------------------

_AUTO_SUFFIX = re.compile(r"^(.*?)(?:_(\d+))?$")


def _auto_suffix_key(name: str) -> int:
    """Keras auto-names ('conv2d', 'conv2d_7') carry construction order in
    the suffix (global per-class counter, monotone within a model)."""
    m = _AUTO_SUFFIX.match(name)
    return int(m.group(2)) if m.group(2) else -1


def keras_to_flax_variables(graph: KerasGraph, layer_order: str = "topo") -> dict:
    """A Keras model's weights as Flax-shaped numpy variables
    ``{'params': ..., 'batch_stats': ...}`` under Namer's naming scheme.

    Because Namer counters are independent per layer type, only the
    *per-type* ordering matters. ``layer_order`` picks it:

      'topo'        — the config's layer order (Keras's topological
                      serialization order). Zoo modules whose branches are
                      written in this order (ResNet, VGG, Xception) use it.
      'auto_suffix' — sort each type bucket by the auto-name numeric suffix,
                      recovering true construction order. Needed for
                      InceptionV3, whose parallel branches make topological
                      order differ from the source construction order the
                      zoo module mirrors.
    """
    buckets: dict[str, list] = {"conv": [], "sep": [], "bn": [], "dense": []}
    kinds = {"SeparableConv2D": "sep", "Conv2D": "conv", "DepthwiseConv2D": "conv",
             "BatchNormalization": "bn", "Dense": "dense"}
    for entry in graph.layers:
        cls, name = entry["class_name"], layer_name(entry)
        if cls in kinds:
            buckets[kinds[cls]].append(entry)
        elif graph.weights.get(name):
            raise ValueError(
                f"unsupported weight-bearing layer {cls} ({name}); zoo "
                "conversion handles conv/bn/dense families"
            )
    if layer_order == "auto_suffix":
        for b in buckets.values():
            b.sort(key=lambda e: _auto_suffix_key(layer_name(e)))
    elif layer_order != "topo":
        raise ValueError(f"unknown layer_order {layer_order!r}")

    def weights(entry):
        return [np.asarray(a) for a in graph.weights[layer_name(entry)]]

    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    nm = Namer()
    for entry in buckets["conv"]:
        w, cfg = weights(entry), entry["config"]
        if entry["class_name"] == "DepthwiseConv2D":
            p: dict[str, Any] = {"kernel": w[0].transpose(0, 1, 3, 2)}
        else:
            p = {"kernel": w[0]}
        if cfg.get("use_bias", True):
            p["bias"] = w[1]
        params[nm.conv()] = p
    for entry in buckets["sep"]:
        w, cfg = weights(entry), entry["config"]
        params[nm.sepdw()] = {"kernel": w[0].transpose(0, 1, 3, 2)}
        p = {"kernel": w[1]}
        if cfg.get("use_bias", True):
            p["bias"] = w[2]
        params[nm.seppw()] = p
    for entry in buckets["bn"]:
        w, cfg = weights(entry), entry["config"]
        i = 0
        bn: dict[str, Any] = {}
        if cfg.get("scale", True):
            bn["scale"] = w[i]
            i += 1
        if cfg.get("center", True):
            bn["bias"] = w[i]
            i += 1
        name = nm.bn()
        params[name] = bn
        stats[name] = {"mean": w[i], "var": w[i + 1]}
    for entry in buckets["dense"]:
        w, cfg = weights(entry), entry["config"]
        p = {"kernel": w[0]}
        if cfg.get("use_bias", True):
            p["bias"] = w[1]
        params[nm.dense()] = p

    out: dict[str, Any] = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def prune_to_structure(converted: dict, initialized: dict) -> dict:
    """Drop converted entries the module does not define (e.g. the
    classifier head when loading top-ful weights into include_top=False).
    Missing entries still fail later in check_variables_match."""
    out: dict[str, Any] = {}
    for col, leaves in converted.items():
        if col not in initialized:
            continue
        out[col] = {k: v for k, v in leaves.items() if k in initialized[col]}
    return out


def _flat_shapes(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat_shapes(v, path) if isinstance(v, dict)
                   else {path: tuple(np.shape(v))})
    return out


def check_variables_match(converted: dict, initialized: dict) -> None:
    """Raise with a readable diff if converted shapes/names disagree with a
    module's own — the converter's first line of defense."""
    conv_flat, init_flat = _flat_shapes(converted), _flat_shapes(initialized)
    missing = sorted(set(init_flat) - set(conv_flat))
    extra = sorted(set(conv_flat) - set(init_flat))
    mismatched = sorted(
        k for k in set(conv_flat) & set(init_flat) if conv_flat[k] != init_flat[k]
    )
    if missing or extra or mismatched:
        lines = []
        for k in missing[:12]:
            lines.append(f"  missing from conversion: {k} {init_flat[k]}")
        for k in extra[:12]:
            lines.append(f"  extra in conversion:     {k} {conv_flat[k]}")
        for k in mismatched[:12]:
            lines.append(
                f"  shape mismatch: {k} converted {conv_flat[k]} vs init {init_flat[k]}"
            )
        raise ValueError("Keras->torch conversion mismatch:\n" + "\n".join(lines))


def module_variables(module) -> dict:
    """A zoo module's own parameters as the Flax-shaped tree the converter
    produces: a BatchNorm has a ``scale`` unless its weight is fixed
    (``requires_grad`` off: Keras' ``scale=False``, ``common.make_conv_bn``)."""
    from torch import nn

    from sparkdl_torch.models.convert import torch_to_flax

    tree = torch_to_flax(module.state_dict())
    for name, m in module.named_children():
        if isinstance(m, nn.BatchNorm2d) and m.weight.requires_grad:
            tree["params"][name]["scale"] = m.weight.detach().cpu().numpy()
    return tree


def load_keras_weights(module, graph: KerasGraph, layer_order: str = "topo"):
    """Load ``graph``'s weights into the zoo ``module`` (in place; returns
    it): Keras -> Flax-shaped variables -> state_dict, dropping what the
    module does not define (a classifier head) and refusing any name or
    shape that disagrees."""
    from sparkdl_torch.models.convert import flax_to_torch

    expected = module_variables(module)
    variables = prune_to_structure(keras_to_flax_variables(graph, layer_order),
                                   expected)
    check_variables_match(variables, expected)
    module.load_state_dict(flax_to_torch(variables, module=module))
    return module


# ---------------------------------------------------------------------------
# the estimator's writer
# ---------------------------------------------------------------------------

def write_keras_weights(model_file: str, graph_module, out_path: str) -> str:
    """Load the Keras model of ``model_file``, set each weight-bearing
    layer's weights from ``graph_module`` (a ``KerasGraphModule`` built
    from that model), and save it to ``out_path`` (``.keras``)."""
    model = load_keras_model_file(model_file)
    weights = graph_module.keras_weights()
    names = {lyr.name for lyr in model.layers}
    if not set(weights) <= names:
        raise ValueError(f"layers {sorted(set(weights) - names)} are not in "
                         f"{model_file}")
    for lyr in model.layers:
        if lyr.name in weights:
            lyr.set_weights(weights[lyr.name])
    model.save(out_path)
    return out_path
