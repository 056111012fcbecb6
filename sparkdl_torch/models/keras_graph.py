"""Any Keras model of a small layer surface, run as torch ops.

The port's counterpart of "Keras runs the model natively"
(``sparkdl_tpu/transformers/keras_tensor.py``): :class:`KerasGraphModule`
is built from a :class:`~sparkdl_torch.models.keras_loader.KerasGraph`
(the model's config and weights as plain data) and walks its layer graph
with torch ops, on the card or the CPU. It never imports Keras, so a
``KerasGraph`` written in code runs where Keras is not installed.

Tensors keep Keras' layouts: the input is NHWC, every layer sees and
returns its Keras shape, so axes in the config (BatchNormalization's,
Concatenate's, a Dense on a rank-3 input, Flatten's row-major order) mean
what they mean in Keras. Convolutions and pooling view NHWC as NCHW in
channels_last memory (a permute, no copy) around the torch call.

Keras semantics the ops keep:

- ``padding="same"`` is TF-SAME: at stride 2 the extra pixel goes after;
  max pooling pads with -inf and average pooling leaves the pad out of
  the divisor (``models/common``'s ``conv2d_tf``, ``max_pool`` and
  ``avg_pool_keras``, which the zoo runs too);
- BatchNormalization takes epsilon and momentum from each layer's config;
  in training it normalizes with the batch mean and the biased variance
  and moves the moving statistics by the layer's momentum (Keras'
  two-pass ``moments``, ``common.bn_moments(centered=True)``; not
  ``F.batch_norm(training=True)``, which moves the unbiased variance); a
  layer with ``trainable=False`` stays in inference
  mode, as in Keras.

Outside the surface (:data:`LAYER_SURFACE`), and for channels_first data,
dilation, several inputs or outputs, shared layers, regularizers and
constraints, construction raises ``NotImplementedError`` naming ROADMAP
A3: the port never falls back to running Keras itself.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_torch.models.common import (
    avg_pool_keras,
    bn_moments,
    conv2d_tf,
    max_pool,
    pair,
)
from sparkdl_torch.models.keras_loader import KerasGraph, layer_name
from sparkdl_torch.ops._dispatch import resolve_device

LAYER_SURFACE = frozenset({
    "InputLayer", "Dense", "Conv2D", "DepthwiseConv2D", "SeparableConv2D",
    "BatchNormalization", "Activation", "ReLU", "Softmax", "Flatten",
    "Reshape", "Dropout", "ZeroPadding2D", "MaxPooling2D", "AveragePooling2D",
    "GlobalAveragePooling2D", "GlobalMaxPooling2D", "Add", "Concatenate",
})

_WEIGHTED = frozenset({"Dense", "Conv2D", "DepthwiseConv2D", "SeparableConv2D",
                       "BatchNormalization"})

_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": torch.relu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


def _outside(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is outside the port's Keras layer surface (ROADMAP A3); "
        f"supported layers: {sorted(LAYER_SURFACE)}")


def _activation(name) -> Any:
    if not isinstance(name, str) or name not in _ACTIVATIONS:
        raise _outside(f"activation {name!r}")
    return _ACTIVATIONS[name]


def _check_config(cls: str, name: str, cfg: dict) -> None:
    if cls not in LAYER_SURFACE:
        raise _outside(f"layer {name!r} of class {cls}")
    if cfg.get("data_format", "channels_last") != "channels_last":
        raise _outside(f"{cls} {name!r} with data_format={cfg['data_format']!r}")
    if pair(cfg.get("dilation_rate", 1)) != (1, 1):
        raise _outside(f"{cls} {name!r} with dilation_rate={cfg['dilation_rate']}")
    for key, value in cfg.items():
        if key.endswith(("_regularizer", "_constraint")) and value is not None:
            raise _outside(f"{cls} {name!r} with {key}")
    if cls == "Dropout" and cfg.get("noise_shape") is not None:
        raise _outside(f"Dropout {name!r} with a noise_shape")
    if "activation" in cfg:
        _activation(cfg["activation"])


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _Layer(nn.Module):
    """The parameters of one weight-bearing Keras layer, in torch layouts."""

    def __init__(self, cls: str, cfg: dict, weights: list):
        super().__init__()
        self.cls = cls
        w = [torch.from_numpy(np.array(a, dtype=np.float32)) for a in weights]
        trainable = bool(cfg.get("trainable", True))
        self.trainable = trainable

        def param(t):
            return nn.Parameter(t.contiguous(), requires_grad=trainable)

        i = 0
        if cls == "BatchNormalization":
            if cfg.get("scale", True):
                self.gamma, i = param(w[i]), i + 1
            if cfg.get("center", True):
                self.beta, i = param(w[i]), i + 1
            self.register_buffer("moving_mean", w[i].clone())
            self.register_buffer("moving_var", w[i + 1].clone())
            return
        if cls == "Dense":  # (in, out) -> [out, in]
            self.weight, i = param(w[0].T), 1
        elif cls == "Conv2D":  # (kh, kw, in/groups, out) -> OIHW
            self.weight, i = param(w[0].permute(3, 2, 0, 1)), 1
        elif cls in ("DepthwiseConv2D", "SeparableConv2D"):
            # (kh, kw, C, mult) -> [C*mult, 1, kh, kw], output c*mult + m as Keras
            kh, kw, c, mult = w[0].shape
            self.keras_channels = c
            self.depthwise = param(w[0].reshape(kh, kw, c * mult).permute(2, 0, 1)
                                   .unsqueeze(1))
            i = 1
            if cls == "SeparableConv2D":  # pointwise (1, 1, C*mult, out)
                self.weight, i = param(w[1].permute(3, 2, 0, 1)), 2
        if cfg.get("use_bias", True):
            self.bias = param(w[i])

    def keras_weights(self) -> list:
        """This layer's weights as ``get_weights()`` lists them."""
        def a(t):
            return t.detach().float().cpu().numpy()

        if self.cls == "BatchNormalization":
            out = [a(getattr(self, n)) for n in ("gamma", "beta") if hasattr(self, n)]
            return out + [a(self.moving_mean), a(self.moving_var)]
        out = []
        if hasattr(self, "depthwise"):
            cm, _, kh, kw = self.depthwise.shape
            c = self.keras_channels
            out.append(a(self.depthwise[:, 0].permute(1, 2, 0)).reshape(kh, kw, c, cm // c))
        if hasattr(self, "weight"):
            w = self.weight
            out.append(a(w.T) if self.cls == "Dense" else a(w.permute(2, 3, 1, 0)))
        if hasattr(self, "bias"):
            out.append(a(self.bias))
        return out


class _Node:
    """One call of a layer: its class, config and inputs (node keys)."""

    def __init__(self, key, cls: str, cfg: dict, inputs: list):
        self.key, self.cls, self.cfg, self.inputs = key, cls, cfg, inputs


def _history(args) -> list:
    """The ``keras_history`` (layer, node, tensor) of every
    ``__keras_tensor__`` in a node's args, in order."""
    if isinstance(args, dict):
        if args.get("class_name") == "__keras_tensor__":
            return [tuple(args["config"]["keras_history"])]
        return [h for v in args.values() for h in _history(v)]
    if isinstance(args, (list, tuple)):
        return [h for v in args for h in _history(v)]
    return []


def _parse(graph: KerasGraph) -> tuple[list, Any, Any]:
    """(nodes in an order where each input comes first, input key, output
    key) of a Sequential or functional config."""
    nodes = []
    if graph.sequential:
        prev = ("__input__", 0)
        for entry in graph.layers:
            if entry["class_name"] == "InputLayer":
                continue
            key = (layer_name(entry), 0)
            nodes.append(_Node(key, entry["class_name"], entry["config"], [prev]))
            prev = key
        return nodes, ("__input__", 0), prev
    for entry in graph.layers:
        inbound = entry.get("inbound_nodes", [])
        if len(inbound) > 1:
            raise _outside(f"shared layer {layer_name(entry)!r} (called "
                           f"{len(inbound)} times)")
        inputs = []
        for lyr, node, tensor in _history(inbound[0] if inbound else []):
            if tensor != 0:
                raise _outside(f"layer {lyr!r} with several outputs")
            inputs.append((lyr, node))
        nodes.append(_Node((layer_name(entry), 0), entry["class_name"],
                           entry["config"], inputs))

    def single(spec, what):
        if spec and not isinstance(spec[0], str):
            if len(spec) != 1:
                raise _outside(f"a model with {len(spec)} {what}")
            spec = spec[0]
        return (spec[0], spec[1])

    key_in = single(graph.config["input_layers"], "inputs")
    key_out = single(graph.config["output_layers"], "outputs")
    done, ordered, pending = {key_in}, [], [n for n in nodes if n.key != key_in]
    while pending:
        ready = [n for n in pending if all(k in done for k in n.inputs)]
        if not ready:
            raise ValueError("the Keras config's layer graph has a cycle or a "
                             "missing input")
        for n in ready:
            done.add(n.key)
        ordered += ready
        pending = [n for n in pending if n.key not in done]
    return ordered, key_in, key_out


class KerasGraphModule(nn.Module):
    """``forward(x, training=False)``: the Keras model of ``graph`` on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``). ``x``
    has the Keras input's shape (NHWC for images); the output has the
    Keras output's. ``training=True`` is Keras' training mode (batch
    statistics, dropout)."""

    def __init__(self, graph: KerasGraph, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.nodes, self.key_in, self.key_out = _parse(graph)
        self.layer_keys: dict[str, str] = {}
        self.params = nn.ModuleDict()
        for node in self.nodes:
            name = node.key[0]
            _check_config(node.cls, name, node.cfg)
            weights = graph.weights.get(name)
            if node.cls in _WEIGHTED and not weights:
                raise ValueError(f"the KerasGraph has no weights for {node.cls} {name!r}")
            if weights:
                key = f"l{len(self.params)}"  # Keras names may hold '.'
                self.layer_keys[name] = key
                self.params[key] = _Layer(node.cls, node.cfg, weights)
        self.to(dev)

    def keras_weights(self) -> dict:
        """Layer name -> its weights in Keras' layouts and order."""
        return {name: self.params[key].keras_weights()
                for name, key in self.layer_keys.items()}

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        values = {self.key_in: x.to(torch.float32)}
        for node in self.nodes:
            key = self.layer_keys.get(node.key[0])
            layer = None if key is None else self.params[key]
            values[node.key] = getattr(self, "_" + node.cls)(
                node.cfg, layer, [values[k] for k in node.inputs], training)
        return values[self.key_out]

    # -- the layer surface: (config, params, inputs, training) -> output --

    @staticmethod
    def _Dense(cfg, p, xs, training):
        y = F.linear(xs[0], p.weight, getattr(p, "bias", None))
        return _activation(cfg.get("activation", "linear"))(y)

    @staticmethod
    def _conv_like(cfg, p, x, depthwise: bool):
        strides = pair(cfg.get("strides", 1))
        padding = cfg.get("padding", "valid").upper()
        h = _nchw(x)
        if depthwise:
            h = conv2d_tf(h, p.depthwise, None, strides, padding, groups=x.shape[-1])
            if hasattr(p, "weight"):  # SeparableConv2D's pointwise 1x1
                h = F.conv2d(h, p.weight)
        else:
            h = conv2d_tf(h, p.weight, None, strides, padding,
                          groups=int(cfg.get("groups", 1)))
        if hasattr(p, "bias"):
            h = h + p.bias[:, None, None]
        return _activation(cfg.get("activation", "linear"))(_nhwc(h))

    @staticmethod
    def _Conv2D(cfg, p, xs, training):
        return KerasGraphModule._conv_like(cfg, p, xs[0], depthwise=False)

    @staticmethod
    def _DepthwiseConv2D(cfg, p, xs, training):
        return KerasGraphModule._conv_like(cfg, p, xs[0], depthwise=True)

    _SeparableConv2D = _DepthwiseConv2D

    @staticmethod
    def _BatchNormalization(cfg, p, xs, training):
        x = xs[0]
        axis = cfg.get("axis", -1)
        if isinstance(axis, (list, tuple)):
            if len(axis) != 1:
                raise _outside(f"BatchNormalization over axes {axis}")
            axis = axis[0]
        axis %= x.dim()
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        eps = float(cfg.get("epsilon", 1e-3))
        if training and p.trainable:
            mean, var = bn_moments(x, tuple(d for d in range(x.dim()) if d != axis),
                                   centered=True)
            m = float(cfg.get("momentum", 0.99))
            with torch.no_grad():
                p.moving_mean.copy_(p.moving_mean * m + mean.detach() * (1.0 - m))
                p.moving_var.copy_(p.moving_var * m + var.detach() * (1.0 - m))
        else:
            mean, var = p.moving_mean, p.moving_var
        inv = torch.rsqrt(var + eps)
        if hasattr(p, "gamma"):
            inv = inv * p.gamma
        shift = -mean * inv
        if hasattr(p, "beta"):
            shift = shift + p.beta
        return x * inv.view(shape) + shift.view(shape)

    @staticmethod
    def _Activation(cfg, p, xs, training):
        return _activation(cfg["activation"])(xs[0])

    @staticmethod
    def _ReLU(cfg, p, xs, training):
        x = xs[0]
        threshold = float(cfg.get("threshold", 0.0))
        slope = float(cfg.get("negative_slope", 0.0))
        y = torch.where(x >= threshold, x, slope * (x - threshold))
        if cfg.get("max_value") is not None:
            y = torch.clamp(y, max=float(cfg["max_value"]))
        return y

    @staticmethod
    def _Softmax(cfg, p, xs, training):
        axis = cfg.get("axis", -1)
        if isinstance(axis, (list, tuple)):
            if len(axis) != 1:
                raise _outside(f"Softmax over axes {axis}")
            axis = axis[0]
        return torch.softmax(xs[0], dim=axis)

    @staticmethod
    def _Flatten(cfg, p, xs, training):
        return xs[0].reshape(xs[0].shape[0], -1)  # row-major over Keras' NHWC

    @staticmethod
    def _Reshape(cfg, p, xs, training):
        return xs[0].reshape(xs[0].shape[0], *cfg["target_shape"])

    @staticmethod
    def _Dropout(cfg, p, xs, training):
        return F.dropout(xs[0], float(cfg["rate"]), training=training)

    @staticmethod
    def _ZeroPadding2D(cfg, p, xs, training):
        pad = cfg["padding"]
        (top, bottom), (left, right) = (
            ((pad, pad), (pad, pad)) if isinstance(pad, int)
            else (pair(pad[0]), pair(pad[1])))
        return F.pad(xs[0], (0, 0, left, right, top, bottom))

    @staticmethod
    def _pool(cfg, x, kind: str):
        kernel = pair(cfg["pool_size"])
        strides = pair(cfg.get("strides") or kernel)
        pool = max_pool if kind == "max" else avg_pool_keras
        return _nhwc(pool(_nchw(x), kernel, strides, cfg.get("padding", "valid").upper()))

    @staticmethod
    def _MaxPooling2D(cfg, p, xs, training):
        return KerasGraphModule._pool(cfg, xs[0], "max")

    @staticmethod
    def _AveragePooling2D(cfg, p, xs, training):
        return KerasGraphModule._pool(cfg, xs[0], "avg")

    @staticmethod
    def _GlobalAveragePooling2D(cfg, p, xs, training):
        return xs[0].mean(dim=(1, 2), keepdim=bool(cfg.get("keepdims", False)))

    @staticmethod
    def _GlobalMaxPooling2D(cfg, p, xs, training):
        return xs[0].amax(dim=(1, 2), keepdim=bool(cfg.get("keepdims", False)))

    @staticmethod
    def _Add(cfg, p, xs, training):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

    @staticmethod
    def _Concatenate(cfg, p, xs, training):
        return torch.cat(xs, dim=int(cfg.get("axis", -1)))
