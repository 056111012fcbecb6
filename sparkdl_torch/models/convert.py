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
