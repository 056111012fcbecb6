"""Weights made from the seed, on the device, in a few large calls.

Every leaf of a reference module's state dict gets a value by a rule on
its name: He-normal conv kernels (std sqrt(2 / fan_in)), LeCun-normal
dense kernels, small normal biases, BatchNorm shifts and running means,
running variances uniform in [0.5, 1.5) and scales near 1 (a scale the
model keeps fixed, as Keras' ``scale=False``, stays 1). The draws are two
calls on one seeded generator on the device, one normal and one uniform,
so the same seed gives the same weights in every process. The program
and the reference are both handed these tensors; neither makes its own.
"""

from __future__ import annotations

import torch
from torch import nn

#: generator streams drawn from one seed: weights and data never share one
WEIGHTS_STREAM, DATA_STREAM = 1, 2


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for (seed, stream)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def _rule(name: str, leaf: torch.Tensor, frozen: bool) -> "tuple[str, float, float]":
    """(draw, scale, offset): the leaf is offset + scale * draw, the draw
    "normal", "uniform" or "keep" (left as the module built it)."""
    kind = name.rsplit(".", 1)[-1]
    if not leaf.is_floating_point() or frozen:
        return "keep", 0.0, 0.0
    if kind == "weight" and leaf.dim() == 4:
        return "normal", (2.0 / leaf[0].numel()) ** 0.5, 0.0
    if kind == "weight" and leaf.dim() == 2:
        return "normal", (1.0 / leaf.shape[1]) ** 0.5, 0.0
    if kind == "weight":     # a BatchNorm scale
        return "normal", 0.1, 1.0
    if kind == "running_var":
        return "uniform", 1.0, 0.5
    if kind in ("bias", "running_mean"):
        return "normal", 0.1, 0.0
    raise ValueError(f"no weight rule for {name!r}")


def make_state(module: nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """A full state dict for ``module`` (built anywhere, the meta device
    included) on ``device``, from ``seed``."""
    frozen = {n for n, p in module.named_parameters() if not p.requires_grad}
    plan = []
    sizes = {"normal": 0, "uniform": 0}
    for name, leaf in module.state_dict().items():
        draw, scale, offset = _rule(name, leaf, name in frozen)
        plan.append((name, leaf, draw, scale, offset))
        if draw != "keep":
            sizes[draw] += leaf.numel()
    g = generator(seed, WEIGHTS_STREAM, device)
    pools = {
        "normal": torch.randn(sizes["normal"], generator=g, device=device),
        "uniform": torch.rand(sizes["uniform"], generator=g, device=device),
    }
    used = {"normal": 0, "uniform": 0}
    state = {}
    for name, leaf, draw, scale, offset in plan:
        if draw == "keep":
            state[name] = (torch.ones(leaf.shape, device=device) if name in frozen
                           else torch.zeros(leaf.shape, dtype=leaf.dtype, device=device))
            continue
        n = leaf.numel()
        flat = pools[draw][used[draw]:used[draw] + n]
        used[draw] += n
        state[name] = (flat * scale + offset).view(leaf.shape)
    return state
