"""Expert parallelism: mixture-of-experts MLPs split over ``ep``, the
port of ``sparkdl_tpu.parallel.expert_parallel``.

The GShard/Switch token-choice form, as the reference writes it:

- the router runs in float32; token groups are the leading dims of the
  input, ``s`` tokens each, and each expert takes at most
  ``max(1, ceil(s * k / E * capacity_factor))`` tokens of a group;
- :func:`top_k_dispatch` turns the gates into dense ``combine`` and
  ``dispatch`` tensors of static shape (top-k and capacity overflow are
  masks, not gathers of data-dependent size), so a CUDA graph of the
  layer needs nothing from the host;
- the expert weights are stacked on a leading expert dim, ``wi [E, M,
  H]`` and ``wo [E, H, M]``, and tokens move to and from the experts by
  the reference's einsums.

With ``ep > 1`` each rank holds ``E/ep`` experts. The reference's GSPMD
inserts an all-to-all where the token batch is split and the expert dim
too; here it is written out: the dispatched ``[E, G, C, M]`` buffer goes
to the experts' owners by an all-to-all over the ``ep`` group
(``collectives.all_to_all``), each rank runs its experts over every
rank's tokens, and a second all-to-all brings the outputs back. Each ``ep`` rank feeds its own
tokens (as a data axis); the groups all ranks feed must have the same
shape.

The reference sows its Switch load-balancing loss and router z-loss into
Flax's ``intermediates``. The port's one channel: each
:class:`MoEMlpBlock` keeps the two from its last forward as
``block.aux_loss`` and ``block.router_z_loss`` (tensors in the autograd
graph of that forward), and :func:`moe_aux_losses` sums them over a
model's blocks.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from sparkdl_torch.ops._dispatch import resolve_device
from sparkdl_torch.parallel.collectives import AxisGroup, all_to_all, axis_group
from sparkdl_torch.runtime.mesh import Mesh, current_mesh

__all__ = ["top_k_dispatch", "MoEMlpBlock", "moe_aux_losses"]


def top_k_dispatch(gates: torch.Tensor, k: int, capacity: int
                   ) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """Token-choice top-k assignment with a per-expert capacity.

    gates: [G, S, E] router probabilities (float32). Returns (combine
    [G, S, E, C] float32: the gate of token s in slot c of expert e, zero
    where unrouted or dropped; dispatch [G, S, E, C] bool: combine > 0;
    aux_loss: the Switch load-balancing loss, 1.0 when balanced).

    Tokens pick experts greedily (slot 0 the argmax, slot 1 the next,
    ...); positions inside an expert's capacity go in token order (a
    cumsum), and a token past capacity is dropped for that slot. A gate
    is read from the masked gates, so a token whose remaining gates have
    underflowed to 0 adds nothing (its argmax says expert 0; the unmasked
    gate would count that expert twice).
    """
    g, s, e = gates.shape
    if not 1 <= k <= e:
        raise ValueError(f"k={k} must be in [1, num_experts={e}]")
    combine = gates.new_zeros((g, s, e, capacity), dtype=torch.float32)
    counts = gates.new_zeros((g, e), dtype=torch.float32)
    masked = gates
    first_choice = None
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)  # [G, S]
        onehot = F.one_hot(idx, e).to(torch.float32)  # [G, S, E]
        if first_choice is None:
            first_choice = onehot
        pos = torch.cumsum(onehot, dim=1) - onehot + counts[:, None, :]
        pos_tok = (pos * onehot).sum(dim=-1)  # [G, S]
        within = (pos_tok < capacity).to(torch.float32)
        gate_val = (masked * onehot).sum(dim=-1)  # [G, S]
        # one_hot of a position >= capacity is all zeros, as jax's is
        cap_onehot = (pos_tok.to(torch.long)[..., None]
                      == torch.arange(capacity, device=gates.device)).to(torch.float32)
        combine = combine + ((gate_val * within)[:, :, None, None]
                             * onehot[:, :, :, None] * cap_onehot[:, :, None, :])
        counts = counts + onehot.sum(dim=1)
        masked = masked * (1.0 - onehot)
    dispatch = combine > 0.0
    density = first_choice.mean(dim=1)  # [G, E]
    density_proxy = gates.mean(dim=1)
    aux_loss = (density * density_proxy).mean() * (e ** 2)
    return combine, dispatch, aux_loss


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu default


class MoEMlpBlock(nn.Module):
    """Mixture-of-experts MLP: router, top-k dispatch, per-expert
    up/activation/down, weighted combine. A drop-in for a dense MLP on
    [..., S, M] activations (a 2-D [N, M] input is one group).

    Parameters: ``router.weight`` [E, M] (float32, no bias), ``wi`` [E/ep,
    M, H] and ``wo`` [E/ep, H, M], this rank's experts of the ``ep`` axis
    of ``mesh`` (default the ambient mesh), on ``device`` (the card
    unless the caller asks for ``"cpu"``). A dropped token gets zero
    output for that slot: pair the block with a residual connection.
    After each forward, ``aux_loss`` and ``router_z_loss`` hold its
    losses (:func:`moe_aux_losses`).
    """

    def __init__(self, in_features: int, num_experts: int, hidden_features: int,
                 *, k: int = 2, capacity_factor: float = 1.25,
                 ep_axis: str = "ep",
                 activation: Callable[[torch.Tensor], torch.Tensor] = _gelu_tanh,
                 mesh: "Mesh | None" = None, device="cuda", dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        mesh = mesh if mesh is not None else current_mesh()
        ep = (int(mesh.shape[ep_axis]) if mesh is not None
              and ep_axis in mesh.axis_names else 1)
        if num_experts % ep:
            raise ValueError(
                f"num_experts {num_experts} is not divisible by the {ep}-way "
                f"{ep_axis!r} axis")
        self.num_experts, self.k = num_experts, k
        self.capacity_factor = capacity_factor
        self.mesh, self.ep_axis, self.ep = mesh, ep_axis, ep
        self.activation = activation
        self.router = nn.Linear(in_features, num_experts, bias=False,
                                device=device, dtype=torch.float32)
        local = num_experts // ep
        self.wi = nn.Parameter(torch.empty((local, in_features, hidden_features),
                                           device=device, dtype=dtype))
        self.wo = nn.Parameter(torch.empty((local, hidden_features, in_features),
                                           device=device, dtype=dtype))
        bound = 1.0 / math.sqrt(in_features)
        nn.init.uniform_(self.wi, -bound, bound)
        nn.init.uniform_(self.wo, -1.0 / math.sqrt(hidden_features),
                         1.0 / math.sqrt(hidden_features))
        self._ag: "AxisGroup | None" = None
        self.aux_loss: "torch.Tensor | None" = None
        self.router_z_loss: "torch.Tensor | None" = None

    def split_params(self) -> "dict[str, int]":
        """``{parameter name: the dim split over ep}``: the expert stacks."""
        return {"wi": 0, "wo": 0}

    def capacity(self, s: int) -> int:
        """Slots per expert for a group of ``s`` tokens."""
        return max(1, math.ceil(s * self.k / self.num_experts * self.capacity_factor))

    def _experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        """[E, G, C, M] buffers through this rank's experts, the owners
        reached by all-to-all over ``ep``."""
        if self.ep == 1:
            h = self.activation(torch.einsum("egcm,emh->egch", expert_in, self.wi))
            return torch.einsum("egch,ehm->egcm", h, self.wo)
        if self._ag is None:
            self._ag = axis_group(self.ep_axis, self.mesh)
        ep, (e, g, c, m) = self.ep, expert_in.shape
        local = e // ep
        # chunk j of the expert dim goes to peer j; what comes back is
        # [source peer, my experts, G, C, M]
        mine = all_to_all(expert_in, self._ag).view(ep, local, g, c, m)
        mine = mine.transpose(0, 1).reshape(local, ep * g, c, m)
        h = self.activation(torch.einsum("egcm,emh->egch", mine, self.wi))
        out = torch.einsum("egch,ehm->egcm", h, self.wo)
        out = out.view(local, ep, g, c, m).transpose(0, 1).reshape(e, g, c, m)
        return all_to_all(out, self._ag)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        lead = x.shape[:-2]
        g = math.prod(lead) if lead else 1
        s, m = x.shape[-2], x.shape[-1]
        tokens = x.reshape(g, s, m)
        logits = self.router(tokens.float())  # float32 router
        gates = torch.softmax(logits, dim=-1)
        combine, dispatch, aux = top_k_dispatch(gates, self.k, self.capacity(s))
        self.aux_loss = aux
        self.router_z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
        dt = self.wi.dtype
        expert_in = torch.einsum("gsec,gsm->egcm", dispatch.to(dt), tokens.to(dt))
        expert_out = self._experts(expert_in)
        y = torch.einsum("gsec,egcm->gsm", combine.to(dt), expert_out)
        y = y.reshape(x.shape)
        return y[0] if squeeze else y


def moe_aux_losses(model: nn.Module) -> "dict[str, torch.Tensor]":
    """The sum of every :class:`MoEMlpBlock`'s ``aux_loss`` and
    ``router_z_loss`` from its last forward, over ``model``'s blocks
    (zeros where none ran). Add ``alpha * aux_loss + beta *
    router_z_loss`` to the task loss, as the reference's users do."""
    out = {"aux_loss": torch.zeros(()), "router_z_loss": torch.zeros(())}
    for mod in model.modules():
        if isinstance(mod, MoEMlpBlock):
            for key in out:
                val = getattr(mod, key)
                if val is not None:
                    out[key] = out[key].to(val.device) + val
    return out
