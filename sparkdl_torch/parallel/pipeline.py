"""Pipeline parallelism over the ``pp`` mesh axis: the port of
``sparkdl_tpu.parallel.pipeline``.

The GPipe schedule of the reference's ``_pipeline_local``: ``pp``
stages, one per ``pp`` peer, each holding one stage's parameters;
microbatches stream through in ``num_mb + pp - 1`` ticks. At tick ``t``
stage ``i`` works on microbatch ``t - i`` where there is one: stage 0
injects it from the input, a later stage receives it from the stage
before (``recv`` on the ``pp`` group), and the last stage commits its
output; every other stage sends its output on. The reference computes
every stage at every tick and masks the fill and drain ticks out; the
port skips them. At the end the last stage's outputs are broadcast to
every stage.

The whole schedule is one ``autograd.Function``: the forward keeps each
tick's graph, and the backward runs the ticks in reverse, receiving
each output's gradient from the next stage and sending each input's
gradient to the one before. The input and the stacked parameters are
taken as every rank holds them whole (the reference's replicated
``shard_map`` inputs), so each rank gets the whole gradient of the
(same) loss: its stage's slice of the parameters' gradient gathered
over ``pp``, and the input's gradient broadcast from stage 0.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from sparkdl_torch.parallel.collectives import (
    AxisGroup,
    _all_reduce,
    axis_group,
    split_replicated,
)
from sparkdl_torch.runtime.mesh import Mesh
from sparkdl_torch.runtime.tree import tree_leaves, tree_map

__all__ = ["stack_stage_params", "pipeline_apply"]


def stack_stage_params(per_stage_params: "list[Any]") -> Any:
    """Stack per-stage parameter trees along a new leading (pp) dim."""
    first = per_stage_params[0]
    leaves = [tree_leaves(p) for p in per_stage_params]
    stacked = iter([torch.stack(xs) for xs in zip(*leaves)])
    return tree_map(lambda _: next(stacked), first)


def _unflatten(tree: Any, leaves: "list[torch.Tensor]") -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, structure, ag, x_mb, *params):
        import torch.distributed as dist

        pp, i = ag.size, ag.index
        num_mb = x_mb.shape[0]
        first, last = i == 0, i == pp - 1
        ticks = []
        outs: "list[torch.Tensor | None]" = [None] * num_mb
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
            tree = _unflatten(structure, leaves)
            for t in range(num_mb + pp - 1):
                j = t - i
                if not 0 <= j < num_mb:
                    continue  # a fill or drain tick: this stage idles
                if first:
                    inp = x_mb[j].detach().requires_grad_(x_mb.requires_grad)
                else:
                    inp = torch.empty_like(x_mb[0])
                    dist.recv(inp, ag.rank_at(i - 1), group=ag.group)
                    inp.requires_grad_(True)
                y = stage_fn(tree, inp)
                if y.shape != inp.shape or y.dtype != inp.dtype:
                    raise ValueError(
                        f"stage output {tuple(y.shape)} {y.dtype} differs from its "
                        f"input {tuple(inp.shape)} {inp.dtype}: every stage must map "
                        "activations to activations of the same shape")
                ticks.append((j, inp, y))
                if last:
                    outs[j] = y.detach()
                else:
                    dist.send(y.detach().contiguous(), ag.rank_at(i + 1), group=ag.group)
        out = (torch.stack(outs) if last
               else torch.empty_like(x_mb))
        if pp > 1:
            dist.broadcast(out, ag.rank_at(pp - 1), group=ag.group)
        ctx.ticks, ctx.leaves, ctx.ag = ticks, leaves, ag
        ctx.x_mb_shape, ctx.x_dtype = x_mb.shape, x_mb.dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        import torch.distributed as dist

        ag, leaves = ctx.ag, ctx.leaves
        pp, i = ag.size, ag.index
        first, last = i == 0, i == pp - 1
        grads = [torch.zeros_like(p) for p in leaves]
        dx = torch.zeros(ctx.x_mb_shape, dtype=ctx.x_dtype, device=dout.device)
        for j, inp, y in reversed(ctx.ticks):
            if last:
                dy = dout[j]
            else:
                dy = torch.empty_like(y)
                dist.recv(dy, ag.rank_at(i + 1), group=ag.group)
            wrt = ([inp] if inp.requires_grad else []) + [
                p for p in leaves if p.requires_grad]
            if not wrt:
                continue
            got = list(torch.autograd.grad(y, wrt, dy, allow_unused=True))
            d_inp = got.pop(0) if inp.requires_grad else None
            rest = iter(got)
            for n, p in enumerate(leaves):
                if p.requires_grad:
                    g = next(rest)
                    if g is not None:
                        grads[n] += g
            d_inp = torch.zeros_like(inp) if d_inp is None else d_inp
            if first:
                dx[j] = d_inp
            else:
                dist.send(d_inp.contiguous(), ag.rank_at(i - 1), group=ag.group)
        ctx.ticks = None
        dx = _all_reduce(dx, ag)  # stage 0's, on every stage
        return (None, None, None, dx, *grads)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any, x: torch.Tensor,
                   mesh: "Mesh | None" = None, *, num_microbatches: int,
                   axis_name: str = "pp") -> torch.Tensor:
    """Run ``x`` through ``pp`` chained stages of ``stage_fn(params, x)``.

    ``stacked_params``: the per-stage trees stacked on dim 0 (its length
    the ``pp`` axis size of ``mesh``, default the ambient mesh; see
    :func:`stack_stage_params`), every rank holding all of it. Each stage
    maps activations to activations of the same shape and dtype.
    ``x``: [B, ...] with B divisible by ``num_microbatches``. Returns the
    last stage's [B, ...] on every rank; differentiable.
    """
    if x.shape[0] % num_microbatches:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by microbatches {num_microbatches}")
    ag: AxisGroup = axis_group(axis_name, mesh)
    leaves = tree_leaves(stacked_params)
    if any(p.shape[0] != ag.size for p in leaves):
        raise ValueError(
            f"stacked params lead with {sorted({p.shape[0] for p in leaves})} "
            f"stages, the {axis_name!r} axis has {ag.size}")
    mine = [split_replicated(p, ag, 0)[0] for p in leaves]
    x_mb = x.reshape((num_microbatches, x.shape[0] // num_microbatches)
                     + tuple(x.shape[1:]))
    out = _Pipeline.apply(stage_fn, stacked_params, ag, x_mb, *mine)
    return out.reshape((x.shape[0],) + tuple(out.shape[2:]))
