"""Collectives over one mesh dimension's process group, with gradients.

Where ``repro`` lets GSPMD insert the collectives of a sharded step, the
port calls them by hand, and each is an ``autograd.Function`` whose
backward is the collective that transposes it.  Two of them differ only in
their backward, after the convention of Megatron's tensor parallelism: a
*replicated* activation (every rank of the group holds the same value)
carries its full gradient on every rank, a *sharded* one the gradient of
its own shard, and a *partial* one (a row-parallel product before its
sum) the full gradient of the sum on every rank.  So:

* ``all_reduce``: partial -> replicated; the backward passes the gradient
  through.
* ``copy``: replicated -> the input of a per-rank computation (a
  column-parallel product, a parameter used on this rank's tokens only);
  the identity forward, an all-reduce of the partial gradients backward.
* ``reduce_scatter(dim)``: partial -> sharded on ``dim``; all-gather back.
* ``all_gather(dim)``: sharded -> the input of a per-rank computation;
  reduce-scatter back.  ``all_gather(dim, replicated=True)``: sharded ->
  replicated, for a computation every rank repeats; each rank keeps its
  own slice of the gradient.
* ``split(dim)``: replicated -> sharded, this rank's slice; all-gather
  back.
* ``all_to_all_single``: equal blocks along dim 0 swapped between ranks;
  the same exchange carries the gradients home.

The collective names (``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single``) exist in every PyTorch
this repository runs on, on ``nccl`` and on ``gloo``.  ``CALLS`` counts
each forward call by name (a backward call is not counted), so a run can
show which collectives a sharded path launched; ``reset_calls`` zeroes it.
A group of one rank still runs every collective.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

#: forward calls of each collective since the last ``reset_calls``
CALLS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                         "reduce_scatter": 0, "all_to_all_single": 0}


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def _count(name: str) -> None:
    CALLS[name] += 1


# ------------------------------------------------------- raw collectives
def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    _count("all_reduce")
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    _count("all_gather")
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    _count("reduce_scatter")
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"split: dim {dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    k = x.shape[dim] // n
    return x.narrow(dim, r * k, k).contiguous()


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    _count("all_to_all_single")
    src = x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


# --------------------------------------------------- autograd functions
class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, replicated):
        ctx.dim, ctx.group, ctx.replicated = dim, group, replicated
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            return _split(g, ctx.dim, ctx.group), None, None, None
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _split(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


# ------------------------------------------------------------ the calls
def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``: partial -> replicated."""
    return _AllReduce.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over ``group``, without a gradient."""
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def copy(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradients summed over ``group`` backward."""
    return _Copy.apply(x, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum over ``group`` and keep this rank's block of ``dim``."""
    return _ReduceScatter.apply(x, dim, group)


def all_gather(x: torch.Tensor, dim: int, group, replicated: bool = False
               ) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` in rank order."""
    return _AllGather.apply(x, dim, group, replicated)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``dim`` of a replicated tensor."""
    return _Split.apply(x, dim, group)


def all_to_all_single(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of dim 0 goes to rank ``j``; block ``s`` of the result
    came from rank ``s``."""
    return _AllToAll.apply(x, group)
