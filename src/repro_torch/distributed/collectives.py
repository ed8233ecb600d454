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
``BYTES`` sums the result bytes of each forward call by (kind, mesh
dimension): the quantity ``repro.core.hlo_cost`` counts for a collective,
which ``repro_torch.core.trace_cost`` reads.  A group is named after the
mesh dimension it spans once ``label_mesh`` has seen the mesh
(``place_model`` calls it): ``model``, ``data``, ``pod``, or
``pod+data`` for the flattened data group of a three-axis mesh
(``data+model`` where both dimensions are one group, on one rank); any
other group is ``group``.  A group of one rank still runs every
collective.  ``all_gather`` and ``reduce_scatter`` return an activation
contiguous, laid out as one device's would be, and so its gradient: a
permuted one (the view a gather along a dim other than 0 leaves) sends
later ops (an embedding's or a norm weight's gradient) down another
summation order, and one rank would not compute bit for bit what one
device does.  A weight gathered for a product passes
``contiguous=False`` and keeps the view, which the product reads without
a copy of the whole weight.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

#: forward calls of each collective since the last ``reset_calls``
CALLS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                         "reduce_scatter": 0, "all_to_all_single": 0}
#: result bytes of those calls by (kind, mesh dimension)
BYTES: Dict[Tuple[str, str], float] = {}
#: process-group name -> the mesh dimension(s) it spans
_DIMS: Dict[str, str] = {}
#: mesh -> its flattened data group
_DATA_GROUPS: Dict[object, object] = {}


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0
    BYTES.clear()


def data_group(mesh):
    """The process group of the data axes (``pod`` and ``data`` together
    on a three-axis mesh, flattened once a mesh: the flattening indexes
    the mesh's rank tensor, which a trace under ``FakeTensorMode`` must
    not do)."""
    names = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if mesh not in _DATA_GROUPS:
        _DATA_GROUPS[mesh] = mesh[names]._flatten().get_group()
    return _DATA_GROUPS[mesh]


def label_mesh(mesh) -> None:
    """Name the groups of ``mesh`` after its dimensions (and the
    flattened data group ``pod+data``).  Dimensions that share one group
    (each spanning the whole world, as on one rank) share its name:
    ``data+model``."""
    names: Dict[str, list] = {}
    for name in mesh.mesh_dim_names:
        names.setdefault(mesh.get_group(name).group_name, []).append(name)
    if "pod" in mesh.mesh_dim_names:
        names.setdefault(data_group(mesh).group_name, ["pod", "data"])
    _DIMS.update((g, "+".join(dims)) for g, dims in names.items())


def _count(name: str, out: torch.Tensor, group) -> None:
    CALLS[name] += 1
    key = (name, _DIMS.get(getattr(group, "group_name", ""), "group"))
    BYTES[key] = BYTES.get(key, 0.0) + out.numel() * out.element_size()


# ------------------------------------------------------- raw collectives
def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    _count("all_reduce", out, group)
    return out


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    _count("all_gather", out, group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    _count("reduce_scatter", out, group)
    return out.movedim(0, dim)


def _split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"split: dim {dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    k = x.shape[dim] // n
    return x.narrow(dim, r * k, k).contiguous()


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    src = x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _count("all_to_all_single", out, group)
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


def _dense(x: torch.Tensor, contiguous: bool) -> torch.Tensor:
    return x.contiguous() if contiguous else x


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, contiguous):
        ctx.dim, ctx.group, ctx.contiguous = dim, group, contiguous
        return _dense(_reduce_scatter(x, dim, group), contiguous)

    @staticmethod
    def backward(ctx, g):
        return (_dense(_all_gather(g, ctx.dim, ctx.group), ctx.contiguous),
                None, None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, replicated, contiguous):
        ctx.dim, ctx.group, ctx.replicated = dim, group, replicated
        ctx.contiguous = contiguous
        return _dense(_all_gather(x, dim, group), contiguous)

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            return _split(g, ctx.dim, ctx.group), None, None, None, None
        return (_dense(_reduce_scatter(g, ctx.dim, ctx.group),
                       ctx.contiguous), None, None, None, None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _split(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group).contiguous(), None, None


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


def merge_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                   group) -> torch.Tensor:
    """``models.common.merge_partials`` over the ranks of ``group``, each
    holding one split's ``o`` (..., D) and row statistics ``m``, ``l``
    (...): the max of ``m`` (``all_reduce_max``), then one sum of the
    weighted outputs packed beside their weights; (..., D) f32 on every
    rank, 0 where every split is empty."""
    from repro_torch.models.common import lse_weights
    w = lse_weights(m, l, all_reduce_max(m, group))
    packed = all_reduce(torch.cat([w[..., None] * o.float(), w[..., None]],
                                  dim=-1), group)
    den = packed[..., -1:]
    return packed[..., :-1] / torch.where(den > 0, den, 1.0)


def copy(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradients summed over ``group`` backward."""
    return _Copy.apply(x, group)


def reduce_scatter(x: torch.Tensor, dim: int, group,
                   contiguous: bool = True) -> torch.Tensor:
    """Sum over ``group`` and keep this rank's block of ``dim``."""
    return _ReduceScatter.apply(x, dim, group, contiguous)


def all_gather(x: torch.Tensor, dim: int, group, replicated: bool = False,
               contiguous: bool = True) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` in rank order
    (``contiguous=False``: a weight's view, see the module's note)."""
    return _AllGather.apply(x, dim, group, replicated, contiguous)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``dim`` of a replicated tensor."""
    return _Split.apply(x, dim, group)


def all_to_all_single(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of dim 0 goes to rank ``j``; block ``s`` of the result
    came from rank ``s``."""
    return _AllToAll.apply(x, group)
