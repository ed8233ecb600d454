"""Per-layer sharding plans: FEATHER's (dataflow, layout) co-switching on
a mesh.

The port of ``repro.distributed.sharding``.  On a mesh a layer's
*dataflow* is which mesh axes split which tensor dims (tensor parallelism
over heads and the FFN, expert parallelism over experts, sequence
parallelism over T, data parallelism over the batch), and its *layout*
is the sharding of the activations it reads and writes.  In ``coswitch``
mode a producer's row-parallel product writes the next block's layout
through a reduce-scatter along T (the reorder rides the reduction: RIR);
``fixed`` keeps one replicated layout and all-reduces.

A placement is data: a tuple with one entry per tensor dim, ``None`` or a
mesh axis name or a tuple of names, as a ``PartitionSpec`` is in
``repro``.  The rules are ``repro``'s, read on ``repro``'s paths: the
port's dotted name ``layers.3.mixer.wq`` is the leaf ``layers/mixer/wq``
of ``repro``'s tree, which carries a leading layer axis, so a rule sees
the port's ndim plus one, and the layer entry (``None``, but where ZeRO-1
or FSDP choose it: ``LayerSharded``) is dropped from the result.  A port
MoE expert tensor ``(E, D, F)`` so takes ``repro``'s 4-D rule.  The tables take a ``DeviceMesh`` or a mapping of
axis name to size, so they are computed without a world of that size.
``place``/``gather`` move tensors between the full and the local layout
through DTensor (``distribute_tensor``, ``Shard``, ``Replicate``); the
blocks only ever see the local, contiguous tensors.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch

#: one placement: an entry per tensor dim
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]
#: a mesh, or its axis sizes by name
MeshLike = Union[Mapping[str, int], "torch.distributed.device_mesh.DeviceMesh"]

# data axes for batch-parallel dims: the pod axis joins DP
DATA = ("pod", "data")


def axis_sizes(mesh: MeshLike) -> Dict[str, int]:
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(mesh: MeshLike) -> Tuple[Tuple[str, ...], str]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in DATA if a in sizes), "model"


def data_size(mesh: MeshLike) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _axes(mesh)[0])


def _norm(entry):
    """A one-name tuple as the name (``PartitionSpec`` shows it so)."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


# ------------------------------------------------------------- parameter rules
# path-regex -> spec builder over repro's stacked ndim (repro's table)
_PARAM_RULES = (
    # embeddings / heads: vocab over model (Megatron vocab-parallel)
    (r"embed$", lambda d: ("model", None)),
    (r"lm_head$", lambda d: (None, "model")),
    (r"pos_embed$|enc_pos$", lambda d: (None, None)),
    # attention: head dim over model
    (r"wq$|wkv$", lambda d: (None, None, "model") if d == 3
        else (None, "model")),
    (r"wo$", lambda d: (None, "model", None) if d == 3 else ("model", None)),
    # moe shared expert: FSDP over data (consumed inside the EP block)
    (r"ffn/shared/w[ug]$", lambda d: {3: (None, None, "data"),
                                      2: (None, "data")}.get(d, ())),
    (r"ffn/shared/wd$", lambda d: {3: (None, "data", None),
                                   2: ("data", None)}.get(d, ())),
    # mlp/moe: dense tensors TP over the ffn dim; 4-D stacked expert
    # tensors EP over the expert dim + FSDP over data on the ffn dim
    (r"(ffn|shared)/w[ug]$", lambda d: {
        4: (None, "model", None, "data"), 3: (None, None, "model"),
        2: (None, "model")}.get(d, ())),
    (r"(ffn|shared)/wd$", lambda d: {
        4: (None, "model", "data", None), 3: (None, "model", None),
        2: ("model", None)}.get(d, ())),
    (r"router$", lambda d: (None, None)),
    # ssm: inner channels over model
    (r"in_proj$|wr$|wk$|wv$|wg$|w1$", lambda d: (None, None, "model")
        if d == 3 else (None, "model")),
    (r"out_proj$|wo$|w2$", lambda d: (None, "model", None) if d == 3
        else ("model", None)),
    (r"conv_w$", lambda d: (None, None, "model") if d == 3
        else (None, "model")),
    (r"conv_b$|w0$|u$", lambda d: (None, "model") if d == 2 else ("model",)),
    (r"A_log$|D_skip$|dt_bias$", lambda d: (None, "model") if d == 2
        else ("model",)),
    (r"mu$", lambda d: (None, None, None) if d == 3 else (None, None)),
    (r"concat_proj$", lambda d: (None, "model")),
    # norms replicated
    (r"norm|ln_x|/w$|/b$", lambda d: (None,) * d),
)


def _spec_for_path(path: str, ndim: int) -> Spec:
    for pat, fn in _PARAM_RULES:
        if re.search(pat, path):
            spec = tuple(fn(ndim))
            if len(spec) < ndim:   # stacked-layer leading axis
                spec = (None,) * (ndim - len(spec)) + spec
            if len(spec) != ndim:
                spec = (None,) * ndim
            return spec
    return (None,) * ndim


#: the stacked subtrees of ``repro``'s parameter trees (``weights._stacks``)
_STACKS = ("layers", "enc_layers", "dec_layers")


def repro_path(name: str) -> Tuple[str, bool]:
    """The port's dotted name as ``repro``'s leaf path, and whether that
    leaf is stacked on a layer axis (``layers.3.mixer.wq`` ->
    ``("layers/mixer/wq", True)``)."""
    parts = name.split(".")
    if parts[0] in _STACKS and len(parts) > 2 and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


def _guard(mesh: MeshLike, shape: Tuple[int, ...], spec: Spec) -> Spec:
    """Drop any sharded axis that does not divide its dimension."""
    sizes = axis_sizes(mesh)
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                        - len(spec))):
        if ax is None:
            fixed.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = math.prod(sizes[a] for a in axes)
        fixed.append(_norm(ax) if dim % size == 0 else None)
    return tuple(fixed)


def _used(spec: Spec) -> set:
    out = set()
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                out.add(a)
    return out


def _add_data_axis(mesh: MeshLike, spec: Spec, shape: Tuple[int, ...]
                   ) -> Spec:
    """The data axes on the largest unsharded dim they divide (FSDP and
    ZeRO-1), unless the spec already uses one of them."""
    data, _ = _axes(mesh)
    dsize = data_size(mesh)
    pspec = list(spec) + [None] * (len(shape) - len(spec))
    if _used(pspec) & set(data):
        return tuple(pspec)
    best, best_dim = None, 0
    for i, (ax, dim) in enumerate(zip(pspec, shape)):
        if ax is None and dim % dsize == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best is not None:
        pspec[best] = _norm(data)
    return tuple(pspec)


def _stacked(name: str, shape: Tuple[int, ...], n_layers: Mapping[str, int]
             ) -> Tuple[str, bool, Tuple[int, ...]]:
    path, stacked = repro_path(name)
    if stacked:
        shape = (n_layers[name.split(".")[0]],) + tuple(shape)
    return path, stacked, tuple(shape)


class LayerSharded(tuple):
    """A table entry that puts a mesh axis on ``repro``'s layer axis (ZeRO-1
    or FSDP choosing the layer dim, as for zamba2's conv weights): the
    stacked spec, layer entry first.  It describes ``repro``'s layout and
    has no per-layer placement (``place`` refuses it)."""


def _unstack(name: str, spec: Spec, stacked: bool) -> Spec:
    if not stacked:
        return spec
    if spec[0] is not None:
        return LayerSharded(spec)
    return spec[1:]


def _depths(specs: Mapping) -> Dict[str, int]:
    """The number of layers of each stack, counted from the names."""
    out: Dict[str, int] = {}
    for name in specs:
        parts = name.split(".")
        if parts[0] in _STACKS and len(parts) > 2 and parts[1].isdigit():
            out[parts[0]] = max(out.get(parts[0], 0), int(parts[1]) + 1)
    return out


def param_shardings(mesh: MeshLike, specs: Mapping, fsdp: bool = False
                    ) -> Dict[str, Spec]:
    """The placement of every parameter of ``specs`` (name -> (shape,
    dtype), as ``lm.param_specs`` gives them).  ``fsdp`` also puts the data
    axes on the largest unsharded dim of every tensor of at least 4e6
    elements (counted with its layer axis, as ``repro`` counts)."""
    depth = _depths(specs)
    out = {}
    for name, (shape, _) in specs.items():
        path, stacked, full = _stacked(name, shape, depth)
        spec = _guard(mesh, full, _spec_for_path(path, len(full)))
        if fsdp and math.prod(full) >= 4_000_000:
            spec = _add_data_axis(mesh, spec, full)
        out[name] = _unstack(name, spec, stacked)
    return out


def opt_shardings(mesh: MeshLike, param_sh: Mapping[str, Spec],
                  specs: Mapping) -> Dict[str, Spec]:
    """ZeRO-1: the f32 moments and master copy also sharded over the data
    axes on the largest still-unsharded dim they divide."""
    depth = _depths(specs)
    out = {}
    for name, (shape, _) in specs.items():
        _, stacked, full = _stacked(name, shape, depth)
        spec = tuple(param_sh[name])
        if stacked and not isinstance(param_sh[name], LayerSharded):
            spec = (None,) + spec
        out[name] = _unstack(name, _add_data_axis(mesh, spec, full), stacked)
    return out


def spec_str(name: str, spec: Spec) -> str:
    """The ``PartitionSpec`` string ``repro`` writes into a checkpoint
    manifest for the leaf ``name`` placed as ``spec``, with the layer axis
    of a stacked leaf in front (``PartitionSpec(None, None, 'model')``)."""
    if repro_path(name)[1] and not isinstance(spec, LayerSharded):
        spec = (None,) + tuple(spec)
    return "PartitionSpec" + repr(tuple(_norm(a) for a in spec))


def cache_shardings(mesh: MeshLike, cache_specs: Mapping) -> Dict:
    """KV/SSM cache placements for serving, on the port's cache specs
    (which carry the layer axis, as ``repro``'s do): batch over the data
    axes; attention K/V over heads where they divide, else over the
    sequence; SSM states over heads or channels."""
    data, model = _axes(mesh)
    msize = axis_sizes(mesh)["model"]
    dspec = _norm(data)

    def one(path: str, shape: Tuple[int, ...]) -> Spec:
        nd = len(shape)
        if path.endswith("length"):
            return (None,) * nd
        stacked = "layers" in path or "attn_" in path
        core = shape[1:] if stacked else shape
        last = path.split("/")[-1]
        if len(core) == 4 and ("k" in last or "v" in last) \
                and "conv" not in path:
            if core[2] % msize == 0:
                spec = (dspec, None, model, None)
            else:
                spec = (dspec, model, None, None)
        elif len(core) == 4:    # ssm (B, H, state, hd) / rwkv (B, H, dk, dv)
            spec = (dspec, model, None, None)
        elif len(core) == 3:    # conv cache (B, W-1, C)
            spec = (dspec, None, model)
        elif len(core) == 2:    # x_prev (B, D)
            spec = (dspec, model)
        else:
            spec = (None,) * len(core)
        if stacked:
            spec = (None,) + spec
        return _guard(mesh, shape, spec)

    def walk(tree: Mapping, prefix: str) -> Dict:
        return {n: walk(s, f"{prefix}{n}/") if isinstance(s, Mapping)
                else one(f"{prefix}{n}", tuple(s[0]))
                for n, s in tree.items()}

    return walk(cache_specs, "")


# ------------------------------------------------------- activation layer plans
@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """The (dataflow, layout) choice for a block's activations."""
    name: str
    hidden: Spec    # (B, T, D) layout this block wants to READ
    describe: str = ""


def plans_for(cfg, mesh: MeshLike, mode: str) -> Dict[str, LayerPlan]:
    """Per-block-type activation plans (``repro``'s).

    ``fixed``: one global layout; ``coswitch``: each block type reads its
    preferred layout and producers write it directly (RIR)."""
    data, model = _axes(mesh)
    dp = (_norm(data), None, None)
    if mode == "fixed":
        plan = LayerPlan("fixed", dp, "global batch-sharded layout")
        return {"attn": plan, "ffn": plan, "moe": plan, "loss": plan}
    seq = (_norm(data), model, None)
    return {
        "attn": LayerPlan("attn", dp, "batch-sharded, heads TP inside"),
        "ffn": LayerPlan("ffn", seq, "sequence-sharded around FFN (SP)"),
        "moe": LayerPlan("moe", seq, "token-sharded for expert dispatch"),
        "loss": LayerPlan("loss", seq, "sequence-sharded softmax"),
    }


def hidden_sharding(mesh: MeshLike, mode: str = "coswitch"
                    ) -> Callable[[int], Spec]:
    """The layer-boundary layout of the (B, T, D) residual stream, as a
    function of T.  ``coswitch``: sequence-sharded over the model axis
    where T divides (each block's row-parallel product reduce-scatters
    into it, each column-parallel one all-gathers from it); ``fixed``, or
    T not divisible: batch-sharded and replicated over the model axis."""
    data, model = _axes(mesh)
    m = axis_sizes(mesh)["model"]
    dp = (_norm(data), None, None)

    def coswitch(T: int) -> Spec:
        return (_norm(data), model, None) if T % m == 0 else dp

    def fixed(T: int) -> Spec:
        return dp

    if mode not in ("coswitch", "fixed"):
        raise ValueError(f"layout mode {mode!r} is not coswitch or fixed")
    return coswitch if mode == "coswitch" else fixed


def batch_sharding(mesh: MeshLike) -> Spec:
    data, _ = _axes(mesh)
    return (_norm(data), None)


# ------------------------------------------------------------- placing tensors
def placements(mesh, spec: Spec) -> list:
    """``spec`` as DTensor placements, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    if isinstance(spec, LayerSharded):
        raise ValueError(f"{spec} shards the layer axis: no per-layer "
                         f"placement")
    out = []
    for name in mesh.mesh_dim_names:
        dim = None
        for i, ax in enumerate(spec):
            if name == ax or (isinstance(ax, tuple) and name in ax):
                dim = i
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def place(full: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """This rank's block of ``full`` (which every rank holds) as a plain
    contiguous tensor."""
    from torch.distributed.tensor import distribute_tensor
    dt = distribute_tensor(full.detach(), mesh, placements(mesh, spec),
                           src_data_rank=None)
    return dt.to_local().contiguous()


def gather(local: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """The full tensor from every rank's block (a collective)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.detach(), mesh, placements(mesh, spec),
                              run_check=False).full_tensor()


def kv_order(cfg, m: int) -> Optional[torch.Tensor]:
    """The column order that makes the packed ``wkv`` (K then V, ``(D, 2
    Hkv dh)``) split by KV head: rank ``r``'s block holds its K heads then
    its V heads.  None where the KV heads do not divide ``m``."""
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim
    if Hkv % m:
        return None
    w = Hkv // m * dh
    cols = []
    for r in range(m):
        cols.append(torch.arange(r * w, (r + 1) * w))
        cols.append(Hkv * dh + torch.arange(r * w, (r + 1) * w))
    return torch.cat(cols)
