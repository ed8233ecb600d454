"""Train and serve step builders, on one device or on a mesh.

The port of ``repro.distributed.stepfn``.  The model holds its
parameters, so a train step takes and returns the optimiser state only
and updates the model in place.  Under a mesh (``make_local_mesh``) the
builders first place the model (``place_model``): each parameter becomes
its local block of ``sharding.param_shardings``' placement (the packed
``wkv`` split by KV head, the mamba2 mixer's packed ``in_proj`` and its
conv's channels by SSM head: ``leaf_order``), the model gets the mesh, its
``TensorParallel`` context and the layer-boundary hook of the layout mode,
and every block runs on plain local tensors with explicit collectives.
Each rank takes its data rank's rows of the global batch (all of them
where the batch does not split over the data ranks, as ``repro``'s
``_guard`` replicates it); the step averages the gradients over the data
axes and clips by the global norm of the whole, sharded gradients.

FSDP and ZeRO-1 run as ``repro``'s tables place them
(``shardings_for_train``).  FSDP (a model over 8e9 parameters,
``_wants_fsdp``) stores each leaf of at least ``FSDP_MIN_ELEMENTS`` as its
data block; its layer gathers it whole at use (``models.common.Whole``),
and the gather's backward reduce-scatters the gradient, so it arrives
summed over the data ranks, as an MoE expert's does.  ZeRO-1 stores each
leaf's f32 moments and master copy as its data block
(``sharding.DataBlock``, ``p.zero1``): the gradient's data all-reduce
becomes a reduce-scatter onto that block, AdamW updates the block and
all-gathers the cast parameter.  Where ZeRO-1 puts the data axes on
``repro``'s layer axis, each data rank keeps the state of the layers it
owns: a leaf's gradients, stacked over the layers, are reduce-scattered
along them and the updated layers all-gathered back.  Where FSDP would
split a leaf on the layer axis it stays whole over the data axes (no
production mesh places one so).  The losses and parameters are those of
the step that keeps everything whole; only the bytes a rank holds change.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.models.common import TensorParallel
from repro_torch.models.lm import _is_mamba2, _is_rwkv, param_specs
from repro_torch.optim import AdamWState, adamw_update

from . import collectives as col
from .sharding import (DataBlock, LayerSharded, Spec, _axes, _depths,
                       axis_sizes, cache_shardings, data_dim, data_size,
                       gather, hidden_sharding, kv_order, opt_shardings,
                       param_shardings, place, repro_path, spec_str,
                       ssm_order)


# ------------------------------------------------------------ placement
def leaf_order(cfg, m: int, name: str) -> Optional[torch.Tensor]:
    """The order of the last axis in which the parameter ``name`` is placed
    on a model axis of ``m``: ``kv_order`` for a packed ``wkv``,
    ``ssm_order`` for a mamba2 mixer's ``in_proj``, ``conv_w`` and
    ``conv_b``; None for a leaf placed as it is.  A whole leaf crosses it
    on every path: placement, a save's gather, a restore."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "wkv":
        return kv_order(cfg, m)
    if leaf in ("in_proj", "conv_w", "conv_b") and _is_mamba2(cfg):
        order = ssm_order(cfg, m)
        if order is not None:
            return order[0] if leaf == "in_proj" else order[1]
    return None


def _refuse(model, m: int, fsdp: bool) -> None:
    """Raise ``NotImplementedError`` for what the mesh does not split."""
    cfg = model.cfg
    if fsdp and cfg.family in ("hybrid", "encdec"):
        raise NotImplementedError(
            f"{cfg.name}: FSDP of the {cfg.family} family is not ported "
            f"(no config of it reaches 8e9 parameters)")
    if m == 1:
        return
    if _is_mamba2(cfg) and ssm_order(cfg, m) is None:
        from repro_torch.models.ssm import _dims
        _, state, heads, _ = _dims(cfg)
        raise NotImplementedError(
            f"{cfg.name}: the mamba2 mixer's {heads} SSM heads or its "
            f"ssm_state {state} do not split over a model axis of {m}")
    if _is_rwkv(cfg):
        from repro_torch.models.ssm import _LORA_RANK, _dims
        heads = _dims(cfg)[2]
        if heads % m or _LORA_RANK % m:
            raise NotImplementedError(
                f"{cfg.name}: {heads} heads or the decay LoRA's "
                f"{_LORA_RANK} do not split over a model axis of {m}")
    if cfg.d_ff and cfg.d_ff % m and cfg.family != "moe":
        raise NotImplementedError(f"{cfg.name}: d_ff {cfg.d_ff} does not "
                                  f"split over a model axis of {m}")
    if cfg.family == "hybrid" and cfg.d_model % m:
        raise NotImplementedError(f"{cfg.name}: the shared block's "
                                  f"concat_proj ({cfg.d_model} columns) "
                                  f"does not split over a model axis of {m}")


def place_model(model, mesh, layout_mode: str = "coswitch") -> None:
    """Swap each parameter of ``model`` for its local block on ``mesh``
    (FSDP's data block too, for a model ``_wants_fsdp``), mark each with
    its FSDP and ZeRO-1 splits (``p.fsdp``, ``p.zero1``: a
    ``sharding.DataBlock`` or None), and give the model the mesh, its
    placement tables, its ``TensorParallel`` context and the
    ``layout_mode`` hook.  A model placed on this mesh before only takes
    the new hook; one placed on another mesh raises."""
    hook = hidden_sharding(mesh, layout_mode)
    if model.mesh is not None:
        if model.mesh is not mesh:
            raise ValueError("the model is placed on another mesh")
        model.hook = hook
        return
    m = axis_sizes(mesh)["model"]
    fsdp = _wants_fsdp(model)
    _refuse(model, m, fsdp)
    cfg = model.cfg
    specs = param_specs(cfg)
    p_sh, z1 = shardings_for_train(model, mesh)
    base = param_shardings(mesh, specs)
    sh = {n: base[n] if isinstance(s, LayerSharded) else s
          for n, s in p_sh.items()}
    col.label_mesh(mesh)
    dg, dsize, drank = col.data_group(mesh), data_size(mesh), data_rank(mesh)
    depth = _depths(specs)
    layers: Dict[str, list] = {}
    with torch.no_grad():
        for name, p in model.params().items():
            full = p.data
            order = leaf_order(cfg, m, name)
            if order is not None:
                full = full[..., order.to(full.device)]
            p.data = place(full, mesh, sh[name])
            split = data_dim(sh[name], mesh)
            p.fsdp = DataBlock(split, dg, dsize, drank) \
                if split is not None and data_dim(base[name], mesh) is None \
                else None
            if isinstance(z1[name], LayerSharded):
                stack, i = name.split(".")[:2]
                per = depth[stack] // dsize
                p.zero1 = DataBlock(None, dg, dsize, drank,
                                    owns=int(i) // per == drank)
                layers.setdefault(repro_path(name)[0], []).append(name)
            else:
                zd = data_dim(z1[name], mesh)
                p.zero1 = DataBlock(zd, dg, dsize, drank) \
                    if zd is not None and split is None else None
    split = frozenset(n.rsplit(".", 1)[-1] for n, spec in sh.items()
                      if n.rsplit(".", 1)[-1] in ("embed", "mu", "pos_embed")
                      and "model" in spec)
    model.fsdp = any(p.fsdp is not None for p in model.params().values())
    model.placement = {"params": sh, "state": z1, "layers": layers}
    model.mesh = mesh
    model.tp = TensorParallel(mesh.get_group("model"), m,
                              mesh.get_local_rank("model"),
                              attn_sharded=kv_order(cfg, m) is not None,
                              split=split)
    model.hook = hook


def full_named(model, local: Mapping[str, torch.Tensor],
               state: bool = False) -> Dict[str, torch.Tensor]:
    """Whole tensors from every rank's blocks: of the parameters (laid out
    as ``model.params()``), or with ``state`` of the optimiser's f32
    tensors (their ZeRO-1 blocks; the layers a rank owns).  A
    collective: every rank gets them all."""
    mesh = model.mesh
    if mesh is None:
        return dict(local)
    table = model.placement["state" if state else "params"]
    m = axis_sizes(mesh)["model"]
    out = {}
    for name in model.params():
        spec = table[name]
        if isinstance(spec, LayerSharded):
            continue
        out[name] = gather(local[name], mesh, spec)
    for names in model.placement["layers"].values() if state else ():
        owned = torch.stack([local[n] for n in names if n in local])
        every = col._all_gather(owned, 0, col.data_group(mesh))
        for n, t in zip(names, every.unbind(0)):
            out[n] = gather(t, mesh, tuple(table[n][1:]))
    for name, full in out.items():
        order = leaf_order(model.cfg, m, name)
        if order is not None:
            out[name] = full[..., torch.argsort(order).to(full.device)]
    return {n: out[n] for n in model.params() if n in out}


def local_named(model, full: Mapping[str, torch.Tensor],
                state: bool = False) -> Dict[str, torch.Tensor]:
    """The inverse of ``full_named``: this rank's blocks of whole
    tensors laid out as ``model.params()`` (with ``state``, of the
    optimiser's f32 tensors: none for a layer another rank owns)."""
    mesh = model.mesh
    if mesh is None:
        return dict(full)
    table = model.placement["state" if state else "params"]
    m = axis_sizes(mesh)["model"]
    params = model.params()
    out = {}
    for name, t in full.items():
        order = leaf_order(model.cfg, m, name)
        if order is not None:
            t = t[..., order.to(t.device)]
        spec = table[name]
        if isinstance(spec, LayerSharded):
            if params[name].zero1.owns:
                out[name] = place(t, mesh, tuple(spec[1:]))
            continue
        out[name] = place(t, mesh, spec)
    return out


def data_rank(mesh) -> int:
    """This rank's index over the data axes (pod-major)."""
    sizes = axis_sizes(mesh)
    r = 0
    for a in _axes(mesh)[0]:
        r = r * sizes[a] + mesh.get_local_rank(a)
    return r


def data_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's rows of a global batch (dim 0); all of them where
    the batch does not split over the data ranks (``repro``'s ``_guard``
    drops the data axis there: every data rank holds the whole batch)."""
    d = data_size(mesh)
    if x.shape[0] % d:
        return x
    k = x.shape[0] // d
    return x[data_rank(mesh) * k:(data_rank(mesh) + 1) * k]


def local_cache_specs(model, batch: int, max_seq: int) -> Dict:
    """The model's cache specs for ``batch`` local rows, each leaf in its
    local shape under ``cache_shardings`` (``length`` per local row).
    Records on the model which attention caches that placement splits by
    sequence over the model axis (``model.kv_split``: KV heads that do not
    divide it, and a length that does)."""
    mesh = model.mesh
    sizes = axis_sizes(mesh)
    specs = model.cache_specs(batch * data_size(mesh), max_seq)
    placed = cache_shardings(mesh, specs)
    split = {}

    def walk(tree, sh):
        out = {}
        for n, s in tree.items():
            if isinstance(s, dict):
                out[n] = walk(s, sh[n])
                continue
            shape, dt = s
            if n == "length":    # replicated, as cache_shardings places it
                out[n] = (shape, dt)
                continue
            spec = sh[n]
            if n in ("k", "ck", "attn_k"):
                split[n] = spec[2] == "model"
            local = []
            for dim, ax in zip(shape, spec):
                axes = () if ax is None else (
                    ax if isinstance(ax, tuple) else (ax,))
                local.append(dim // math.prod(sizes[a] for a in axes))
            out[n] = (tuple(local), dt)
        return out

    out = walk(specs, placed)
    model.kv_split = split
    return out


# ------------------------------------------------------------------ train
def _wants_fsdp(model) -> bool:
    total = sum(math.prod(s[0]) for s in param_specs(model.cfg).values())
    return total > 8e9


def shardings_for_train(model, mesh) -> Tuple[Dict[str, Spec],
                                               Dict[str, Spec]]:
    """The parameters' placements (FSDP above 8e9 parameters) and the
    ZeRO-1 placements of their f32 state, as ``repro``'s
    ``jit_train_step`` takes them."""
    specs = param_specs(model.cfg)
    p_sh = param_shardings(mesh, specs, fsdp=_wants_fsdp(model))
    return p_sh, opt_shardings(mesh, p_sh, specs)


def checkpoint_shardings(model, mesh):
    """The manifest strings of a train checkpoint on ``mesh``: the tree of
    ``{"params", "opt"}`` in ``repro``'s layout, each leaf the
    ``PartitionSpec`` string of ``shardings_for_train``'s placement (the
    step scalar's ``PartitionSpec()``)."""
    from repro_torch.weights import ReproAdamWState, repro_layout
    p_sh, z1 = shardings_for_train(model, mesh)

    def of(table):
        return repro_layout(model.cfg,
                            lambda name, shape, dt: spec_str(name,
                                                             table[name]))

    return {"params": of(p_sh),
            "opt": ReproAdamWState(step="PartitionSpec()", mu=of(z1),
                                   nu=of(z1), master=of(z1))}


def _grad_sync(model, mesh, names):
    """(average the gradients over the data axes onto each leaf's block,
    the ``reduce`` of the global-norm clip, gather the layers a rank
    updated) for the leaves ``names``.  ``average`` takes and returns
    gradients by name: a leaf split over the data axes (FSDP, an MoE
    expert) arrives summed from its gather's backward; a leaf with a
    ZeRO-1 block is reduce-scattered onto it; a leaf whose state is split
    on the layer axis is reduce-scattered along its stacked layers, and a
    rank keeps the layers it owns; any other is all-reduced."""
    params = model.params()
    placed = model.placement["params"]
    groups = model.placement["layers"]
    grouped = {n for ns in groups.values() for n in ns}
    split = {n: data_dim(placed[n], mesh) is not None for n in names}
    by_data = {n: split[n] or params[n].zero1 is not None for n in names}
    by_model = {n: "model" in _flat(placed[n]) for n in names}
    dsize = data_size(mesh)
    mg, dg = mesh.get_group("model"), col.data_group(mesh)

    def average(grads, loss):
        out = {}
        for n, g in grads.items():
            if n in grouped:
                continue
            block = params[n].zero1
            if split[n]:
                pass
            elif block is not None:
                g = col._reduce_scatter(g, block.dim, dg)
            else:
                g = col._all_reduce(g, dg)
            out[n] = g / dsize
        for ns in groups.values():
            mine = col._reduce_scatter(torch.stack([grads[n] for n in ns]),
                                       0, dg)
            owned = [n for n in ns if params[n].zero1.owns]
            for n, g in zip(owned, mine.unbind(0)):
                out[n] = g / dsize
        return out, col._all_reduce(loss.detach(), dg) / dsize

    def reduce(sq):
        zero = next(iter(sq.values())).new_zeros(())
        v = torch.stack([sq.get(n, zero) for n in names])
        for group, which in ((mg, by_model), (dg, by_data)):
            mask = torch.tensor([which[n] for n in names], device=v.device)
            summed = col._all_reduce(v * mask, group)
            v = torch.where(mask, summed, v)
        return list(v.unbind())

    @torch.no_grad()
    def gather_layers():
        for ns in groups.values():
            owned = torch.stack([params[n] for n in ns
                                 if params[n].zero1.owns])
            every = col._all_gather(owned, 0, dg)
            for n, t in zip(ns, every.unbind(0)):
                params[n].copy_(t)

    return average, reduce, gather_layers


def _flat(spec: Spec):
    for ax in spec:
        if isinstance(ax, tuple):
            yield from ax
        elif ax is not None:
            yield ax


def make_train_step(model, mesh=None, *, layout_mode: str = "coswitch",
                    accum: int = 1, lr: float = 3e-4,
                    schedule: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``.

    ``model`` is an ``LMModel`` on its device; its parameters get gradients
    from here on.  With a ``mesh`` the model is placed on it first
    (``place_model``, with ``layout_mode``'s layer-boundary hook, FSDP
    and the ZeRO-1 blocks): build the optimiser state
    (``adamw_init(model.params())``, which takes each parameter's ZeRO-1
    block) after this call.
    ``batch`` is the global ``{"tokens": (B, T+1)}``, with ``"frames"``
    (B, Tenc, D) for an encoder-decoder (numpy or tensors), handed to
    ``model.loss`` (this data rank's rows under a mesh); ``accum`` > 1
    splits it into that many microbatches and averages their f32
    gradients, as the JAX step's ``lax.scan`` does.
    The learning rate is ``schedule(opt_state.step)`` (the step count
    before this update) or ``lr``.  ``metrics``: ``{"loss": f32 scalar
    tensor on the model's device (the global batch's mean), "lr":
    float}``.
    """
    if mesh is not None:
        place_model(model, mesh, layout_mode)
    model.requires_grad_(True)
    params = model.params()
    names = list(params)
    leaves = [params[n] for n in names]
    average, reduce, gather_layers = _grad_sync(model, mesh, names) \
        if mesh is not None else (None, None, None)

    def grads_of(mb: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, list]:
        loss = model.loss(mb)
        return loss, list(torch.autograd.grad(loss, leaves))

    def step(opt_state: AdamWState, batch: Mapping
             ) -> Tuple[AdamWState, Dict]:
        on_dev = {k: torch.as_tensor(batch[k], device=model.device)
                  for k in ("tokens", "frames") if k in batch}
        B = on_dev["tokens"].shape[0]
        if B % accum:
            raise ValueError(f"batch {B} does not split into {accum} "
                             f"microbatches")
        mbs = [{k: v[i * (B // accum):(i + 1) * (B // accum)]
                for k, v in on_dev.items()} for i in range(accum)]
        if mesh is not None:
            mbs = [{k: data_rows(v, mesh) for k, v in mb.items()}
                   for mb in mbs]
        if accum == 1:
            loss, grads = grads_of(mbs[0])
        else:
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves]
            losses = []
            for mb in mbs:
                mb_loss, g = grads_of(mb)
                gsum = [a + b for a, b in zip(gsum, g)]
                losses.append(mb_loss.detach())
            grads = [g / accum for g in gsum]
            loss = torch.mean(torch.stack(losses))
        grads = dict(zip(names, grads))
        if average is not None:
            grads, loss = average(grads, loss)
        step_lr = schedule(opt_state.step) if schedule is not None else lr
        adamw_update(grads, opt_state, params, step_lr, reduce=reduce)
        if gather_layers is not None:
            gather_layers()
        return opt_state, {"loss": loss.detach(), "lr": float(step_lr)}

    return step


# ------------------------------------------------------------------ serve
def make_serve_step(model) -> Callable:
    """``step(cache, tokens) -> (cache, logits)``: one ``decode_step`` of
    ``model`` (placed on its mesh by ``serve_step``, or on one device)."""
    def step(cache, tokens):
        return model.decode_step(cache, tokens)
    return step


def _serve_ready(model, mesh, batch: int, max_seq: int) -> None:
    place_model(model, mesh, "fixed")
    local_cache_specs(model, batch // data_size(mesh), max_seq)


def serve_step(model, mesh, batch: int, max_seq: int) -> Callable:
    """The counterpart of ``repro``'s ``jit_serve_step``: places the model
    on ``mesh`` and returns ``step(cache, tokens) -> (cache, logits)``
    for a global batch of ``batch`` rows: ``tokens`` (B,) global, the
    cache this data rank's (``prefill_step``'s, or ``model.init_cache(B /
    data ranks, max_seq)``), ``logits`` its rows' (B / data ranks, V)."""
    _serve_ready(model, mesh, batch, max_seq)
    decode = make_serve_step(model)

    def step(cache, tokens):
        tokens = torch.as_tensor(tokens, device=model.device)
        return decode(cache, data_rows(tokens, mesh))
    return step


def prefill_step(model, mesh, batch: int, seq: int, max_seq: int,
                 frames: bool = False) -> Callable:
    """The counterpart of ``repro``'s ``jit_prefill``: places the model on
    ``mesh`` and returns ``fn(tokens[, frames]) -> (cache, logits)`` for
    global ``tokens`` (B, seq) (and an encoder-decoder's ``frames`` (B,
    Tenc, D)): this data rank's cache, in the local layout of
    ``cache_shardings``, and its rows' logits (B / data ranks, V)."""
    _serve_ready(model, mesh, batch, max_seq)

    def fn(tokens, fr=None):
        tokens = torch.as_tensor(tokens, device=model.device)
        if tokens.shape != (batch, seq):
            raise ValueError(f"tokens {tuple(tokens.shape)} != "
                             f"{(batch, seq)}")
        rows = data_rows(tokens, mesh)
        if frames:
            fr = torch.as_tensor(fr, device=model.device)
            return model.prefill(rows, max_seq,
                                 frames=data_rows(fr, mesh))
        return model.prefill(rows, max_seq)
    return fn


__all__ = ["checkpoint_shardings", "data_rows", "full_named",
           "local_cache_specs", "local_named", "make_serve_step",
           "make_train_step", "place_model", "prefill_step", "serve_step",
           "shardings_for_train"]
