"""Train and serve step builders, on one device or on a mesh.

The port of ``repro.distributed.stepfn``.  The model holds its
parameters, so a train step takes and returns the optimiser state only
and updates the model in place.  Under a mesh (``make_local_mesh``) the
builders first place the model (``place_model``): each parameter becomes
its local block of ``sharding.param_shardings``' placement (the packed
``wkv`` split by KV head), the model gets the mesh, its
``TensorParallel`` context and the layer-boundary hook of the layout mode,
and every block runs on plain local tensors with explicit collectives.
Each rank takes its data rank's rows of the global batch; the step
averages the gradients over the data axes (a parameter split over them,
an MoE expert, was summed already by its gather's backward) and clips by
the global norm of the whole, sharded gradients.  FSDP and ZeRO-1 are
tables here (``shardings_for_train``): the step keeps every parameter
and its f32 state whole over the data axes, unless a rule puts a data
axis on it (the MoE experts).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.models.common import TensorParallel
from repro_torch.models.lm import _is_mamba2, _is_rwkv, param_specs
from repro_torch.optim import AdamWState, adamw_update

from . import collectives as col
from .sharding import (Spec, _axes, axis_sizes, cache_shardings,
                       data_size, gather, hidden_sharding, kv_order,
                       opt_shardings, param_shardings, place, spec_str)


# ------------------------------------------------------------ placement
def _is_kv(name: str) -> bool:
    return name.endswith("wkv")


def _refuse(model, m: int) -> None:
    """Raise ``NotImplementedError`` for what the mesh does not split."""
    cfg = model.cfg
    if m == 1:
        return
    if cfg.family == "encdec" or _is_mamba2(cfg):
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism for the {cfg.family} family "
            f"(mamba2, whisper) is not ported: model axis {m} above 1; "
            f"ROADMAP.md Queue 1 item 10b")
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


def place_model(model, mesh, layout_mode: str = "coswitch") -> None:
    """Swap each parameter of ``model`` for its local block on ``mesh``
    and give the model the mesh, its ``TensorParallel`` context and the
    ``layout_mode`` hook.  A model placed on this mesh before only takes
    the new hook; one placed on another mesh raises."""
    hook = hidden_sharding(mesh, layout_mode)
    if model.mesh is not None:
        if model.mesh is not mesh:
            raise ValueError("the model is placed on another mesh")
        model.hook = hook
        return
    m = axis_sizes(mesh)["model"]
    _refuse(model, m)
    cfg = model.cfg
    sh = param_shardings(mesh, param_specs(cfg))
    perm = kv_order(cfg, m)
    with torch.no_grad():
        for name, p in model.params().items():
            full = p.data
            if _is_kv(name) and perm is not None:
                full = full[:, perm.to(full.device)]
            p.data = place(full, mesh, sh[name])
    split = frozenset(n.rsplit(".", 1)[-1] for n, spec in sh.items()
                      if n.rsplit(".", 1)[-1] in ("embed", "mu")
                      and "model" in spec)
    model.mesh = mesh
    model.tp = TensorParallel(mesh.get_group("model"), m,
                              mesh.get_local_rank("model"),
                              attn_sharded=perm is not None, split=split)
    model.hook = hook


def _kv_inverse(cfg, m: int) -> Optional[torch.Tensor]:
    perm = kv_order(cfg, m)
    return None if perm is None else torch.argsort(perm)


def full_named(model, local: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """Whole tensors from every rank's blocks of tensors laid out as
    ``model.params()`` (the parameters, or the optimiser's moments): a
    collective, every rank gets them."""
    mesh = model.mesh
    if mesh is None:
        return dict(local)
    sh = param_shardings(mesh, param_specs(model.cfg))
    inv = _kv_inverse(model.cfg, axis_sizes(mesh)["model"])
    out = {}
    for name, t in local.items():
        full = gather(t, mesh, sh[name])
        if _is_kv(name) and inv is not None:
            full = full[:, inv.to(full.device)]
        out[name] = full
    return out


def local_named(model, full: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The inverse of ``full_named``: this rank's blocks of whole
    tensors laid out as ``model.params()``."""
    mesh = model.mesh
    if mesh is None:
        return dict(full)
    sh = param_shardings(mesh, param_specs(model.cfg))
    perm = kv_order(model.cfg, axis_sizes(mesh)["model"])
    out = {}
    for name, t in full.items():
        if _is_kv(name) and perm is not None:
            t = t[:, perm.to(t.device)]
        out[name] = place(t, mesh, sh[name])
    return out


def data_rank(mesh) -> int:
    """This rank's index over the data axes (pod-major)."""
    sizes = axis_sizes(mesh)
    r = 0
    for a in _axes(mesh)[0]:
        r = r * sizes[a] + mesh.get_local_rank(a)
    return r


def data_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's rows of a global batch (dim 0)."""
    d = data_size(mesh)
    if x.shape[0] % d:
        raise ValueError(f"batch {x.shape[0]} does not split over {d} data "
                         f"ranks")
    k = x.shape[0] // d
    return x[data_rank(mesh) * k:(data_rank(mesh) + 1) * k]


def local_cache_specs(model, batch: int, max_seq: int) -> Dict:
    """The model's cache specs for ``batch`` local rows, each leaf in its
    local shape under ``cache_shardings`` (``length`` per local row)."""
    mesh = model.mesh
    sizes = axis_sizes(mesh)
    specs = model.cache_specs(batch * data_size(mesh), max_seq)
    placed = cache_shardings(mesh, specs)

    def walk(tree, sh):
        out = {}
        for n, s in tree.items():
            if isinstance(s, dict):
                out[n] = walk(s, sh[n])
                continue
            shape, dt = s
            if n == "length":
                out[n] = ((batch,), dt)
                continue
            spec = sh[n]
            if n in ("k", "v", "ck", "cv", "attn_k", "attn_v") \
                    and spec[2] == "model":
                raise NotImplementedError(
                    f"{model.cfg.name}: {model.cfg.n_kv_heads} KV heads do "
                    f"not split over a model axis of {sizes['model']}, and "
                    f"split-sequence decode is not ported: ROADMAP.md Queue "
                    f"3")
            local = []
            for dim, ax in zip(shape, spec):
                axes = () if ax is None else (
                    ax if isinstance(ax, tuple) else (ax,))
                local.append(dim // math.prod(sizes[a] for a in axes))
            out[n] = (tuple(local), dt)
        return out

    return walk(specs, placed)


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
    """(average the gradients over the data axes, the ``reduce`` of the
    global-norm clip) for the leaves ``names``."""
    sh = param_shardings(mesh, param_specs(model.cfg))
    data = set(_axes(mesh)[0])
    by_data = [bool(set(_flat(sh[n])) & data) for n in names]
    by_model = [("model" in _flat(sh[n])) for n in names]
    dsize = data_size(mesh)
    from .moe_ep import data_group
    mg, dg = mesh.get_group("model"), data_group(mesh)

    def average(grads, loss):
        out = []
        for g, split in zip(grads, by_data):
            if not split:
                g = col._all_reduce(g, dg)
            out.append(g / dsize)
        return out, col._all_reduce(loss.detach(), dg) / dsize

    def reduce(sq):
        v = torch.stack(sq)
        for group, which in ((mg, by_model), (dg, by_data)):
            mask = torch.tensor(which, device=v.device)
            summed = col._all_reduce(v * mask, group)
            v = torch.where(mask, summed, v)
        return list(v.unbind())

    return average, reduce


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
    (``place_model``, with ``layout_mode``'s layer-boundary hook): build
    the optimiser state (``adamw_init(model.params())``) after this call.
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
    average, reduce = _grad_sync(model, mesh, names) if mesh is not None \
        else (None, None)

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
        if average is not None:
            grads, loss = average(grads, loss)
        step_lr = schedule(opt_state.step) if schedule is not None else lr
        adamw_update(dict(zip(names, grads)), opt_state, params, step_lr,
                     reduce=reduce)
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
