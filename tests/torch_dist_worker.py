"""One rank of the port's multi-rank CPU runs (``test_torch_distributed``).

``run(rank, world, store, tasks, out)`` joins a ``gloo`` world through a
``FileStore`` at ``store`` (a file under the test's tmp dir, so parallel
test workers never share a port), runs each task of ``tasks`` on the mesh
it names and, on rank 0, pickles ``{task name: result}`` to ``out``.
Results are numpy; an exception on any rank is pickled instead (as its
traceback), and the rank exits non-zero.  No JAX here: the module is
imported by spawned processes.
"""
from __future__ import annotations

import dataclasses
import pickle
import traceback

import torch
import torch.distributed as dist


#: whisper SMOKE's variant whose 6 heads (of 16 dims) and 30 frames do not
#: divide a model axis of 4: its attention takes the split paths, and its
#: cross cache stays whole on every rank, as whisper-small's 1500 frames do
#: on 16
VARIANT = {"n_heads": 6, "n_kv_heads": 6, "d_head": 16, "enc_frames": 30}


def smoke_f32(arch: str, variant=False):
    """The SMOKE config in f32 (with ``variant``, ``VARIANT``'s)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    return dataclasses.replace(cfg, **VARIANT) if variant else cfg


def _model(arch: str, params, variant=False):
    from repro_torch import api
    cfg = smoke_f32(arch, variant)
    model = api.build_model(cfg, device="cpu")
    return model.load_params(api.to_torch_lm_params(params, cfg, "cpu"))


def _counts():
    """Forward collective calls by kind, and under ``by_dim`` their result
    bytes by ``kind/mesh dimension``."""
    from repro_torch.distributed import collectives as col
    return {**col.CALLS, "by_dim": {f"{k}/{d}": b
                                    for (k, d), b in col.BYTES.items()}}


class clip_seen:
    """Within the block, every ``clip_by_global_norm`` of the optimiser
    also appends ``(the gradients it was given, the global norm it
    computed)`` to ``seen``: the step's own gradients and its clip."""

    def __enter__(self):
        from repro_torch.optim import adamw
        self.seen, self._real = [], adamw.clip_by_global_norm

        def clip(grads, max_norm, reduce=None):
            out, gnorm = self._real(grads, max_norm, reduce)
            self.seen.append(({k: g.detach() for k, g in grads.items()},
                              float(gnorm)))
            return out, gnorm

        adamw.clip_by_global_norm = clip
        return self

    def __exit__(self, *exc):
        from repro_torch.optim import adamw
        adamw.clip_by_global_norm = self._real


def train(mesh, arch, params, tokens, mode, steps=1, frames=None,
          variant=False):
    """Losses, the first step's gradients as the optimiser gets them
    (gathered whole) and the global norm its clip computed, the whole
    updated parameters after ``steps`` steps (an encoder-decoder's batch
    with ``frames``), how many leaves have a ZeRO-1 block and which
    ``repro`` leaves ZeRO-1 splits on the layer axis."""
    from repro_torch import api
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.stepfn import full_named
    model = _model(arch, params, variant)
    step = api.make_train_step(model, mesh, layout_mode=mode)
    opt = api.adamw_init(model.params())
    col.reset_calls()
    losses = []
    batch = {"tokens": tokens}
    if frames is not None:
        batch["frames"] = frames
    with clip_seen() as clip:
        for _ in range(steps):
            opt, met = step(opt, batch)
            losses.append(float(met["loss"]))
    calls = _counts()
    grads, gnorm = clip.seen[0]
    full = full_named(model, {k: v.detach() for k, v in
                              model.params().items()})
    return {"losses": losses, "calls": calls, "gnorm": gnorm,
            "grads": {k: v.numpy() for k, v in
                      full_named(model, grads, state=True).items()},
            "params": {k: v.numpy() for k, v in full.items()},
            "zero1": sum(p.zero1 is not None
                         for p in model.params().values()),
            "layer_sharded": sorted(model.placement["layers"])}


class sharding_as:
    """Within the block, placements as a test asks: ``fsdp=True`` forces
    FSDP (``_wants_fsdp``) and splits every leaf of at least ``min_elems``
    elements; ``whole=True`` keeps every parameter and its state whole
    over the data axes (no FSDP, no ZeRO-1: the step that the sharded ones
    must equal)."""

    def __init__(self, fsdp=False, whole=False, min_elems=0):
        self.fsdp, self.whole, self.min_elems = fsdp, whole, min_elems

    def __enter__(self):
        from repro_torch.distributed import sharding, stepfn
        self._saved = (stepfn._wants_fsdp, sharding.FSDP_MIN_ELEMENTS,
                       stepfn.opt_shardings)
        if self.fsdp:
            stepfn._wants_fsdp = lambda model: True
            sharding.FSDP_MIN_ELEMENTS = self.min_elems
        if self.whole:
            stepfn._wants_fsdp = lambda model: False
            stepfn.opt_shardings = lambda mesh, p_sh, specs: dict(p_sh)
        return self

    def __exit__(self, *exc):
        from repro_torch.distributed import sharding, stepfn
        (stepfn._wants_fsdp, sharding.FSDP_MIN_ELEMENTS,
         stepfn.opt_shardings) = self._saved


def _held_bytes(tensors):
    return int(sum(t.numel() * t.element_size() for t in tensors))


def fsdp_train(mesh, arch, params, tokens, mode="coswitch", steps=2,
               fsdp=False, whole=False):
    """``train`` under ``sharding_as(fsdp, whole)``, and what this rank
    holds: the bytes of its parameters and of its optimiser state, by
    name, and whether any parameter is FSDP-split or has a ZeRO-1 block;
    the first step's updated parameters too."""
    from repro_torch import api
    from repro_torch.distributed.stepfn import full_named
    with sharding_as(fsdp=fsdp, whole=whole):
        model = _model(arch, params)
        step = api.make_train_step(model, mesh, layout_mode=mode)
        opt = api.adamw_init(model.params())
        held = {"params": {n: _held_bytes([p]) for n, p in
                           model.params().items()},
                "state": {n: _held_bytes([opt.mu[n], opt.nu[n],
                                          opt.master[n]])
                          for n in opt.mu},
                "fsdp": sum(p.fsdp is not None
                            for p in model.params().values()),
                "zero1": sum(p.zero1 is not None
                             for p in model.params().values())}
        losses, first = [], None
        with clip_seen() as clip:
            for i in range(steps):
                opt, met = step(opt, {"tokens": tokens})
                losses.append(float(met["loss"]))
                if i == 0:     # copies: a replicated leaf is the parameter
                    first = {k: v.numpy().copy() for k, v in full_named(
                        model, {k: v.detach() for k, v in
                                model.params().items()}).items()}
        grads, gnorm = clip.seen[0]
        full = full_named(model, {k: v.detach() for k, v in
                                  model.params().items()})
        return {"losses": losses, "gnorm": gnorm, "held": held,
                "rank": dist.get_rank(), "first": first,
                "grads": {k: v.numpy() for k, v in
                          full_named(model, grads, state=True).items()},
                "params": {k: v.numpy() for k, v in full.items()}}


def held(mesh, arch, fsdp=False, min_elems=0):
    """Every rank's held bytes (parameters and state, by name) after
    placing the SMOKE ``arch`` for training, gathered to rank 0."""
    from repro_torch import api
    from repro_torch.configs import get_config
    with sharding_as(fsdp=fsdp, min_elems=min_elems):
        model = api.build_model(get_config(arch, smoke=True), device="cpu")
        api.make_train_step(model, mesh)
        opt = api.adamw_init(model.params())
    mine = {"params": {n: _held_bytes([p]) for n, p in
                       model.params().items()},
            "state": {n: _held_bytes([opt.mu[n], opt.nu[n], opt.master[n]])
                      for n in opt.mu}}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def fsdp_save(mesh, arch, params, directory):
    """``save`` with FSDP forced on every leaf."""
    with sharding_as(fsdp=True):
        return save(mesh, arch, params, directory)


def loss(mesh, arch, params, tokens, mode, zero_scan=False):
    """The global batch's loss on the mesh (no update); ``zero_scan``
    swaps ``ops.linear_scan`` for zeros."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.stepfn import data_rows, place_model
    from repro_torch.kernels import ops
    model = _model(arch, params)
    place_model(model, mesh, mode)
    col.reset_calls()
    real = ops.linear_scan
    if zero_scan:
        ops.linear_scan = lambda q, k, v, w: torch.zeros_like(v)
    try:
        with torch.no_grad():
            val = model.loss({"tokens": data_rows(torch.as_tensor(tokens),
                                                  mesh)})
    finally:
        ops.linear_scan = real
    calls = _counts()
    dist.all_reduce(val)       # each data rank's mean, m times over
    return {"loss": float(val) / dist.get_world_size(), "calls": calls}


def ep_slots(mesh, arch, params):
    """``moe_apply_ep`` against ``moe_apply`` on layer 0's MoE block and
    the same tokens, on a model axis of 1, where the shard's capacity is
    the global one: whether the slot the EP path gave each (token, k)
    equals ``moe_dispatch``'s for ``moe_apply``'s routing, how many were
    dropped, and the outputs' max |diff| and max |out|.  Half the tokens
    are one token repeated, so its experts overflow."""
    from repro_torch.distributed import moe_ep
    from repro_torch.distributed.stepfn import place_model
    from repro_torch.models import blocks
    model, whole = _model(arch, params), _model(arch, params)
    place_model(model, mesh)     # the experts split over the data axis
    cfg, p = model.cfg, model.layers[0]["ffn"]
    g = torch.Generator().manual_seed(dist.get_rank())
    x = torch.randn((2, 32, cfg.d_model), generator=g)
    x[:, :16] = x[0, 0]
    with torch.no_grad():
        got, slot_ep = moe_ep.moe_apply_ep(cfg, p, x, mesh, return_slot=True)
        want = blocks.moe_apply(cfg, whole.layers[0]["ffn"], x)
        flat, _, (_, idx) = blocks.moe_route(cfg, p, x)
        C = blocks.moe_capacity(cfg, 64)
        slot_one, _ = blocks.moe_dispatch(flat, idx, cfg.n_experts, C)
    return {"same_slots": bool(torch.equal(slot_ep, slot_one)),
            "C": C, "C_ep": moe_ep.capacity(cfg, 64),
            "dropped": int((slot_ep == cfg.n_experts * C).sum()),
            "max_abs_err": float((got - want).abs().max()),
            "ref_max_abs": float(want.abs().max())}


def serve(mesh, arch, params, tokens, max_seq, steps, frames=None,
          variant=False):
    """Prefill (an encoder-decoder's over ``frames``) then ``steps``
    greedy decode steps through ``prefill_step`` and ``serve_step``: the
    global batch's logits of each (each data rank's rows gathered, outside
    the counted collectives), and the calls of the decode kernels' entry
    points on the decode steps (``kernel_calls``)."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.stepfn import prefill_step, serve_step
    model = _model(arch, params, variant)
    B, T = tokens.shape
    col.reset_calls()
    with torch.no_grad():
        fn = prefill_step(model, mesh, B, T, max_seq,
                          frames=frames is not None)
        cache, logits = fn(tokens) if frames is None else fn(tokens, frames)
        logits = _data_gathered(logits, mesh)
        step = serve_step(model, mesh, B, max_seq)
        outs = [logits]
        with kernel_calls() as kernels:
            for _ in range(steps):
                cache, logits = step(cache, outs[-1].argmax(-1))
                outs.append(_data_gathered(logits, mesh))
    return {"logits": torch.stack(outs).numpy(), "calls": _counts(),
            "kernel_calls": kernels.calls}


def _data_gathered(t, mesh):
    """Every data rank's rows of ``t`` (dim 0), in data-rank order."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import data_size
    d = data_size(mesh)
    out = t.new_empty((d * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(),
                                group=col.data_group(mesh))
    return out


class kernel_calls:
    """Within the block, ``calls`` counts the calls of ``ops.gqa_decode``
    and ``ops.gqa_decode_partial`` (the entry points of the decode
    kernel and its partial variant)."""

    NAMES = ("gqa_decode", "gqa_decode_partial")

    def __enter__(self):
        from repro_torch.kernels import ops
        self.calls = dict.fromkeys(self.NAMES, 0)
        self._real = {n: getattr(ops, n) for n in self.NAMES}

        def counted(name):
            def fn(*args):
                self.calls[name] += 1
                return self._real[name](*args)
            return fn
        for n in self.NAMES:
            setattr(ops, n, counted(n))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for n, fn in self._real.items():
            setattr(ops, n, fn)


def train_state(model):
    """An optimiser state at step 3 whose moments are set from the
    parameters (``mu = p / 2``, ``nu = p p``, on the state's blocks), so a
    restore that puts a block in the wrong place shows in them too."""
    from repro_torch import api
    opt = api.adamw_init(model.params())
    with torch.no_grad():
        for name, w in opt.master.items():
            opt.mu[name].copy_(0.5 * w)
            opt.nu[name].copy_(w * w)
    opt.step = 3
    return opt


def save(mesh, arch, params, directory):
    """The trainer's checkpoint (``launch.train._ckpt_tree``: whole
    tensors, rank 0 writing, ``repro``'s sharding strings) of a model
    placed on the mesh and ``train_state`` at ``directory/step_00000003``;
    then the trainer's resume (``restore_into``) into that model and state
    zeroed: whether every restored block (``wkv``'s in its KV-head order
    and a mamba2 mixer's ``in_proj``, ``conv_w`` and ``conv_b`` in their
    SSM-head order included) equals the one saved."""
    import pathlib

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.store import save_pytree
    from repro_torch.distributed.stepfn import (checkpoint_shardings,
                                                place_model)
    from repro_torch.launch.train import _ckpt_tree, restore_into
    model = _model(arch, params)
    place_model(model, mesh)
    opt = train_state(model)
    tree = _ckpt_tree(model, opt, model.cfg)
    if dist.get_rank() == 0:
        save_pytree(tree, pathlib.Path(directory) / "step_00000003",
                    checkpoint_shardings(model, mesh))
    dist.barrier()
    state = {"params": model.params(), "mu": opt.mu, "nu": opt.nu,
             "master": opt.master}
    want = {k: {n: t.detach().clone() for n, t in v.items()}
            for k, v in state.items()}
    with torch.no_grad():
        for v in state.values():
            for t in v.values():
                t.zero_()
    opt.step = 0
    mgr = CheckpointManager(directory)
    step = restore_into(mgr, model, opt, model.cfg)
    mgr.close()
    same = [torch.equal(state[k][n], want[k][n])
            for k in want for n in want[k]]
    return {"step": step, "opt_step": opt.step,
            "restored_blocks_equal": all(same), "checked": len(same),
            "kv_checked": sum(n.endswith("wkv") for n in want["params"]),
            "ssm_checked": sum(n.endswith(("in_proj", "conv_w", "conv_b"))
                               for n in want["params"])}


def refuse(mesh, arch):
    """What placing the SMOKE ``arch`` on the mesh raises."""
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.distributed.stepfn import place_model
    model = api.build_model(get_config(arch, smoke=True), device="cpu")
    try:
        place_model(model, mesh)
    except NotImplementedError as e:
        return {"raised": "NotImplementedError", "message": str(e)}
    return {"raised": None}


def meshes(mesh):
    """The mesh builders over this world: their shapes and refusals."""
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    built = [make_local_mesh(1, "cpu"), make_local_mesh(2, "cpu")]
    out = {"shapes": [list(m.shape) for m in built],
           "names": list(built[0].mesh_dim_names)}
    for key, fn in (("local_3", lambda: make_local_mesh(3, "cpu")),
                    ("production", lambda: make_production_mesh(
                        device="cpu"))):
        try:
            fn()
        except ValueError as e:
            out[key] = str(e)
    return out


TASKS = {"meshes": meshes, "train": train, "loss": loss, "serve": serve,
         "save": save, "ep_slots": ep_slots, "refuse": refuse,
         "fsdp_train": fsdp_train,
         "held": held, "fsdp_save": fsdp_save}


def run(rank: int, world: int, store: str, tasks, out: str) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        from repro_torch.launch.mesh import make_local_mesh
        meshes = {}
        results = {}
        for name, kind, model_axis, kw in tasks:
            if model_axis not in meshes:
                meshes[model_axis] = make_local_mesh(model_axis, "cpu")
            results[name] = TASKS[kind](meshes[model_axis], **kw)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:
        results = {"error": traceback.format_exc()}
        if rank != 0:
            with open(f"{out}.rank{rank}", "wb") as f:
                pickle.dump(results, f)
            raise
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(results, f)
        if "error" in results:
            raise SystemExit(1)
