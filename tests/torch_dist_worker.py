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


def _model(arch: str, params):
    from repro_torch import api
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = api.build_model(cfg, device="cpu")
    return model.load_params(api.to_torch_lm_params(params, cfg, "cpu"))


def _counts():
    from repro_torch.distributed import collectives as col
    return dict(col.CALLS)


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


def train(mesh, arch, params, tokens, mode, steps=1):
    """Losses, the first step's gradients as the optimiser gets them
    (gathered whole) and the global norm its clip computed, and the whole
    updated parameters after ``steps`` steps."""
    from repro_torch import api
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.stepfn import full_named
    model = _model(arch, params)
    step = api.make_train_step(model, mesh, layout_mode=mode)
    opt = api.adamw_init(model.params())
    col.reset_calls()
    losses = []
    with clip_seen() as clip:
        for _ in range(steps):
            opt, met = step(opt, {"tokens": tokens})
            losses.append(float(met["loss"]))
    calls = _counts()
    grads, gnorm = clip.seen[0]
    full = full_named(model, {k: v.detach() for k, v in
                              model.params().items()})
    return {"losses": losses, "calls": calls, "gnorm": gnorm,
            "grads": {k: v.numpy()
                      for k, v in full_named(model, grads).items()},
            "params": {k: v.numpy() for k, v in full.items()}}


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


def serve(mesh, arch, params, tokens, max_seq, steps):
    """Prefill then ``steps`` greedy decode steps through ``prefill_step``
    and ``serve_step``: the logits of each."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.stepfn import prefill_step, serve_step
    model = _model(arch, params)
    B, T = tokens.shape
    col.reset_calls()
    with torch.no_grad():
        cache, logits = prefill_step(model, mesh, B, T, max_seq)(tokens)
        step = serve_step(model, mesh, B, max_seq)
        outs = [logits]
        for _ in range(steps):
            cache, logits = step(cache, outs[-1].argmax(-1))
            outs.append(logits)
    return {"logits": torch.stack(outs).numpy(), "calls": _counts()}


def train_state(model):
    """An optimiser state at step 3 whose moments are set from the
    parameters (``mu = p / 2``, ``nu = p p``), so a restore that puts a
    block in the wrong place shows in them too."""
    from repro_torch import api
    opt = api.adamw_init(model.params())
    with torch.no_grad():
        for name, p in model.params().items():
            opt.mu[name].copy_(0.5 * p)
            opt.nu[name].copy_(p * p)
    opt.step = 3
    return opt


def save(mesh, arch, params, directory):
    """The trainer's checkpoint (``launch.train._ckpt_tree``: whole
    tensors, rank 0 writing, ``repro``'s sharding strings) of a model
    placed on the mesh and ``train_state`` at ``directory/step_00000003``;
    then the trainer's resume (``restore_into``) into that model and state
    zeroed: whether every restored block (``wkv``'s, in its KV-head order,
    included) equals the one saved."""
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
            "kv_checked": sum(n.endswith("wkv") for n in want["params"])}


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


def refuse_serve(mesh, arch, batch, max_seq):
    """What ``serve_step`` raises for the SMOKE ``arch`` on the mesh."""
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.distributed.stepfn import serve_step
    model = api.build_model(get_config(arch, smoke=True), device="cpu")
    try:
        serve_step(model, mesh, batch, max_seq)
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
         "refuse_serve": refuse_serve}


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
