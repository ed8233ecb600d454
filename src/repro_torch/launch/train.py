"""End-to-end training on one device (the card unless asked).

The port of ``repro.launch.train``: model zoo, AdamW with the WSD schedule,
the deterministic synthetic data stream and async checkpointing with
resume, with the same flags and log lines, on ``--device cuda`` by default:

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6_1p6b \\
        --steps 8 --batch 8 --seq 1024 --ckpt-dir /tmp/ckpt --ckpt-every 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6_1p6b \\
        --smoke --device cpu --steps 3 --batch 2 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper_small \\
        --smoke --device cpu --steps 2 --batch 2 --seq 16
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.train --arch llama3p2_3b \\
        --smoke --device cpu --model-axis 2 --layout-mode fixed --steps 3 \\
        --batch 4 --seq 32

An encoder-decoder (whisper) trains on the stream's stub frame embeddings
(``frames_dim = d_model``, ``frames_len = enc_frames``), as ``repro``'s
launcher does.

``--ckpt-dir`` resumes from the newest committed checkpoint there ("resumed
from step N"), saves every ``--ckpt-every`` steps and at the end, and
waits for the writes before it exits.  The checkpoint holds ``repro``'s
tree (``{"params", "opt"}``, per-layer leaves stacked on a layer axis,
``weights.to_repro_lm_params`` / ``to_repro_adamw_state``), so a
checkpoint of either package's trainer resumes in the other; a restore
loads into the model's parameters and the f32 state in place.

Under ``torch.distributed.run`` (``WORLD_SIZE`` set) the trainer builds
``make_local_mesh(--model-axis)`` (``nccl`` on cuda, ``gloo`` on cpu; a
``--model-axis`` above 1 without that world raises) and trains through
the sharded step with ``--layout-mode``'s layer-boundary layout
(``coswitch`` or ``fixed``).  Every rank draws the same global batch from
the seeded stream and takes its data rank's rows, so the losses do not
depend on the mesh.  A checkpoint is gathered whole on every rank and
written by rank 0 alone, with ``repro``'s ``PartitionSpec`` strings in its
manifest; a resume places the restored tensors on the mesh again.  Only
rank 0 logs.  Console output goes through the
``repro_torch.obs`` logger (``--log-level`` / ``REPRO_LOG``);
``REPRO_TRACE=out.jsonl`` records per-step spans and a ``train.step_ms``
histogram.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch import obs

log = obs.get_logger("train")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="llama3p2_3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the config's widths at this depth "
                         "(default 0: the config's own)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--layout-mode", default="coswitch",
                    choices=["coswitch", "fixed"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--log-level", default=None,
                    choices=["debug", "info", "warning", "error"],
                    help="console log threshold (default: REPRO_LOG or info)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    return ap.parse_args(argv)


def _ckpt_tree(model, opt_state, cfg) -> dict:
    """The checkpoint tree in ``repro``'s layout; under a mesh every
    tensor gathered whole (a collective: every rank calls it)."""
    from repro_torch.api import (AdamWState, full_named,
                                 to_repro_adamw_state, to_repro_lm_params)
    whole = AdamWState(step=opt_state.step,
                       mu=full_named(model, opt_state.mu, state=True),
                       nu=full_named(model, opt_state.nu, state=True),
                       master=full_named(model, opt_state.master,
                                         state=True))
    return {"params": to_repro_lm_params(full_named(model, model.params()),
                                         cfg),
            "opt": to_repro_adamw_state(whole, cfg)}


def restore_into(mgr, model, opt_state, cfg) -> Optional[int]:
    """Restore the newest checkpoint into ``model`` and ``opt_state`` in
    place (under a mesh, each rank its blocks: the parameters' FSDP
    blocks, the state's ZeRO-1 blocks); its step, or None where there is
    none."""
    import torch

    from repro_torch.api import (local_named, repro_adamw_template,
                                 repro_lm_template, to_torch_adamw_state,
                                 to_torch_lm_params)
    step, tree = mgr.restore_latest({"params": repro_lm_template(cfg),
                                     "opt": repro_adamw_template(cfg)})
    if step is None:
        return None
    params = local_named(model, to_torch_lm_params(tree["params"], cfg,
                                                   model.device))
    host = to_torch_adamw_state(tree["opt"], cfg, model.device)
    with torch.no_grad():
        for name, p in model.params().items():
            p.copy_(params[name])
        for own, got in ((opt_state.mu, host.mu), (opt_state.nu, host.nu),
                         (opt_state.master, host.master)):
            got = local_named(model, got, state=True)
            for name, t in own.items():
                t.copy_(got[name])
    opt_state.step = host.step
    return step


def train(args: argparse.Namespace) -> dict:
    """Train ``args.steps`` steps (resuming from ``args.ckpt_dir``).
    Returns ``{"start", "losses" (step -> loss), "model", "opt_state"}``."""
    import dataclasses
    import os

    import torch

    from repro_torch.api import (CheckpointManager, DataConfig,
                                 SyntheticLMStream, adamw_init, build_model,
                                 get_config, make_train_step, wsd_schedule)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mesh, rank = None, 0
    if args.model_axis > 1 and "WORLD_SIZE" not in os.environ:
        raise ValueError(f"--model-axis {args.model_axis} needs a world of "
                         f"ranks: run under python -m "
                         f"torch.distributed.run --nproc-per-node N")
    if "WORLD_SIZE" in os.environ:
        from repro_torch.api import checkpoint_shardings, make_local_mesh
        mesh = make_local_mesh(args.model_axis, args.device)
        rank = torch.distributed.get_rank()
    model = build_model(cfg, device=args.device)
    dev = model.device
    model.init(torch.Generator(device=dev).manual_seed(0))

    def sched(s):
        return wsd_schedule(s, peak_lr=args.lr,
                            warmup=max(2, args.steps // 10),
                            stable=args.steps // 2,
                            decay=max(1, args.steps // 3))

    step_fn = make_train_step(model, mesh, layout_mode=args.layout_mode,
                              accum=args.accum, schedule=sched)
    opt_state = adamw_init(model.params())   # the local blocks on a mesh
    encdec = cfg.family == "encdec"       # stub frames for the encoder
    stream = SyntheticLMStream(DataConfig(
        vocab=cfg.vocab, global_batch=args.batch, seq_len=args.seq,
        frames_dim=cfg.d_model if encdec else 0,
        frames_len=cfg.enc_frames))

    start, mgr = 0, None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        s = restore_into(mgr, model, opt_state, cfg)
        if s is not None:
            start = s
            if rank == 0:
                log.info("resumed from step %d", start)

    saved = start
    specs = checkpoint_shardings(model, mesh) if mesh is not None else None

    def save(step: int) -> None:
        nonlocal saved
        tree = _ckpt_tree(model, opt_state, cfg)
        if rank == 0:
            mgr.save(step, tree, specs)
        saved = step

    t0 = time.time()
    traced = obs.enabled()
    losses = {}
    for step in range(start, args.steps):
        if traced:
            step_t0 = obs.now_us()
        opt_state, metrics = step_fn(opt_state, stream.batch_at(step))
        losses[step] = metrics["loss"]
        if traced:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            obs.record_span("train.step", step_t0, {"step": step})
            obs.observe("train.step_ms", (obs.now_us() - step_t0) / 1e3)
        if rank == 0 and (step % args.log_every == 0
                          or step == args.steps - 1):
            loss = float(metrics["loss"])
            log.info("step=%d loss=%.4f lr=%.2e (%.1fs)",
                     step, loss, metrics["lr"], time.time() - t0)
        if mgr and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
    if mgr:
        if saved != args.steps:          # else the last save holds this state
            save(args.steps)
        if rank == 0 and saved != start and not mgr.wait(timeout=3600.0):
            raise RuntimeError("checkpoint writes did not finish in 3600 s")
        mgr.close()
    if mesh is not None:
        torch.distributed.barrier()   # rank 0's writes are done
    if rank == 0:
        log.info("done")
    return {"start": start, "model": model, "opt_state": opt_state,
            "losses": {s: float(v) for s, v in losses.items()}}


def main(argv=None) -> None:
    args = parse_args(argv)
    obs.configure_from_env()          # REPRO_TRACE=path enables tracing
    if args.log_level:
        obs.set_level(args.log_level)
    train(args)


if __name__ == "__main__":
    main()
