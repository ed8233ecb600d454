"""End-to-end training on the PyTorch port, with checkpoint/restart fault
tolerance.

Trains a ~100M-param reduced llama on the synthetic pipeline with async
checkpointing, then simulates a failure and resumes: the supervisor
restores the latest checkpoint (written in ``repro``'s format) and the
loss curve continues exactly.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
        [--device cuda|cpu]

The counterpart of ``examples/train_lm.py`` through ``repro_torch.api``.
``--device`` defaults to ``cuda`` and raises where there is no CUDA;
``--device cpu`` runs the plain PyTorch path on the llama SMOKE config
(a CPU-sized run).  A checkpoint is saved every ``steps // 4`` steps, at
most 50 (``examples/train_lm.py``'s 50 at the default 200).
"""
import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.api import (CheckpointManager, DataConfig, SyntheticLMStream,
                             TrainSupervisor, adamw_init, build_model,
                             get_config, make_train_step,
                             repro_adamw_template, repro_lm_template,
                             to_repro_adamw_state, to_repro_lm_params,
                             to_torch_adamw_state, to_torch_lm_params,
                             wsd_schedule)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--fail-at", type=int, default=120)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu "
                         "(the SMOKE config)")
    args = ap.parse_args(argv)

    small = args.device == "cpu"
    cfg = get_config("llama3p2_3b", smoke=True)
    batch, seq = (4, 32) if small else (16, 128)
    if not small:         # ~100M params: scale the llama3.2 smoke config up
        cfg = dataclasses.replace(cfg, n_layers=8, d_model=512, n_heads=8,
                                  n_kv_heads=4, d_ff=1536, vocab=8192)
    model = build_model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    n_params = sum(p.numel() for p in model.params().values())
    print(f"model: {n_params/1e6:.1f}M params")

    def sched(s):
        return wsd_schedule(s, peak_lr=3e-3, warmup=min(20, args.steps // 4),
                            stable=args.steps // 2, decay=args.steps // 3)

    step = make_train_step(model, schedule=sched)
    stream = SyntheticLMStream(DataConfig(vocab=cfg.vocab, global_batch=batch,
                                          seq_len=seq))
    state = {"opt": adamw_init(model.params())}
    ckdir = tempfile.mkdtemp(prefix="feather_ck_")
    mgr = CheckpointManager(ckdir, keep=2)
    failed_once = {"v": False}
    losses = []

    def step_fn(s):
        if s == args.fail_at and not failed_once["v"]:
            failed_once["v"] = True
            raise RuntimeError("injected node failure")
        state["opt"], m = step(state["opt"], stream.batch_at(s))
        loss = float(m["loss"])
        losses.append(loss)
        if s % 25 == 0:
            print(f"  step {s}: loss={loss:.4f} lr={float(m['lr']):.2e}")
        return {"loss": loss}

    def save_fn(s):
        mgr.save(s, {"params": to_repro_lm_params(model.params(), cfg),
                     "opt": to_repro_adamw_state(state["opt"], cfg)})
        mgr.wait()

    def restore_fn():
        s, tree = mgr.restore_latest({"params": repro_lm_template(cfg),
                                      "opt": repro_adamw_template(cfg)})
        if s is None:
            return 0
        params = to_torch_lm_params(tree["params"], cfg, model.device)
        with torch.no_grad():
            for name, p in model.params().items():
                p.copy_(params[name])
        state["opt"] = to_torch_adamw_state(tree["opt"], cfg, model.device)
        print(f"  [supervisor] restored checkpoint @ step {s}")
        return s

    sup = TrainSupervisor(
        total_steps=args.steps, step_fn=step_fn,
        save_every=max(1, min(50, args.steps // 4)),
        save_fn=save_fn, restore_fn=restore_fn,
        failure_detector=lambda: False, restart_fn=lambda: None)
    restarts, _ = sup.run()
    mgr.close()
    print(f"done: restarts={restarts} first-loss={losses[0]:.3f} "
          f"final-loss={np.mean(losses[-10:]):.3f}")


if __name__ == "__main__":
    main()
