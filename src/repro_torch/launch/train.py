"""End-to-end training on one device (the card unless asked).

The port of ``repro.launch.train``: model zoo, AdamW with the WSD schedule
and the deterministic synthetic data stream, with the same flags and log
lines, on ``--device cuda`` by default:

    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6_1p6b \\
        --steps 8 --batch 8 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6_1p6b \\
        --smoke --device cpu --steps 3 --batch 2 --seq 64

Not ported yet: ``--ckpt-dir`` and ``--ckpt-every`` (checkpoint and
resume, ROADMAP Queue 1 item 9) and ``--model-axis`` above 1 (the mesh,
item 10) raise ``NotImplementedError``; ``--layout-mode`` only selects the
mesh's sharding hook and is not taken.  Console output goes through the
``repro_torch.obs`` logger (``--log-level`` / ``REPRO_LOG``);
``REPRO_TRACE=out.jsonl`` records per-step spans and a ``train.step_ms``
histogram.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import obs

log = obs.get_logger("train")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="llama3p2_3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--log-level", default=None,
                    choices=["debug", "info", "warning", "error"],
                    help="console log threshold (default: REPRO_LOG or info)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.ckpt_dir or args.ckpt_every is not None:
        raise NotImplementedError("--ckpt-dir/--ckpt-every: checkpoint and "
                                  "resume are not ported yet: ROADMAP.md "
                                  "Queue 1 item 9")
    if args.model_axis > 1:
        raise NotImplementedError("--model-axis > 1: the mesh is not ported "
                                  "yet: ROADMAP.md Queue 1 item 10")

    obs.configure_from_env()          # REPRO_TRACE=path enables tracing
    if args.log_level:
        obs.set_level(args.log_level)

    import torch

    from repro_torch.api import (DataConfig, SyntheticLMStream, adamw_init,
                                 build_model, get_config, make_train_step,
                                 wsd_schedule)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device)
    dev = model.device
    model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = adamw_init(model.params())

    def sched(s):
        return wsd_schedule(s, peak_lr=args.lr,
                            warmup=max(2, args.steps // 10),
                            stable=args.steps // 2,
                            decay=max(1, args.steps // 3))

    step_fn = make_train_step(model, accum=args.accum, schedule=sched)
    stream = SyntheticLMStream(DataConfig(vocab=cfg.vocab,
                                          global_batch=args.batch,
                                          seq_len=args.seq))

    t0 = time.time()
    traced = obs.enabled()
    for step in range(args.steps):
        if traced:
            step_t0 = obs.now_us()
        opt_state, metrics = step_fn(opt_state, stream.batch_at(step))
        if traced:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            obs.record_span("train.step", step_t0, {"step": step})
            obs.observe("train.step_ms", (obs.now_us() - step_t0) / 1e3)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            log.info("step=%d loss=%.4f lr=%.2e (%.1fs)",
                     step, loss, metrics["lr"], time.time() - t0)
    log.info("done")


if __name__ == "__main__":
    main()
