"""Serving CLI: a thin front-end over ``repro_torch.api.ServeEngine``.

The port of ``repro.launch.serve``, with the same flags and log lines plus
``--device`` (cuda by default; raises without CUDA):

    PYTHONPATH=src python -m repro_torch.launch.serve --graph resnet50 \\
        --batch 8 --workers 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3p2_3b \\
        --batch 8 --prompt-len 128 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --graph tiny \\
        --batch 4 --workers 2 --device cpu

All knobs live on ``repro_torch.api.ServeConfig`` (this module only parses
argv and prints a summary); the engine owns plan resolution, the bounded
admission queue, dynamic batch assembly and background tier upgrades.
Network mode draws its samples from ``np.random.default_rng(seed)`` and
logs a checksum, as the JAX CLI does.  LM mode draws its prompts from a
seeded ``torch.Generator`` where the JAX CLI uses ``jax.random``, so the
two CLIs serve different prompts from one seed.  Observability: console
output goes through the ``repro_torch.obs`` logger (``--log-level`` /
``REPRO_LOG``); ``REPRO_TRACE=out.jsonl`` records the ``serve.*`` spans and
histograms for ``python -m repro_torch.obs.report``.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from repro_torch import obs

log = obs.get_logger("serve")


def _decode_block_hints(plan):
    """Distinct kernel (block_m, block_k) shapes the plan's steps ask for —
    advisory, logged so an operator can see what a plan-driven decode
    would use."""
    from repro_torch.api import step_kernel_blocks

    return sorted({step_kernel_blocks(s) for s in plan.steps})


def main(argv: Optional[List[str]] = None) -> dict:
    """Serve one batch of ``--batch`` requests; returns ``{"config",
    "outputs"}`` (the outputs as numpy, one a request)."""
    import torch

    from repro_torch.api import ServeConfig, ServeEngine, get_config

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ServeConfig.add_args(ap)
    args = ap.parse_args(argv)

    obs.configure_from_env()          # REPRO_TRACE=path enables tracing
    config = ServeConfig.from_args(args)

    with ServeEngine(config) as eng:
        resolved = eng.resolved
        if resolved is not None:
            hints = _decode_block_hints(resolved.plan)
            log.info("plan %s tier=%s; decode kernel block hints %s",
                     resolved.plan.plan_id, resolved.tier_name, hints)
        if config.arch is not None:
            cfg = get_config(config.arch, smoke=config.smoke)
            gen = torch.Generator().manual_seed(config.seed)
            prompts = torch.randint(0, cfg.vocab,
                                    (config.max_batch, config.prompt_len),
                                    generator=gen, dtype=torch.int32)
            outs = eng.serve([prompts[i].numpy()
                              for i in range(config.max_batch)])
            log.info("arch=%s batch=%d prompt=%d gen=%d",
                     cfg.name, config.max_batch, config.prompt_len,
                     config.gen)
            log.info("sample tokens: %s", outs[0][:12].tolist())
        else:
            rng = np.random.default_rng(config.seed)
            samples = [rng.standard_normal(eng.sample_shape)
                       .astype(np.float32) for _ in range(config.max_batch)]
            outs = eng.serve(samples)
            log.info("graph=%s batch=%d out=%s checksum=%.6f",
                     config.graph, config.max_batch, outs[0].shape,
                     float(np.sum(np.stack(outs))))
    return {"config": config, "outputs": outs}


if __name__ == "__main__":
    main()
