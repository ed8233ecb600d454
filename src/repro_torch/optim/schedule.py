"""LR schedules: WSD (Warmup-Stable-Decay, MiniCPM) and cosine.

The port of ``repro.optim.schedule``, on host numbers: the step is a host
integer in the port's trainer, so the schedule is float32 arithmetic in
numpy (as the JAX version computes in f32) and returns a Python float.
"""
from __future__ import annotations

import numpy as np


def wsd_schedule(step, *, peak_lr: float, warmup: int, stable: int,
                 decay: int, final_frac: float = 0.1) -> float:
    """MiniCPM's Warmup-Stable-Decay: linear warmup, flat, then exponential
    anneal to ``final_frac * peak_lr`` over ``decay`` steps."""
    f32 = np.float32
    step = f32(step)
    warm = f32(peak_lr) * min(step / f32(max(warmup, 1)), f32(1.0))
    in_decay = np.clip((step - f32(warmup) - f32(stable))
                       / f32(max(decay, 1)), f32(0.0), f32(1.0))
    anneal = f32(peak_lr) * f32(final_frac) ** in_decay
    return float(warm if step < warmup + stable else anneal)


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> float:
    f32 = np.float32
    step = f32(step)
    warm = f32(peak_lr) * min(step / f32(max(warmup, 1)), f32(1.0))
    t = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)),
                f32(0.0), f32(1.0))
    cos = f32(final_frac) + (f32(1) - f32(final_frac)) * f32(0.5) \
        * (f32(1) + np.cos(f32(np.pi) * t))
    return float(warm if step < warmup else f32(peak_lr) * cos)
