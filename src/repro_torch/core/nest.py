"""NEST — Neural Engine with Spatial forwarding and Temporal reduction.

Timing/utilization model of the paper's §III-A / Fig. 9 plus a functional
walk-through used by tests:

* Phase 1: each PE locally accumulates AH partial sums in its register file.
* Phase 2: PE rows take turns (time-multiplexed) pushing AW locally-reduced
  values into the single AW-input BIRRD, which spatially reduces and reorders.
* Weight loading takes AH^2 cycles, hidden behind compute by ping-pong local
  registers in steady state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from .dataflow import ConvWorkload, Dataflow


@dataclasses.dataclass(frozen=True)
class NestConfig:
    aw: int = 16   # columns = BIRRD inputs
    ah: int = 16   # rows


@dataclasses.dataclass(frozen=True)
class NestTiming:
    total_cycles: float
    steady_utilization: float
    weight_load_cycles: int
    pipeline_fill_cycles: int


def nest_cycle_terms(cfg: NestConfig, wl: ConvWorkload, df: Dataflow
                     ) -> Tuple[float, int, int, float]:
    """(steady, fill, load, utilization) — the slowdown-independent pieces of
    the cycle model, shared by ``nest_cycles`` and the batched lattice path
    (``layoutloop.evaluate_lattice``) so the formula lives in one place."""
    pes = cfg.aw * cfg.ah
    util = df.theoretical_utilization(wl, pes)
    macs = wl.macs()
    steady = macs / max(pes * util, 1e-9)
    fill = cfg.ah  # rows drain one by one into BIRRD
    load = cfg.ah ** 2
    return steady, fill, load, util


def nest_cycles(cfg: NestConfig, wl: ConvWorkload, df: Dataflow,
                slowdown: float = 1.0) -> NestTiming:
    """Cycle model: total MACs over effective MAC/s, stretched by bank-conflict
    slowdown; weight loads are hidden except the first (paper Fig. 9)."""
    steady, fill, load, util = nest_cycle_terms(cfg, wl, df)
    total = (steady + fill) * slowdown + load
    return NestTiming(total_cycles=total, steady_utilization=util,
                      weight_load_cycles=load, pipeline_fill_cycles=fill)


def systolic_cycles(cfg: NestConfig, wl: ConvWorkload,
                    cm: int | None = None, ck: int | None = None) -> NestTiming:
    """Weight-stationary systolic array baseline (Gemmini-like, fixed dataflow):
    parallelism fixed at (M=ah, C=aw); utilization drops on non-divisible dims."""
    cm = cm or cfg.ah
    ck = ck or cfg.aw
    m_eff = wl.M / (math.ceil(wl.M / cm) * cm)
    c_eff = wl.C / (math.ceil(wl.C / ck) * ck)
    util = m_eff * c_eff
    pes = cfg.aw * cfg.ah
    macs = wl.macs()
    steady = macs / max(pes * util, 1e-9)
    skew = cfg.aw + cfg.ah  # systolic wavefront fill/drain
    return NestTiming(total_cycles=steady + skew, steady_utilization=util,
                      weight_load_cycles=cfg.ah ** 2, pipeline_fill_cycles=skew)


def nest_walkthrough(cfg: NestConfig, weights: np.ndarray, iacts: np.ndarray,
                     group_size: int) -> Tuple[np.ndarray, int]:
    """Functional mini-NEST for tests (paper Fig. 9 example).

    weights: (ah, aw) one stationary value per PE
    iacts:   (steps, aw) streamed top-to-bottom; every PE multiplies its
             stationary weight with the value streaming through its column and
             accumulates ``steps`` products locally (temporal reduction), then
             each row's aw partials are spatially reduced in groups of
             ``group_size`` (BIRRD 4:2-style reduction).

    Returns (row-major outputs (ah, aw // group_size), cycles modeled).
    """
    ah, aw = weights.shape
    steps = iacts.shape[0]
    local = np.zeros((ah, aw))
    for t in range(steps):
        local += weights * iacts[t][None, :]
    out = local.reshape(ah, aw // group_size, group_size).sum(-1)
    cycles = steps + ah  # temporal phase + row-multiplexed spatial phase
    return out, cycles
