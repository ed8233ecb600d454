"""Canonical registry of every obs metric and span family the repo emits.

This module is the single source of truth for observability names: the
counter/gauge/histogram families (with their exact label-key sets) and the
span families.  ``repro_torch.check`` lints every ``obs.inc_counter`` /
``obs.set_gauge`` / ``obs.observe`` / ``obs.span`` / ``obs.record_span``
call site against it — an unregistered name or a mistyped label key
(``tiers=`` for ``tier=``) is a lint error, not a silently forked series —
and the inventory block in the ``repro_torch.obs`` package docstring is
generated from it (``python -m repro_torch.check docs --write``).

Adding a metric: register it here first (name, label keys, one-line
description), then emit it.  Keep the registry import-light: this module
must stay stdlib-only so the checker can run without jax installed.
"""
from __future__ import annotations

from typing import Dict, Tuple

# name -> (label keys, description).  Label keys are the exact keyword-label
# set every emission must use (``n=`` on counters is the increment, not a
# label).  An empty tuple means the family is unlabeled.
COUNTERS: Dict[str, Tuple[Tuple[str, ...], str]] = {
    # robustness layer
    "faults.injected": (("site",), "fault injections fired, by site"),
    "retry.attempts": (("site",), "retries performed, by retry site"),
    "retry.exhausted": (("site",), "retry budgets exhausted, by site"),
    "heartbeat.dropped": (("type",), "liveness packets absorbed as lost"),
    "degrade.tier": (("level",), "plan resolutions, by ladder tier"),
    "plan.artifact_error": (("type",), "unreadable/invalid plan artifacts"),
    "plan.upgrade_failed": (("type",), "background re-plans that errored"),
    # planner / plan cache
    "planner.lattice_builds": ((), "per-layer candidate lattices built"),
    "plan_cache.hit": (("tier",), "cache hits (tier=mem|disk)"),
    "plan_cache.miss": ((), "cache misses (both tiers)"),
    "plan_cache.put": ((), "plans written through the cache"),
    "plan_cache.evict": (("reason",), "cache entries evicted"),
    "plan_cache.quarantined": (("reason",), "artifacts quarantined"),
    "plan_cache.io_error": (("op",), "cache disk failures (op=get|put)"),
    # checkpointing
    "ckpt.write_failed": (("type",), "checkpoint saves dropped after retry"),
    "ckpt.restore_failed": (("type",), "unrestorable checkpoints skipped"),
    "ckpt.restore_fallback": ((), "restores that fell back past newest"),
    # serving
    "serve.requests": ((), "requests admitted to the queue"),
    "serve.rejected": (("reason",), "admissions rejected "
                                    "(reason=capacity|stopped|fault)"),
    "serve.batches": ((), "continuous batches executed"),
    "serve.batch_failed": (("type",), "batches whose execution raised"),
    "serve.plan_upgrade": ((), "live plan-tier upgrades swapped in"),
    # training
    "train.restarts": (("cause",), "supervisor restarts, by cause"),
    "train.faults": (("type",), "step faults absorbed by the supervisor"),
}

GAUGES: Dict[str, Tuple[Tuple[str, ...], str]] = {
    "serve.queue_depth": ((), "admission queue depth after submit/drain"),
    "planner.layers": ((), "layers in the graph being planned"),
    "planner.dataflow_candidates": ((), "dataflow candidates per layer"),
    "planner.tiling_candidates": ((), "tiling candidates per layer"),
    "planner.lattice_points": ((), "total lattice points in the DP"),
}

HISTOGRAMS: Dict[str, Tuple[Tuple[str, ...], str]] = {
    "train.backoff_s": ((), "supervisor restart backoff delays"),
    "train.step_ms": ((), "traced training-step wall clock"),
    "serve.batch_size": ((), "assembled continuous-batch sizes"),
    "serve.time_in_queue_ms": ((), "request wait before batch assembly"),
    "serve.ttft_ms": ((), "submit-to-first-output latency"),
    "serve.e2e_ms": ((), "submit-to-completion latency"),
    "serve.prefill_ms": ((), "LM prefill wall clock per batch"),
    "serve.decode_ms_per_token": ((), "LM decode wall clock per token"),
}

# Span attrs are open-ended (plan ids, step indices, shapes ride along), so
# spans are checked for name membership only.
SPANS: Dict[str, str] = {
    "planner.plan": "whole network co-search (root span)",
    "planner.lattice": "per-layer lattice phase (legacy planner path)",
    "planner.lattice_build": "candidate lattice construction",
    "planner.dp_extend": "DP forward extension over boundaries",
    "planner.argmin": "backtrack/argmin over the DP table",
    "plan_cache.plan": "cache-wrapped plan resolution",
    "exec.network": "whole planned-network execution",
    "exec.chain": "one fused-chain dispatch",
    "exec.step": "one plan-step kernel dispatch",
    "serve.plan": "engine plan resolution at startup",
    "serve.batch": "one continuous batch (plan id/tier in attrs)",
    "train.step": "one traced training step",
}

# kind tag (as reported in lint messages) -> registry
METRICS: Dict[str, Dict[str, Tuple[Tuple[str, ...], str]]] = {
    "counter": COUNTERS,
    "gauge": GAUGES,
    "histogram": HISTOGRAMS,
}

ALL_NAMES = frozenset(COUNTERS) | frozenset(GAUGES) | \
    frozenset(HISTOGRAMS) | frozenset(SPANS)


def labels_for(kind: str, name: str) -> Tuple[str, ...]:
    """Registered label-key tuple for a metric (KeyError if unregistered)."""
    return METRICS[kind][name][0]


def render_inventory() -> str:
    """The generated inventory block for the ``repro_torch.obs``
    docstring."""
    out = []
    for title, reg in (("Counters", COUNTERS), ("Gauges", GAUGES),
                       ("Histograms", HISTOGRAMS)):
        out.append(f"{title}:")
        for name, (labels, desc) in reg.items():
            lbl = "{%s}" % ",".join(f"{k}=" for k in labels) if labels else ""
            out.append(f"  ``{name}{lbl}``")
            out.append(f"      {desc}")
    out.append("Spans:")
    for name, desc in SPANS.items():
        out.append(f"  ``{name}``")
        out.append(f"      {desc}")
    return "\n".join(out)
