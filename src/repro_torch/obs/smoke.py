"""End-to-end observability smoke: plan + execute a network with tracing on.

    PYTHONPATH=src python -m repro_torch.obs.smoke [--graph tiny|resnet50|mobv3]
        [--out trace.jsonl] [--check-identical] [--device cuda|cpu]

The port of ``repro.obs.smoke``: plans a network, executes it through
``repro_torch.api.execute_network`` on ``--device`` (cuda by default;
raises without CUDA) with tracing enabled — every ``exec.step`` span is one
``rir_matmul`` launch, timed on the device by two CUDA events — flushes
the JSONL trace, validates it against the trace schema, and prints the
model-vs-measured report.  Exits non-zero on any schema violation or on a
trace missing the spans the instrumentation promises (planner phases,
cache counters, one ``exec.step`` per layer).  ``--check-identical``
additionally re-executes with tracing off and asserts the numeric outputs
are bit-identical — tracing must observe, never perturb.  The trace uses
``repro.obs``'s names, so ``python -m repro.obs.report --validate`` reads
it as well.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from repro_torch.serve.engine import build_graph

__all__ = ["build_graph", "main"]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.smoke")
    ap.add_argument("--graph", default="tiny",
                    choices=["tiny", "resnet50", "mobv3"])
    ap.add_argument("--out", default="trace-smoke.jsonl")
    ap.add_argument("--check-identical", action="store_true",
                    help="re-execute with tracing off and assert "
                    "bit-identical outputs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import obs
    from repro_torch.api import (EvalConfig, Layout, PlanCache,
                                 PlannerOptions, execute_network,
                                 plan_network)
    from repro_torch.core.workloads import init_graph_weights
    from repro_torch.device import resolve_device
    from repro_torch.obs.report import build_report, format_report

    dev = resolve_device(args.device)     # fail before planning, not after
    graph = build_graph(args.graph)
    layouts = tuple(Layout.parse(s) for s in ("HWC_C32", "HWC_H32"))
    opts = PlannerOptions(switch_modes=("rir",), layouts=layouts,
                          parallel_dims=("C", "P", "Q"))
    cfg = EvalConfig()

    obs.reset()
    obs.enable(args.out)
    cache = PlanCache()
    plan = cache.get_or_plan(
        graph, cfg, lambda g, c: plan_network(g, c, opts=opts),
        extra_key=opts.key())
    # a second lookup exercises the hit counter
    assert cache.get_or_plan(
        graph, cfg, lambda g, c: plan_network(g, c, opts=opts),
        extra_key=opts.key()) is plan

    ws = init_graph_weights(list(graph.layers), seed=0)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=graph.input_shape())
                         .astype(np.float32))
    y_on = execute_network(plan, graph, x, ws, device=dev).cpu().numpy()
    path = obs.flush()
    obs.disable()

    if args.check_identical:
        y_off = execute_network(plan, graph, x, ws, device=dev).cpu().numpy()
        if not (y_on == y_off).all():
            print("[smoke] FAIL: outputs differ with tracing on vs off",
                  file=sys.stderr)
            return 1

    events = obs.read_trace(path)
    errors = obs.validate_trace(events)
    spans = {e["name"] for e in events if e.get("ev") == "span"}
    counters = {e["name"] for e in events if e.get("ev") == "counter"}
    n_steps = sum(1 for e in events
                  if e.get("ev") == "span" and e["name"] == "exec.step")
    for want in ("planner.plan", "planner.lattice_build", "planner.dp_extend",
                 "planner.argmin", "exec.network", "plan_cache.plan"):
        if want not in spans:
            errors.append(f"missing span {want!r}")
    for want in ("plan_cache.miss", "plan_cache.hit{tier=mem}",
                 "planner.lattice_builds"):
        if want not in counters:
            errors.append(f"missing counter {want!r}")
    if n_steps != len(plan.steps):
        errors.append(f"{n_steps} exec.step spans for "
                      f"{len(plan.steps)}-step plan")
    if errors:
        for err in errors:
            print(f"[smoke] FAIL: {err}", file=sys.stderr)
        return 1

    print(format_report(build_report(events)))
    print(f"[smoke] ok: {len(events)} events -> {path} "
          f"(graph={graph.name}, {n_steps} steps"
          + (", outputs bit-identical on/off" if args.check_identical
             else "") + ")")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
