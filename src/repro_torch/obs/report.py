"""Model-vs-measured report over a ``repro_torch.obs`` trace.

The port's copy of ``repro.obs.report``, changed only in its names: the
port's spans and counters carry ``repro.obs``'s names, so this report and
``python -m repro.obs.report`` read a trace from either package.

    PYTHONPATH=src python -m repro_torch.obs.report out.jsonl \
        [--freq-ghz 1.0] [--top 5] [--chrome out.json] [--validate]

The centerpiece is the per-plan-step calibration table: every ``exec.step``
span carries the step's MODELED cycles/energy (copied from the plan
artifact) next to its MEASURED wall-clock (the span duration, fenced by
``torch.cuda.synchronize()``), so the report can print, per step, the
analytical prediction, the measurement, and the gap ratio between them —
and rank the worst offenders, which is exactly where the cost model needs
work (and exactly the labeled data a learned surrogate trains on).

Gap ratios are *relative* honesty checks, not absolute ones: the executor
runs on whatever device it was given (the plain path on the CPU in CI,
the CUDA kernels on the card), so the
interesting signal is the per-step SPREAD of measured/modeled, not its
absolute scale.  The report therefore also prints each step's gap
normalized by the run's median gap (``rel``), which cancels the unknown
backend constant.

Also summarized: planner phase timings (``planner.*`` spans), plan-cache
hit/miss/eviction counters, serve latency histograms, and train fault
counters.  ``--chrome`` re-exports the same events for ``chrome://tracing``
/ Perfetto.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from .trace import export_chrome_trace, read_trace, validate_trace


def _median(xs: List[float]) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[len(s) // 2]


def step_rows(events: List[Dict[str, Any]], freq_ghz: float
              ) -> List[Dict[str, Any]]:
    """Aggregate ``exec.step`` spans into one row per (plan_id, step).

    Repeated executions of the same plan average their measured wall-clock
    (``runs`` counts them).  ``modeled_us`` converts the plan's cycles at
    ``freq_ghz``; ``gap`` is measured/modeled.
    """
    groups: Dict[tuple, Dict[str, Any]] = {}
    for e in events:
        if e.get("ev") != "span" or e.get("name") != "exec.step":
            continue
        a = e.get("attrs", {})
        if "modeled_cycles" not in a:
            continue
        key = (a.get("plan_id", "?"), a.get("step", -1))
        g = groups.setdefault(key, {
            "plan_id": a.get("plan_id", "?"),
            "graph": a.get("graph", "?"),
            "step": a.get("step", -1), "layer": a.get("layer", "?"),
            "lowering": a.get("lowering", "?"),
            "reorder": a.get("reorder", "?"),
            "double_buffer": a.get("double_buffer", False),
            "buffer_alloc": a.get("buffer_alloc", ""),
            "fused_group": a.get("fused_group"),
            "modeled_cycles": float(a["modeled_cycles"]),
            "modeled_energy_pj": float(a.get("modeled_energy_pj", 0.0)),
            "modeled_stall_cycles": float(a.get("modeled_stall_cycles",
                                                0.0)),
            "durs_us": []})
        g["durs_us"].append(float(e["dur"]))
    rows = []
    for g in groups.values():
        durs = g.pop("durs_us")
        g["runs"] = len(durs)
        g["measured_us"] = sum(durs) / len(durs)
        g["modeled_us"] = g["modeled_cycles"] / (freq_ghz * 1e3)
        g["gap"] = (g["measured_us"] / g["modeled_us"]
                    if g["modeled_us"] > 0 else float("inf"))
        # the modeled total splits into exposed DRAM stall vs everything
        # else (compute + reorder): the share tells whether closing a gap
        # means fixing the stall model or the compute model
        g["stall_frac"] = (g["modeled_stall_cycles"] / g["modeled_cycles"]
                           if g["modeled_cycles"] > 0 else 0.0)
        rows.append(g)
    rows.sort(key=lambda r: (r["plan_id"], r["step"]))
    med = _median([r["gap"] for r in rows])
    for r in rows:
        r["rel_gap"] = r["gap"] / med if med > 0 else float("inf")
    return rows


def _span_stats(events: List[Dict[str, Any]], prefix: str
                ) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for e in events:
        if e.get("ev") != "span" or not e.get("name", "").startswith(prefix):
            continue
        s = out.setdefault(e["name"], {"count": 0, "total_us": 0.0,
                                       "max_us": 0.0})
        s["count"] += 1
        s["total_us"] += e["dur"]
        s["max_us"] = max(s["max_us"], e["dur"])
    return out


def _metric_lines(events: List[Dict[str, Any]], kind: str, prefix: str
                  ) -> List[Dict[str, Any]]:
    return [e for e in events
            if e.get("ev") == kind and e.get("name", "").startswith(prefix)]


def build_report(events: List[Dict[str, Any]], freq_ghz: float = 1.0,
                 top: int = 5) -> Dict[str, Any]:
    """Everything the text report prints, as data (tests read this)."""
    rows = step_rows(events, freq_ghz)
    worst = sorted(rows, key=lambda r: r["gap"], reverse=True)[:top]
    return {
        "freq_ghz": freq_ghz,
        "steps": rows,
        "worst": worst,
        "totals": {
            "modeled_us": sum(r["modeled_us"] for r in rows),
            "measured_us": sum(r["measured_us"] * r["runs"] for r in rows),
            "executions": sum(r["runs"] for r in rows),
            "median_gap": _median([r["gap"] for r in rows]),
            "modeled_stall_cycles": sum(r["modeled_stall_cycles"]
                                        for r in rows),
            "modeled_cycles": sum(r["modeled_cycles"] for r in rows),
        },
        "planner": _span_stats(events, "planner."),
        "exec_spans": _span_stats(events, "exec."),
        "cache_counters": _metric_lines(events, "counter", "plan_cache."),
        "train_counters": _metric_lines(events, "counter", "train."),
        "serve_hists": _metric_lines(events, "hist", "serve."),
        "gauges": _metric_lines(events, "gauge", "planner."),
    }


def format_report(rep: Dict[str, Any]) -> str:
    lines: List[str] = []
    rows = rep["steps"]
    if rows:
        lines.append(f"per-plan-step modeled vs measured "
                     f"(modeled @ {rep['freq_ghz']:g} GHz; gap = "
                     f"measured/modeled, rel = gap/median-gap):")
        hdr = (f"  {'step':>4} {'layer':24} {'lowering':9} {'db':2} "
               f"{'alloc':12} {'modeled_cyc':>12} {'stall%':>6} "
               f"{'modeled_us':>11} {'measured_us':>12} "
               f"{'runs':>4} {'gap':>9} {'rel':>6}")
        lines.append(hdr)
        cur_plan = None
        for r in rows:
            if r["plan_id"] != cur_plan:
                cur_plan = r["plan_id"]
                lines.append(f"  plan {cur_plan} ({r['graph']}):")
            label = r["layer"]
            if r.get("fused_group"):
                label = f"{label}[{r['fused_group']}]"
            lines.append(
                f"  {r['step']:>4} {label:24.24} {r['lowering']:9} "
                f"{'y' if r['double_buffer'] else 'n':2} "
                f"{r['buffer_alloc'] or '-':12.12} "
                f"{r['modeled_cycles']:>12.0f} "
                f"{100 * r['stall_frac']:>5.1f}% "
                f"{r['modeled_us']:>11.2f} "
                f"{r['measured_us']:>12.1f} {r['runs']:>4} "
                f"{r['gap']:>9.2f} {r['rel_gap']:>6.2f}")
        t = rep["totals"]
        stall_pct = (100 * t["modeled_stall_cycles"] / t["modeled_cycles"]
                     if t["modeled_cycles"] > 0 else 0.0)
        lines.append(
            f"  totals: modeled {t['modeled_us']:.1f} us, measured "
            f"{t['measured_us']:.1f} us over {t['executions']} step "
            f"executions; median gap {t['median_gap']:.2f}x; "
            f"{stall_pct:.1f}% of modeled cycles are exposed DRAM stalls")
        if rep["worst"]:
            lines.append("  worst offenders (largest measured/modeled gap):")
            for r in rep["worst"]:
                lines.append(
                    f"    {r['layer']:24.24} gap {r['gap']:.2f}x "
                    f"(rel {r['rel_gap']:.2f}x, {r['lowering']}, "
                    f"measured {r['measured_us']:.1f} us)")
    else:
        lines.append("no exec.step spans in trace (nothing was executed "
                     "with tracing on)")
    if rep["planner"]:
        lines.append("planner phases:")
        for name, s in sorted(rep["planner"].items()):
            lines.append(f"  {name:28} count={s['count']:<5.0f} "
                         f"total={s['total_us']/1e3:10.2f} ms  "
                         f"max={s['max_us']/1e3:8.2f} ms")
    for e in rep["gauges"]:
        lines.append(f"  gauge {e['name']} = {e['value']:g}")
    if rep["cache_counters"]:
        lines.append("plan cache:")
        for e in rep["cache_counters"]:
            lines.append(f"  {e['name']:40} {e['value']:g}")
    if rep["train_counters"]:
        lines.append("train supervisor:")
        for e in rep["train_counters"]:
            lines.append(f"  {e['name']:40} {e['value']:g}")
    if rep["serve_hists"]:
        lines.append("serve latency:")
        for e in rep["serve_hists"]:
            lines.append(
                f"  {e['name']:28} n={e['count']:<6.0f} "
                f"p50={e['p50']:.2f} p99={e['p99']:.2f} "
                f"min={e['min']:.2f} max={e['max']:.2f}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="model-vs-measured report over a repro_torch.obs JSONL "
        "trace")
    ap.add_argument("trace", help="trace JSONL (REPRO_TRACE output)")
    ap.add_argument("--freq-ghz", type=float, default=1.0,
                    help="clock used to convert modeled cycles to time")
    ap.add_argument("--top", type=int, default=5,
                    help="worst offenders to list")
    ap.add_argument("--chrome", metavar="PATH",
                    help="also export Chrome trace_event JSON to PATH")
    ap.add_argument("--validate", action="store_true",
                    help="fail (exit 1) if the trace violates the schema")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    args = ap.parse_args(argv)

    events = read_trace(args.trace)
    errors = validate_trace(events)
    if errors:
        for err in errors:
            print(f"[report] schema: {err}", file=sys.stderr)
        if args.validate:
            return 1
    rep = build_report(events, freq_ghz=args.freq_ghz, top=args.top)
    if args.json:
        rep_out = dict(rep)
        print(json.dumps(rep_out, indent=2, default=str))
    else:
        print(format_report(rep))
    if args.chrome:
        p = export_chrome_trace(args.chrome, events)
        print(f"[report] chrome trace -> {p} "
              f"(open in chrome://tracing or https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
