"""Serving benchmark on the PyTorch port: continuous batching vs sequential
on a planned net.

    PYTHONPATH=src python -m benchmarks.serve_bench_torch [--graph resnet50]
        [--device cuda|cpu]

The counterpart of ``benchmarks/serve_bench.py``'s gate, on the same plan:
serves the same request set through two ``repro_torch.api.ServeEngine``
deployments sharing one warm ``PlanCache`` (identical plan, identical
padded batch shapes):

* **sequential**: ``assemble_max=1``, one request per executed batch, the
  no-batching baseline;
* **batched**: dynamic batch assembly up to the plan tile's batch extent.

At saturating offered load (all requests submitted up front) the batched
engine must deliver **>= 1.5x** the sequential throughput, and its outputs
must equal the sequential engine's bit for bit; the run exits non-zero
otherwise, and also on a wall-time blowout.  A trickle load (inter-arrival
gap > service time) shows the adaptive side: batches shrink toward 1.
Latency percentiles come from the engine's own ``serve.e2e_ms``
histogram.  ``--device`` defaults to ``cuda`` (each batch through the
``rir_matmul`` kernel) and raises where there is no CUDA; ``--device cpu``
runs the plain PyTorch path.  ``main`` returns the run's entry.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
import time

import numpy as np

MAX_WALL_S = 600.0                  # whole-benchmark blowout guard
MIN_SPEEDUP = 1.5                   # batched vs sequential at saturating load


def _new_hist_samples(name: str, n0: int):
    from repro_torch import obs
    return obs.hist_samples(name)[n0:]


def _pct(samples, q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))]


def run_load(eng, samples, gap_s: float) -> dict:
    """Serve ``samples`` at one offered load; gap 0 = saturating burst."""
    from repro_torch import obs

    n0 = len(obs.hist_samples("serve.e2e_ms"))
    b0 = len(obs.hist_samples("serve.batch_size"))
    tickets = []
    t0 = time.perf_counter()
    for s in samples:
        tickets.append(eng.submit(s))
        if gap_s:
            time.sleep(gap_s)
    for t in tickets:
        t.result(timeout=MAX_WALL_S)
    wall = time.perf_counter() - t0
    e2e = _new_hist_samples("serve.e2e_ms", n0)
    sizes = _new_hist_samples("serve.batch_size", b0)
    return {"requests": len(samples), "gap_s": gap_s, "wall_s": wall,
            "throughput_rps": len(samples) / wall,
            "p50_ms": _pct(e2e, 0.50), "p99_ms": _pct(e2e, 0.99),
            "mean_batch": float(np.mean(sizes)) if sizes else 0.0,
            "batches": len(sizes)}


def run(graph: str, requests: int, max_batch: int, device: str) -> dict:
    from repro_torch import obs
    from repro_torch.api import PlanCache, ServeConfig, ServeEngine

    obs.reset()
    trace = tempfile.mkstemp(suffix=".jsonl")[1]
    obs.enable(trace)
    cache = PlanCache()
    batched_cfg = ServeConfig(graph=graph, max_batch=max_batch,
                              queue_capacity=128, device=device)
    seq_cfg = ServeConfig(graph=graph, max_batch=max_batch, assemble_max=1,
                          queue_capacity=128, device=device)

    t_plan0 = time.perf_counter()
    rng = np.random.default_rng(0)
    with ServeEngine(batched_cfg, cache=cache) as eng:
        t_plan = time.perf_counter() - t_plan0
        samples = [rng.standard_normal(eng.sample_shape).astype(np.float32)
                   for _ in range(requests)]
        eng.serve(samples[:max_batch])                     # warm the engine
        batched = run_load(eng, samples, gap_s=0.0)
        # trickle load: arrivals slower than service -> batches shrink to ~1
        trickle_gap = batched["wall_s"] / requests * 1.5
        trickle = run_load(eng, samples[: max(2, requests // 2)],
                           gap_s=trickle_gap)
        outs_b = eng.serve(samples)          # kept for the identity check

    with ServeEngine(seq_cfg, cache=cache) as eng:
        assert eng.resolved.tier == 0, "sequential engine missed the cache"
        eng.serve(samples[:1])                             # warm
        sequential = run_load(eng, samples, gap_s=0.0)
        outs_s = eng.serve(samples)

    obs.disable()
    pathlib.Path(trace).unlink(missing_ok=True)
    identical = all(np.array_equal(a, b) for a, b in zip(outs_b, outs_s))
    speedup = batched["throughput_rps"] / sequential["throughput_rps"]
    return {
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "graph": graph, "max_batch": max_batch, "device": device,
        "plan_s": t_plan,
        "batched": batched, "sequential": sequential, "trickle": trickle,
        "speedup": speedup, "outputs_identical": identical,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m benchmarks.serve_bench_torch")
    ap.add_argument("--graph", default="resnet50",
                    choices=["tiny", "resnet50", "mobv3"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    entry = run(args.graph, args.requests, args.max_batch, args.device)
    total = time.perf_counter() - t0
    entry["total_s"] = total

    b, s = entry["batched"], entry["sequential"]
    print(f"serve_bench.batched,{b['wall_s'] * 1e6:.2f},"
          f"us;rps={b['throughput_rps']:.3f};p50_ms={b['p50_ms']:.0f};"
          f"p99_ms={b['p99_ms']:.0f};mean_batch={b['mean_batch']:.2f}")
    print(f"serve_bench.sequential,{s['wall_s'] * 1e6:.2f},"
          f"us;rps={s['throughput_rps']:.3f};p50_ms={s['p50_ms']:.0f};"
          f"p99_ms={s['p99_ms']:.0f}")
    print(f"serve_bench.speedup,{entry['speedup']:.2f},"
          f"x;identical={entry['outputs_identical']}")

    ok = True
    if not entry["outputs_identical"]:
        print("serve_bench FAIL: batched outputs differ from sequential",
              file=sys.stderr)
        ok = False
    if entry["speedup"] < MIN_SPEEDUP:
        print(f"serve_bench FAIL: speedup {entry['speedup']:.2f}x < "
              f"{MIN_SPEEDUP}x at saturating load", file=sys.stderr)
        ok = False
    if total > MAX_WALL_S:
        print(f"serve_bench FAIL: wall {total:.0f}s > {MAX_WALL_S:.0f}s",
              file=sys.stderr)
        ok = False
    if not ok:
        sys.exit(1)
    print(f"serve_bench ok: {entry['speedup']:.2f}x batched throughput, "
          f"{total:.0f}s total")
    return entry


if __name__ == "__main__":
    main()
