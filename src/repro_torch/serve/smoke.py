"""Fast serve-engine smoke: 2 workers, ragged requests, bit-identity.

    PYTHONPATH=src python -m repro_torch.serve.smoke [--device cuda|cpu]

The port of ``repro.serve.smoke`` (a few seconds on the CPU): serves a
ragged request stream through a 2-worker continuous-batching engine on the
tiny 3-layer graph, every batch through the ``rir_matmul`` kernel on
``--device`` (cuda by default; raises without CUDA), then re-serves the
same requests through a sequential engine (``assemble_max=1`` — same plan,
same padded shapes, one request per batch) and asserts every output is
**bit-identical** — padding and batch composition must never leak into a
request's result.  Also checks the admission/batch counters and that the
shared ``PlanCache`` made the second engine a tier-0 (cached) resolution.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch import obs
    from repro_torch.api import PlanCache, ServeConfig, ServeEngine

    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve.smoke")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    obs.reset()
    # counters/histograms are strict no-ops unless tracing is on
    obs.enable(tempfile.mkstemp(suffix=".jsonl")[1])
    cache = PlanCache()
    cfg = ServeConfig(graph="tiny", max_batch=4, workers=2,
                      queue_capacity=16, device=args.device)
    n_requests = 11   # deliberately not a multiple of max_batch: ragged tail

    with ServeEngine(cfg, cache=cache) as eng:
        rng = np.random.default_rng(0)
        samples = [rng.standard_normal(eng.sample_shape).astype(np.float32)
                   for _ in range(n_requests)]
        eng.serve(samples[:1])   # warm the kernel build outside the burst
        outs = eng.serve(samples)
        assert eng.resolved is not None and not eng.resolved.degraded, \
            f"smoke plan unexpectedly degraded: {eng.resolved.reason!r}"

    served = obs.counter_value("serve.requests")
    batches = obs.counter_value("serve.batches")
    assert served >= n_requests + 1, f"admitted {served} < {n_requests + 1}"
    assert batches >= 2, f"expected multiple assembled batches, got {batches}"

    # sequential replay: same cache -> tier-0 plan, one request per batch
    seq_cfg = ServeConfig(graph="tiny", max_batch=4, workers=1,
                          assemble_max=1, queue_capacity=16,
                          device=args.device)
    with ServeEngine(seq_cfg, cache=cache) as seq:
        assert seq.resolved.tier == 0, \
            f"shared cache missed: tier={seq.resolved.tier_name}"
        ref = seq.serve(samples)

    for i, (a, b) in enumerate(zip(outs, ref)):
        assert a.shape == b.shape and np.array_equal(a, b), \
            f"request {i}: batched result differs from sequential"
    obs.disable()

    print(f"serve smoke OK: {n_requests} ragged requests, "
          f"{int(batches)} batches across 2 workers, "
          f"batched == sequential bit-identical")
    return 0


if __name__ == "__main__":
    sys.exit(main())
