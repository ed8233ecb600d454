"""Find a configuration's knee: the highest Poisson rate it sustains.

    python3 perfbench/knee.py --config bert_large --seed <n> --seconds 10 \
        [--fractions 0.5 0.6 ...]

On one card, in one process: serve a closed loop of 256 outstanding
requests for ``--seconds`` (the configuration's capacity C, requests/s),
then Poisson arrivals at each fraction of C for ``--seconds`` each.  A rate
is sustained when no request is rejected and, at the window's end, the
engine's queue holds no more than one batch beyond what it held one second
in.  Prints one JSON line a rate and the knee last.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import threading
import time

import run  # the benchmark's environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fractions", type=float, nargs="*",
                    default=[0.5, 0.6, 0.7, 0.8, 0.85, 0.9, 1.0, 1.1])
    args = ap.parse_args(argv)
    run._environment()

    import numpy as np
    import torch

    from bench import cell as C
    from bench import traffic as T
    from bench.spec import ROOT, load_spec

    spec = load_spec()
    cfg_entry = {c["name"]: c for c in spec["configs"]}[args.config]
    with open(ROOT / cfg_entry["file"]) as f:
        config = json.load(f)
    closed = {"kind": "closed", "outstanding": 256, "pool": 512,
              "queue_capacity": 256}
    weights, pool = C.make_inputs(config, 512, args.seed, "cuda")
    eng = C.build_engine(config, closed, weights, "cuda", C.Overrides())
    batch = config["max_batch"]
    out = []
    with eng:
        C.warm(eng, pool, batch, config["workers"])
        torch.cuda.synchronize()
        ans, sent = C.Answers(args.seed, 0), []
        t0 = time.perf_counter()
        C.closed_loop(eng, pool, 256, C.Window(t0 + args.seconds), ans,
                      sent)
        cap = sum(1 for t in ans.done if t <= t0 + args.seconds) / args.seconds
        print(json.dumps({"closed_loop_requests_per_s": cap}), flush=True)
        for frac in args.fractions:
            rate = frac * cap
            sched = T.arrivals({"kind": "poisson", "rate_per_s": rate},
                               args.seconds, args.seed)
            ans = C.Answers(args.seed, 0)
            lat = np.full(len(sched), np.inf)
            late = []
            t0 = time.perf_counter()
            join = C.open_loop(eng, pool, sched, t0, ans, lat, late)
            depth = {}

            def sample(key, at):
                time.sleep(max(0.0, at - time.perf_counter()))
                depth[key] = eng.queue_depth()
            s = threading.Thread(target=lambda: (
                sample("start", t0 + 1.0),
                sample("end", t0 + args.seconds)))
            s.start()
            s.join()
            join()
            done = sum(1 for t in ans.done if t <= t0 + args.seconds)
            rejected = int(np.isinf(lat).sum()) - ans.unserved
            srt = np.sort(lat)
            p95 = float(srt[max(0, math.ceil(0.95 * len(srt)) - 1)]) * 1e3
            rec = {"fraction": frac, "rate_per_s": rate, "sent": len(sched),
                   "completed_in_window": done, "rejected": rejected,
                   "queue_start": depth["start"], "queue_end": depth["end"],
                   "p50_ms": float(np.median(lat)) * 1e3, "p95_ms": p95,
                   "late_p99_ms": float(np.percentile(late, 99)) * 1e3,
                   "sustained": rejected == 0 and
                   depth["end"] <= depth["start"] + batch}
            out.append(rec)
            print(json.dumps(rec), flush=True)
    ok = [r["rate_per_s"] for r in out if r["sustained"]]
    print(json.dumps({"closed_loop_requests_per_s": cap,
                      "knee_per_s": max(ok) if ok else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
