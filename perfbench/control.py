"""The two readings a correctness limit is set between, on the card.

    python3 perfbench/control.py --config bert_large --seeds 1 2 3 ...

For each seed, in one process and at the configuration's served size (its
batch, the traffic's 512-input pool): the program's reading, its answers
for the whole pool served through ``ServeEngine`` and held to the plain
reference (fp32, TF32 off) as a run holds them; and the control's, the
reference put in the program's place and computed in TF32, the precision
below the configuration's, held to the same reference.  One JSON line a
seed, then the largest program reading and the smallest control reading.
The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import run  # the benchmark's environment

POOL = 512


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    run._environment()

    import torch

    from bench import cell as C
    from bench import reference
    from bench.spec import ROOT, load_spec

    entry = {c["name"]: c for c in load_spec()["configs"]}[args.config]
    with open(ROOT / entry["file"]) as f:
        config = json.load(f)
    traffic = {"queue_capacity": 256}
    program, control = [], []
    for seed in args.seeds:
        weights, pool = C.make_inputs(config, POOL, seed, "cuda")
        eng = C.build_engine(config, traffic, weights, "cuda", C.Overrides())
        ans = C.Answers(seed, POOL)
        with eng:
            for i, out in enumerate(eng.serve([pool[i] for i in range(POOL)])):
                ans.keep(i, out)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        p = C.reference_check(config, weights, pool, ans, "cuda")
        tf32 = C.Answers(seed, POOL)
        for i in range(0, POOL, C.REF_BLOCK):
            out = reference.forward(config, weights,
                                    pool[i:i + C.REF_BLOCK].cuda(), tf32=True)
            for j, o in enumerate(out.cpu().numpy()):
                tf32.keep(i + j, o)
        c = C.reference_check(config, weights, pool, tf32, "cuda")
        program.append(p)
        control.append(c)
        print(json.dumps({"seed": seed, "program_rel_err": p,
                          "control_rel_err": c,
                          "inputs": len(ans.sample)}), flush=True)
    print(json.dumps({"config": args.config, "seeds": len(args.seeds),
                      "program_max": max(program),
                      "control_min": min(control),
                      "card": torch.cuda.get_device_name()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
