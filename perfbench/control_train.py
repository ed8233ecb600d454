"""The readings a training cell's correctness limits are set between.

    python3 perfbench/control_train.py --workload rwkv6_1p6b.train_4k \
        --seeds 1 2 3 ... [--controls 3] [--faults half_batch ...]

On the card, in one process, at the cell's own size, for each seed: the
program's checked steps, driven and read as a run drives and reads them,
and the plain reference through the same steps; the gaps between them are
the program's reading (``train.gaps``).  For the first ``--controls``
seeds also: the control, the reference put in the program's place in fp8
e4m3, the precision below the configuration's bf16 (every product's
operands, and each tensor the program holds in bf16 between its kernels:
the scan's inputs, the residual stream); the reference with half of each batch left out,
the mean taken over the rest (``half_batch_ref``); and each fault of
``--faults`` planted in the program (``bench/faults.py``).  One JSON line
a reading, then for each number the largest sound reading and the
smallest reading of each control and fault.  The benchmark's own runs do
not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import run  # the benchmark's environment

FAULTS = ("state_unchanged", "half_batch", "scan_zeroed", "grad_scaled",
          "bias_correction")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", nargs="*", default=list(FAULTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run._environment()

    import torch

    from bench import faults, train
    from bench.spec import find_cell

    cell = find_cell(args.workload)
    print(json.dumps(readings(cell, args.seeds, args.controls, args.faults,
                              args.device, torch, faults, train)), flush=True)
    return 0


def readings(cell, seeds, controls, fault_names, device, torch, faults,
             train) -> dict:
    config, tr = cell.config, cell.traffic
    mod = train.model_module(config)
    K = tr["checked_steps"]

    def program(seed, hook=None):
        prog = train.build_program(config, tr, mod, seed, device)
        pool = train.draw_pool(config, tr, seed, device)
        if hook is not None:
            hook(prog)
        got = train.program_readings(prog, config, mod, pool, K, K, seed,
                                     device, [], [])
        del prog
        gc.collect()
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        return got

    by_kind = {}
    for k, seed in enumerate(seeds):
        sides = {"program": program(seed)}
        if k < controls:
            for name in fault_names:
                with faults.planted(name) as hook:
                    sides[name] = program(seed, hook)
        batches = train.draw_pool(config, tr, seed, device)[:K]
        ref = train.reference_readings(config, tr, mod, seed, device, batches)
        if k < controls:
            sides["control_fp8"] = train.reference_readings(
                config, tr, mod, seed, device, batches, precision="fp8")
            sides["half_batch_ref"] = train.reference_readings(
                config, tr, mod, seed, device, batches,
                rows=tr["sequences"] // 2)
        for kind, got in sides.items():
            g = train.gaps(got, ref)
            by_kind.setdefault(kind, []).append(g)
            print(json.dumps({"seed": seed, "kind": kind, **g,
                              "losses": got.losses,
                              "reference_losses": ref.losses}), flush=True)
    out = {"workload": cell.name, "seeds": len(seeds),
           "card": torch.cuda.get_device_name() if device.startswith("cuda")
           else "cpu"}
    for kind, rows in by_kind.items():
        pick = max if kind == "program" else min
        out[kind] = {n: pick(r[n] for r in rows) for n in rows[0]}
    return out


if __name__ == "__main__":
    sys.exit(main())
