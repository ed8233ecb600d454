#!/usr/bin/env python3
"""Time ``rir_matmul`` at the twelve ResNet-50 batch-8 steps on the card,
for one source tree or several in turns.

    python3 tools/kernel_bench.py [--src DIR ...] [--sweep] [--out FILE]

Each ``--src`` is a directory holding the ``repro_torch`` package (default:
this checkout's ``src``).  Each runs in a process of its own, in the order
given, so ``--src A --src B --src B --src A`` compares two versions of the
kernel in turns on one card.  A run builds that tree's kernel and times
every step as ``chip_smoke.py``'s phase 3 does: the kernel's device time
from its ``torch.profiler`` events, the plain version and ``torch.matmul``
queued behind a spin kernel, the CUDA events around back-to-back calls
beside.  ``--sweep`` also times each step at every tile width and K-split
count the kernel takes (a cut forced through ``rir_matmul._launch``), the
measurement ``launch_plan``'s rule is chosen from.  One JSON line a run on
stdout (and a list of them in ``--out``).  Needs one NVIDIA card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def child(src: str, sweep: bool) -> dict:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs                  # puts this checkout's src first
    sys.path.insert(0, src)                  # ... and the tree asked for
    from repro_torch import api              # before it
    if not pathlib.Path(api.__file__).is_relative_to(src):
        raise SystemExit(f"kernel_bench: imported {api.__file__}, not {src}")
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rir_matmul as rk
    from repro_torch.serve.engine import _planner_options
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if not hasattr(rk, "launch_plan"):       # an older tree: one kernel,
        rk.launch_plan = lambda *_: argparse.Namespace(   # one cut for all
            kernels=("rir_matmul_kernel",))
    rk.load()
    graph = api.resnet50_graph().with_batch(cs.BATCH)
    opts = _planner_options(api.ServeConfig(graph="resnet50",
                                            max_batch=cs.BATCH, device="cuda"))
    plan = api.resolve_plan(graph, api.EvalConfig(), opts=opts,
                            cache=api.PlanCache()).plan
    rec = {"src": src, "card": cs.card_line(), "build_log": [
        line.strip() for line in rk.build_log.splitlines()
        if "registers" in line or "spill" in line or "stack" in line],
        "steps": cs.phase_kernel_resnet(torch, api, ops, ref, rk,
                                        {"resnet50": (graph, plan)})}
    if sweep:
        rec["sweep"] = sweep_plans(torch, api, cs, ops, rk, graph, plan)
    return rec


def sweep_plans(torch, api, cs, ops, rk, graph, plan) -> list:
    """Every (tile_n, splits) the kernel takes, at every step: device ms."""
    weights = api.init_graph_weights(list(graph.layers), seed=0)
    prepared = api.prepare_network(plan, graph, weights, device="cuda")
    gen = torch.Generator().manual_seed(7)
    rows = []
    for i, st in enumerate(prepared.steps):
        a = torch.randn(st.rows_out, st.k_width, generator=gen).to("cuda")
        b, bn = st.w_eff, st.block_n
        M, K = a.shape
        N = b.shape[1]
        perm = st.perm_dev if st.perm_dev is not None else \
            ops.device_perm(range(N // bn), "cuda")
        slices = -(-K // rk.TILE_K)
        times = {}
        for tile_n in (64, 128):
            if N % tile_n:
                continue
            for splits in (1, 2, 4, 8):
                per = -(-slices // splits)
                if (splits - 1) * per >= slices:
                    continue
                cut = rk.LaunchPlan(tile_n, splits, rk._k_bounds(K, splits))
                ms, _ = cs.kernel_ms(
                    lambda: rk._launch(a, b, perm, None, bn, cut),
                    cut.kernels, iters=20, warmup=3)
                times[f"{tile_n}x{splits}"] = ms
        row = {"step": i, "M": M, "K": K, "N": N,
               "chosen": vars(rk.launch_plan(M, K, N, bn)),
               "ms": times, "best": min(times, key=times.get)}
        print("[sweep] " + json.dumps(row), file=sys.stderr, flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kernel_bench.py")
    ap.add_argument("--src", action="append", default=None,
                    help="a directory holding repro_torch (repeatable)")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every tile width and split count")
    ap.add_argument("--out", default=None, help="write the runs here")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.sweep)), flush=True)
        return 0
    runs = []
    for src in args.src or [str(ROOT / "src")]:
        cmd = [sys.executable, __file__, "--child",
               str(pathlib.Path(src).resolve())]
        if args.sweep:
            cmd.append("--sweep")
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True)
        lines = proc.stdout.strip().splitlines()
        print("\n".join(lines[:-1]), file=sys.stderr, flush=True)
        if proc.returncode != 0:
            print(f"kernel_bench: {src} failed ({proc.returncode})",
                  file=sys.stderr)
            return proc.returncode
        rec = json.loads(lines[-1])
        runs.append(rec)
        tot = rec["steps"]["total"]
        print(json.dumps({"src": src, "kernel_ms": tot["ms"],
                          "event_ms": tot["event_ms"],
                          "plain_ms": tot["plain_ms"],
                          "library_ms": tot["library_ms"],
                          "bound_ms": tot["bound_ms"],
                          "per_step_ms": [r["kernel_ms"]
                                          for r in rec["steps"]["steps"]]}),
              flush=True)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
