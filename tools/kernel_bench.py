#!/usr/bin/env python3
"""Time the port's hand-written kernels on the card at the shapes their
paths give them, for one source tree or several in turns.

    python3 tools/kernel_bench.py [--src DIR ...] [--kernels NAME ...]
                                  [--sweep] [--out FILE]

Each ``--src`` is a directory holding the ``repro_torch`` package (default:
this checkout's ``src``).  Each runs in a process of its own, in the order
given, so ``--src A --src B --src B --src A`` compares two versions of the
kernels in turns on one card.  A run builds that tree's kernels and times,
by device time (the kernels' ``torch.profiler`` events, ``chip_smoke``'s
``kernel_ms``), with queued and CUDA-event times beside:

- ``rir_matmul`` (``--kernels rir_matmul``): the twelve ResNet-50 batch-8
  steps, as ``chip_smoke.py``'s phase 3 does, against the plain version
  and ``torch.matmul``; then BERT-Large's four encoder GEMMs at 64
  sequences of 384 tokens (the benchmark's batch), each on the design
  ``launch_plan`` gives it and, where that is 3xTF32, on the SIMT design
  too, against ``torch.matmul`` and the bounds at 495 TFLOP/s (TF32),
  165 (3xTF32's three products) and 67 (fp32 on the CUDA cores).
  ``--sweep`` also times each ResNet-50 step at every tile width and
  K-split count the SIMT design takes (a cut forced through
  ``rir_matmul._launch``), the measurement ``launch_plan``'s rule is chosen
  from.
- ``gqa_decode``: the llama3.2-3b decode shape (B 8, Hq 24, Hkv 8, D 128,
  S 1024, lengths 960-1023) over one cache a layer, and zamba2's (B 8,
  32/32 heads, D 80, S 80, lengths 64-78) over one cache a shared-block
  invocation, in bf16, against the plain version and SDPA (phases 7 and
  15).
- ``linear_scan``: the rwkv6-1.6b training shape (B 8, H 32, T 1024, 64/64)
  and zamba2's (H 80), bf16 q/k/v and f32 log decay, against the plain
  chunked version (phases 10 and 15).

Every kernel's output is held against its plain version first.  One JSON
line a run on stdout (and a list of them in ``--out``).  Needs one NVIDIA
card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNELS = ("rir_matmul", "gqa_decode", "linear_scan")


def child(src: str, kernels, sweep: bool) -> dict:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs                  # puts this checkout's src first
    sys.path.insert(0, src)                  # ... and the tree asked for
    from repro_torch import api              # before it
    if not pathlib.Path(api.__file__).is_relative_to(src):
        raise SystemExit(f"kernel_bench: imported {api.__file__}, not {src}")
    from repro_torch.kernels import ops, ref
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"src": src, "card": cs.card_line()}
    if "rir_matmul" in kernels:
        rec["rir_matmul"] = bench_rir(torch, api, cs, ops, ref, sweep)
    if "gqa_decode" in kernels:
        rec["gqa_decode"] = bench_gqa(torch, api, cs, ops, ref)
    if "linear_scan" in kernels:
        rec["linear_scan"] = bench_scan(torch, cs, ops, ref)
    return rec


def ptxas_lines(log: str) -> list:
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "stack" in line]


def bench_rir(torch, api, cs, ops, ref, sweep: bool) -> dict:
    from repro_torch.kernels import rir_matmul as rk
    from repro_torch.serve.engine import _planner_options
    if not hasattr(rk, "launch_plan"):       # an older tree: one kernel,
        rk.launch_plan = lambda *_: argparse.Namespace(   # one cut for all
            kernels=("rir_matmul_kernel",))
    rk.load()
    graph = api.resnet50_graph().with_batch(cs.BATCH)
    opts = _planner_options(api.ServeConfig(graph="resnet50",
                                            max_batch=cs.BATCH, device="cuda"))
    plan = api.resolve_plan(graph, api.EvalConfig(), opts=opts,
                            cache=api.PlanCache()).plan
    rec = {"build_log": ptxas_lines(rk.build_log),
           "steps": cs.phase_kernel_resnet(torch, api, ops, ref, rk,
                                           {"resnet50": (graph, plan)}),
           "bert": bench_bert(torch, cs, ops, rk)}
    if sweep:
        rec["sweep"] = sweep_plans(torch, api, cs, ops, rk, graph, plan)
    return rec


#: BERT-Large's encoder GEMMs (name, K, N, residual) at 64 sequences of
#: 384 tokens: a residual joins attn-out's and FFN-down's outputs
BERT = (("qkv", 1024, 3072, False), ("attn_out", 1024, 1024, True),
        ("ffn_up", 1024, 4096, False), ("ffn_dn", 4096, 1024, True))
BERT_ROWS = 64 * 384


def bench_bert(torch, cs, ops, rk) -> list:
    """BERT-Large's four GEMMs by device time, on the design the rule
    gives each (and on the SIMT design beside a 3xTF32 one)."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    M = BERT_ROWS
    for name, K, N, res in BERT:
        a = torch.randn(M, K, device="cuda", generator=gen)
        b = torch.randn(K, N, device="cuda", generator=gen) / K ** 0.5
        r = torch.randn(M, N, device="cuda", generator=gen) if res else None
        perm = ops.device_perm(range(N // 128), "cuda")
        # the weight's 3xTF32 planes, made once as the executor makes them
        # (an older tree has one design, and no planes)
        kw = {"planes": ops.prepare_weight(b)} \
            if hasattr(ops, "prepare_weight") else {}
        cut = rk.launch_plan(M, K, N, 128)
        design = getattr(cut, "design", "simt")
        ms, seen = cs.kernel_ms(
            lambda: ops.rir_matmul(a, b, perm, residual=r, **kw),
            cut.kernels, iters=20, warmup=3)
        flops = 2.0 * M * K * N
        row = {"gemm": name, "M": M, "K": K, "N": N, "residual": res,
               "design": design, "kernel_ms": ms, "device_kernels": seen,
               "tflops": flops / ms / 1e9,
               "library_ms": cs.queued_ms(lambda: torch.matmul(a, b),
                                          iters=20, warmup=3),
               "bound_495_ms": flops / 495e12 * 1e3,
               "bound_165_ms": flops / 165e12 * 1e3,
               "bound_67_ms": flops / 67e12 * 1e3}
        if design != "simt":
            p = rk.launch_plan(M, K, N, 128, torch.bfloat16)
            simt = rk.LaunchPlan(p.tile_n, p.splits, p.k_bounds)
            row["simt_ms"], _ = cs.kernel_ms(
                lambda: rk._launch(a, b, perm, r, 128, simt), simt.kernels,
                iters=20, warmup=3)
        print("[bert] " + json.dumps(row), file=sys.stderr, flush=True)
        rows.append(row)
        del a, b, r, kw
    return rows


def bench_gqa(torch, api, cs, ops, ref) -> dict:
    from repro_torch.kernels import gqa_decode as gk
    # an older tree launched a split kernel and a merge kernel
    kernels = [gk.KERNEL] if hasattr(gk, "KERNEL") \
        else ["gqa_split_kernel", "gqa_merge_kernel"]
    gk.load()
    rec = {"build_log": ptxas_lines(gk.build_log)}
    cfg = api.get_config(cs.LM_ARCH)
    S = cs.LM_PROMPT + cs.LM_GEN
    lens = torch.randint(cs.LM_PROMPT, S, (cs.LM_BATCH,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(6))
    rec["llama"] = cs.gqa_times(torch, ops, ref, kernels, cs.LM_BATCH,
                                cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, S,
                                lens, cfg.n_layers, 6)
    cfg = api.get_config(cs.ZAMBA_ARCH)
    S = cs.ZAMBA_PROMPT + cs.ZAMBA_GEN
    lens = torch.arange(cs.ZAMBA_PROMPT, S, cs.ZAMBA_GEN // cs.ZAMBA_BATCH,
                        dtype=torch.int32)
    inv = -(-cfg.n_layers // cfg.shared_attn_every)
    rec["zamba2"] = cs.gqa_times(torch, ops, ref, kernels, cs.ZAMBA_BATCH,
                                 cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, S,
                                 lens, inv, 71)
    return rec


def bench_scan(torch, cs, ops, ref) -> dict:
    from repro_torch.kernels import linear_scan as lk
    lk.load()
    rec = {"build_log": ptxas_lines(lk.build_log)}
    B, H, T, dk, dv = cs.SCAN_TRAIN_SHAPE
    for name, shape in (("rwkv6_train", (B, H, T, dk, dv)),
                        ("zamba2_h80", (cs.ZAMBA_BATCH, 80, cs.ZAMBA_SCAN_T,
                                        64, 64))):
        q, k, v, w = cs.scan_inputs(torch, *shape, torch.bfloat16, 20)
        err = cs.check_close(f"scan {name}", ops.linear_scan(q, k, v, w),
                             ref.linear_scan_chunked(q, k, v, w),
                             cs.SCAN_TOL["bf16"], cs.SCAN_TOL["bf16"])
        rec[name] = {"max_abs_err": err,
                     **cs.scan_times(torch, ops, ref, ["linear_scan_kernel"],
                                     q, k, v, w)}
        del q, k, v, w
        torch.cuda.empty_cache()
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


def summary(rec: dict) -> dict:
    """The run's device times (and yardsticks) in one line."""
    out = {"src": rec["src"]}
    if "rir_matmul" in rec:
        tot = rec["rir_matmul"]["steps"]["total"]
        out["rir_matmul"] = {
            "kernel_ms": tot["ms"], "event_ms": tot["event_ms"],
            "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"],
            "bound_ms": tot["bound_ms"],
            "per_step_ms": [r["kernel_ms"]
                            for r in rec["rir_matmul"]["steps"]["steps"]],
            "bert_ms": {r["gemm"]: r["kernel_ms"]
                        for r in rec["rir_matmul"]["bert"]}}
    for kernel, cases in (("gqa_decode", ("llama", "zamba2")),
                          ("linear_scan", ("rwkv6_train", "zamba2_h80"))):
        if kernel in rec:
            out[kernel] = {c: {key: rec[kernel][c].get(key) for key in (
                "ms", "queued_ms", "event_ms", "plain_ms", "library_ms",
                "bound_ms")} for c in cases}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kernel_bench.py")
    ap.add_argument("--src", action="append", default=None,
                    help="a directory holding repro_torch (repeatable)")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=list(KERNELS), help="which kernels to time")
    ap.add_argument("--sweep", action="store_true",
                    help="also time rir_matmul at every tile width and "
                         "split count")
    ap.add_argument("--out", default=None, help="write the runs here")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.kernels, args.sweep)),
              flush=True)
        return 0
    runs = []
    for src in args.src or [str(ROOT / "src")]:
        cmd = [sys.executable, __file__, "--child",
               str(pathlib.Path(src).resolve()), "--kernels", *args.kernels]
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
        print(json.dumps(summary(rec)), flush=True)
        if args.out:                         # what has run so far
            path = pathlib.Path(args.out)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
