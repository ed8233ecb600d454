#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card, end to end.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises on failure (nothing is caught and skipped):

1. Device and build: the card's name and power limit (``nvidia-smi``), and
   the ``rir_matmul`` CUDA kernel built from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` (seconds and ``ptxas`` report printed).
2. Planning: ResNet-50 and MobileNet-V3 at batch 8 with the serve engine's
   planner options, through one plan cache the engine then reuses.
3. Kernel vs plain on the card: ``rir_matmul`` against
   ``repro_torch.kernels.ref.rir_matmul`` over the JAX kernel sweep's shapes
   in f32 and bf16, with and without residual, random and identity perms,
   ragged M/K, and at each of the twelve ResNet-50 batch-8 plan steps, where
   it is also timed against the plain version, ``torch.matmul`` (yardstick
   only) and the card's bound.
4. Networks on the card: ``execute_network`` on ResNet-50 and MobileNet-V3
   at batch 8 against ``execute_network_reference`` on the CPU, one kernel
   launch per layer.
5. Serving (the main path): ``api.ServeEngine`` on ResNet-50 at
   ``max_batch=8`` with 2 workers; ragged requests, then the same requests
   one at a time; bit-identical outputs, 12 launches per batch.
6. Throughput and profile: the same serving with tracing off, three
   windows of 400 requests for requests/s and its spread, then one more
   under ``torch.profiler``: the device's busy share and its time by kernel.

The last two lines are the kernel record and ``{"ok": true, "device": ...}``.
Without CUDA, or without the repository's sources beside it, the script
exits non-zero and prints no result.  TF32 is switched off for PyTorch's
matmul and cuDNN, so every float32 comparison is float32 on both sides.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: fp32 on the CUDA cores and HBM3 bandwidth
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
REPLACES = "src/repro/kernels/rir_matmul.py:66"
SOURCE = "src/repro_torch/kernels/csrc/rir_matmul.cu"
# float32 sums in another order than cuBLAS's: 2e-4 (the JAX kernel sweep's
# tolerance); bf16 keeps 8 mantissa bits and the plain version rounds before
# the residual add where the kernel adds in f32: 2e-2
TOL = {"f32": 2e-4, "bf16": 2e-2}
# network outputs against the CPU reference: the JAX executor tests' bound,
# and, since MobileNet-V3's ReLU outputs average a few 1e-3 (near that atol),
# also max |err| <= NET_REL x max |y_ref|
NET_TOL = dict(rtol=1e-4, atol=1e-3)
NET_REL = 1e-4
DEV = "cuda"        # where the port runs; the plain reference runs on "cpu"
BATCH = 8           # the serve engine's max_batch: the plans' batch extent
N_REQUESTS = 20     # the bit-identity check's requests
N_WINDOW = 400      # requests per untraced throughput window (50 batches)
N_WINDOWS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_close(name: str, got, want, rtol: float, atol: float) -> float:
    import torch
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: max |err| {max_err(got, want):.3e} "
                             f"beyond rtol={rtol} atol={atol}")
    return max_err(got, want)


def check_network(name: str, got, want) -> dict:
    """NET_TOL, and max |err| against the reference's own scale."""
    err = check_close(name, got, want, **NET_TOL)
    scale = float(want.abs().max())
    if not err <= NET_REL * scale:
        raise AssertionError(f"{name}: max |err| {err:.3e} beyond "
                             f"{NET_REL} x max |y_ref| {scale:.3e}")
    return {"max_abs_err": err, "ref_mean_abs": float(want.abs().mean()),
            "ref_max_abs": scale}


# ------------------------------------------------------------------- phases
def phase_build(rk) -> dict:
    import torch
    name = card_line()
    log(f"[device] {name}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    t0 = time.perf_counter()
    rk.load()
    secs = time.perf_counter() - t0
    log(f"[build] {rk.library_path().name}: nvcc {rk.build_seconds:.1f} s, "
        f"load {secs:.1f} s")
    for line in rk.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")
    return {"card": name, "build_s": secs}


def phase_plan(api):
    from repro_torch.serve.engine import _planner_options
    cache = api.PlanCache()
    cfg = api.ServeConfig(graph="resnet50", max_batch=BATCH, device=DEV)
    opts = _planner_options(cfg)
    nets = {}
    for name, fn in (("resnet50", api.resnet50_graph),
                     ("mobv3", api.mobilenet_v3_graph)):
        graph = fn().with_batch(BATCH)
        t0 = time.perf_counter()
        resolved = api.resolve_plan(graph, api.EvalConfig(), opts=opts,
                                    cache=cache)
        if resolved.tier > 1:
            raise AssertionError(f"{name}: plan degraded to "
                                 f"{resolved.tier_name}: {resolved.reason}")
        log(f"[plan] {name} batch {BATCH}: {len(resolved.plan.steps)} steps, tier "
            f"{resolved.tier_name}, {time.perf_counter() - t0:.1f} s")
        nets[name] = (graph, resolved.plan)
    return cache, nets


def phase_kernel_sweep(torch, ops, ref) -> float:
    """The JAX sweep's shapes plus ragged M/K, f32 and bf16, +/- residual."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    shapes = [(128, 128, 256, 128), (256, 384, 512, 128),
              (256, 256, 1024, 256),                       # the JAX sweep
              (100, 147, 256, 128), (1000, 77, 384, 128),  # ragged M and K
              (7, 4608, 512, 128)]
    worst, n = 0.0, 0
    for m, k, n_cols, bn in shapes:
        for dt, tdt in dts.items():
            for with_res in (False, True):
                for ident in (False, True):
                    a = torch.randn(m, k, generator=gen).to(DEV, tdt)
                    b = torch.randn(k, n_cols, generator=gen).to(DEV, tdt)
                    r = torch.randn(m, n_cols, generator=gen).to(
                        DEV, tdt) if with_res else None
                    nb = n_cols // bn
                    perm = list(range(nb)) if ident else \
                        torch.randperm(nb, generator=gen).tolist()
                    y = ops.rir_matmul(a, b, None if ident else perm,
                                       residual=r, block_n=bn)
                    torch.cuda.synchronize()
                    want = ref.rir_matmul(a, b, perm, bn, residual=r)
                    name = f"sweep {m}x{k}x{n_cols}/{bn} {dt} res={with_res}"
                    if y.dtype != tdt or y.shape != (m, n_cols):
                        raise AssertionError(f"{name}: {y.dtype} {y.shape}")
                    err = check_close(name, y, want, TOL[dt], TOL[dt])
                    if dt == "f32":
                        worst = max(worst, err)
                    n += 1
    log(f"[kernel] sweep: {n} cases within tolerance (f32 {TOL['f32']}, "
        f"bf16 {TOL['bf16']}); worst f32 |err| {worst:.3e}")
    # a perm tensor ops.device_perm did not check is refused before launch
    bad = torch.tensor([0, 5], dtype=torch.int32, device=DEV)
    a = torch.zeros(8, 16, device=DEV)
    try:
        ops.rir_matmul(a, torch.zeros(16, 256, device=DEV), bad)
    except ValueError:
        log("[kernel] an unchecked perm tensor is refused before launch")
    else:
        raise AssertionError("an unchecked perm tensor reached the kernel")
    return worst


def phase_kernel_resnet(torch, api, ops, ref, nets) -> dict:
    """Each ResNet-50 plan step's GEMM at batch 8: checked and timed."""
    graph, plan = nets["resnet50"]
    weights = api.init_graph_weights(list(graph.layers), seed=0)
    prepared = api.prepare_network(plan, graph, weights, device=DEV)
    gen = torch.Generator(device="cpu").manual_seed(1)
    rows, tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                     "bound_ms": 0.0, "flop_ms": 0.0, "byte_ms": 0.0,
                     "gflop": 0.0, "gbytes": 0.0}
    worst = 0.0
    for i, st in enumerate(prepared.steps):
        a = torch.randn(st.rows_out, st.k_width, generator=gen).to(DEV)
        b = st.w_eff
        bn = st.block_n
        fused = any(j.fused for j in st.joins)
        r = torch.randn(st.rows_out, b.shape[1], generator=gen).to(DEV) \
            if fused else None
        perm_t = st.perm_dev
        perm = list(range(b.shape[1] // bn)) if perm_t is None \
            else perm_t.tolist()
        y = ops.rir_matmul(a, b, perm_t, residual=r, block_n=bn)
        torch.cuda.synchronize()
        want = ref.rir_matmul(a, b, perm, bn, residual=r)
        err = check_close(f"resnet50 step {i}", y, want, TOL["f32"],
                          TOL["f32"])
        worst = max(worst, err)
        M, K = a.shape
        # the bound counts the work the layer needs: its own output width,
        # not the columns the weight is padded with to whole perm blocks
        N = st.wl.M
        flops = 2.0 * M * K * N
        nbytes = 4.0 * (M * K + K * N + M * N + (M * N if fused else 0)
                        + len(perm))
        flop_ms = flops / FP32_PEAK_FLOPS * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"step": i, "layer": st.wl.name, "M": M, "K": K, "N": N,
               "N_launched": b.shape[1], "block_n": bn, "residual": fused,
               "kernel_ms": cuda_ms(lambda: ops.rir_matmul(
                   a, b, perm_t, residual=r, block_n=bn)),
               "plain_ms": cuda_ms(lambda: ref.rir_matmul(
                   a, b, perm, bn, residual=r)),
               "library_ms": cuda_ms(lambda: torch.matmul(a, b)),
               "bound_ms": max(flop_ms, byte_ms),
               "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
               "max_abs_err": err}
        rows.append(row)
        log("[kernel] " + json.dumps(row))
        for key in ("plain_ms", "library_ms", "bound_ms"):
            tot[key] += row[key]
        tot["ms"] += row["kernel_ms"]
        tot["flop_ms"] += flop_ms
        tot["byte_ms"] += byte_ms
        tot["gflop"] += flops / 1e9
        tot["gbytes"] += nbytes / 1e9
    tot["max_abs_err"] = worst
    tot["bound_by"] = "operations" if tot["flop_ms"] >= tot["byte_ms"] \
        else "bytes"
    log(f"[kernel] resnet50 batch {BATCH}, {len(rows)} steps "
        f"({tot['gflop']:.2f} GFLOP, {tot['gbytes']:.3f} GB): kernel "
        f"{tot['ms']:.3f} ms, "
        f"plain {tot['plain_ms']:.3f} ms, torch.matmul "
        f"{tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms "
        f"({tot['bound_by']})")
    return {"steps": rows, "total": tot}


def phase_networks(torch, api, rk, obs, nets) -> dict:
    out = {}
    for name, (graph, plan) in nets.items():
        weights = api.init_graph_weights(list(graph.layers), seed=0)
        x = torch.randn(graph.input_shape(),
                        generator=torch.Generator().manual_seed(2))
        prepared = api.prepare_network(plan, graph, weights, device=DEV)
        rk.reset_launch_count()
        y = api.execute_network(plan, graph, x, weights, prepared=prepared,
                                activation=torch.relu, device=DEV)
        torch.cuda.synchronize()
        launches = rk.launch_count()
        if launches != len(graph.layers) or y.device.type != DEV:
            raise AssertionError(f"{name}: {launches} launches for "
                                 f"{len(graph.layers)} layers, {y.device}")
        y_ref = api.execute_network_reference(graph, x, weights,
                                              activation=torch.relu,
                                              device="cpu")
        if tuple(y.shape) != tuple(y_ref.shape) or \
                not torch.isfinite(y).all():
            raise AssertionError(f"{name}: shape {tuple(y.shape)} vs "
                                 f"{tuple(y_ref.shape)} or non-finite")
        acc = check_network(f"{name} network", y.cpu(), y_ref)
        x_dev = x.to(DEV)
        batch_ms = cuda_ms(lambda: prepared(x_dev, activation=torch.relu),
                           iters=10)
        # one traced run: per-step wall clock, each step fenced
        obs.reset()
        obs.enable()
        prepared(x_dev, activation=torch.relu)
        steps = [round(e["dur"] / 1e3, 4) for e in obs.events()
                 if e.get("ev") == "span" and e["name"] == "exec.step"]
        obs.reset()
        rec = {"network": name, "batch": graph.input_shape()[0],
               "launches": launches, **acc,
               "batch_ms": batch_ms, "exec_step_ms": steps}
        log("[network] " + json.dumps(rec))
        out[name] = rec
    return out


def phase_serve(torch, api, rk, obs, cache, nets) -> dict:
    """The main path: plan (cached) -> executor -> engine, on the card."""
    import numpy as np
    graph, plan = nets["resnet50"]
    n_req = N_REQUESTS
    rng = torch.Generator().manual_seed(3)
    reqs = [torch.randn(graph.input_shape()[1:], generator=rng).numpy()
            for _ in range(n_req)]
    cfg = api.ServeConfig(graph="resnet50", max_batch=BATCH, workers=2,
                          device=DEV)
    seq_cfg = api.ServeConfig(graph="resnet50", max_batch=BATCH, workers=1,
                              assemble_max=1, device=DEV)
    results = {}
    for label, c in (("batched", cfg), ("sequential", seq_cfg)):
        obs.reset()
        obs.enable()
        with api.ServeEngine(c, cache=cache) as eng:
            if eng.resolved.tier > 1 or eng.resolved.plan != plan:
                raise AssertionError(f"serve plan tier "
                                     f"{eng.resolved.tier_name}")
            eng.serve(reqs[:2])                    # warm the engine's path
            obs.reset()
            obs.enable()
            rk.reset_launch_count()                # main path starts here
            t0 = time.perf_counter()
            outs = eng.serve(reqs)
            secs = time.perf_counter() - t0
            launches = rk.launch_count()           # ... and ends here
            batches = int(obs.counter_value("serve.batches"))
            e2e = obs.hist_stats("serve.e2e_ms")
            sizes = obs.hist_samples("serve.batch_size")
        if launches != len(graph.layers) * batches or launches == 0:
            raise AssertionError(f"{label}: {launches} launches for "
                                 f"{batches} batches")
        want_shape = graph.layers[-1]
        for o in outs:
            if o.shape != (want_shape.P, want_shape.Q, want_shape.M) or \
                    not (o == o).all():
                raise AssertionError(f"{label}: bad output {o.shape}")
        results[label] = {"outs": outs, "launches": launches,
                          "batches": batches, "requests": n_req,
                          "seconds": secs, "requests_per_s": n_req / secs,
                          "e2e_ms_p50": e2e["p50"], "e2e_ms_p99": e2e["p99"],
                          "batch_sizes": sizes}
        log("[serve] " + json.dumps({"mode": label, **{
            k: v for k, v in results[label].items() if k != "outs"}}))
    obs.reset()
    for i, (a, b) in enumerate(zip(results["batched"]["outs"],
                                   results["sequential"]["outs"])):
        if not (a == b).all():
            raise AssertionError(f"request {i}: batched != sequential")
    log(f"[serve] {n_req} requests: batched == sequential bit-identical")
    # the served outputs are right: the first two against the CPU reference
    weights = api.init_graph_weights(list(graph.layers), seed=0)
    y_ref = api.execute_network_reference(
        graph, torch.from_numpy(np.stack(reqs[:2])),
        weights, device="cpu")
    for i in range(2):
        check_network(f"served request {i}",
                      torch.from_numpy(results["batched"]["outs"][i]),
                      y_ref[i])
    for r in results.values():
        r.pop("outs")
    return results


def phase_profile(torch, api, obs, cache, nets) -> dict:
    """Serve with tracing off: ``N_WINDOWS`` windows of ``N_WINDOW``
    requests for requests/s and its spread, then one more under
    ``torch.profiler`` for where the wall time goes and the device's busy
    share."""
    from torch.profiler import ProfilerActivity, profile
    graph, _ = nets["resnet50"]
    reqs = list(torch.randn((N_WINDOW,) + tuple(graph.input_shape()[1:]),
                            generator=torch.Generator().manual_seed(4))
                .numpy())
    obs.reset()                                    # no per-step fences
    cfg = api.ServeConfig(graph="resnet50", max_batch=BATCH, workers=2,
                          device=DEV)
    rates = []
    with api.ServeEngine(cfg, cache=cache) as eng:
        eng.serve(reqs[:4 * BATCH])
        for _ in range(N_WINDOWS):
            t0 = time.perf_counter()
            eng.serve(reqs)
            rates.append(N_WINDOW / (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.serve(reqs)
            wall_s = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    by_name = sorted(((dev_us(e), e.key, e.count)
                      for e in prof.key_averages() if dev_us(e) > 0),
                     reverse=True)
    busy_ms = sum(us for us, _, _ in by_name) / 1e3
    rec = {"requests": N_WINDOW,
           "requests_per_s_untraced": rates,
           "profiled_requests_per_s": N_WINDOW / wall_s,
           "profiled_wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / (wall_s * 1e3) if busy_ms else None,
           "top_device_ms": [[name[:60], round(us / 1e3, 4), n]
                             for us, name, n in by_name[:8]]}
    log("[profile] " + json.dumps(rec))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--out", default=None,
                    help="also write every measurement as JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke runs on "
              "an NVIDIA card only", file=sys.stderr)
        return 1
    from repro_torch import api, obs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rir_matmul as rk

    t_start = time.perf_counter()
    record = {"build": phase_build(rk)}
    cache, nets = phase_plan(api)
    record["sweep_worst_f32_err"] = phase_kernel_sweep(torch, ops, ref)
    record["resnet50_steps"] = phase_kernel_resnet(torch, api, ops, ref, nets)
    record["networks"] = phase_networks(torch, api, rk, obs, nets)
    record["serve"] = phase_serve(torch, api, rk, obs, cache, nets)
    record["profile"] = phase_profile(torch, api, obs, cache, nets)
    record["seconds"] = time.perf_counter() - t_start
    tot = record["resnet50_steps"]["total"]
    kernels = {"kernels": [{
        "name": "rir_matmul", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES,
        "launches": record["serve"]["batched"]["launches"],
        "max_abs_err": tot["max_abs_err"], "ms": tot["ms"],
        "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": tot["bound_by"], "library_ms": tot["library_ms"]}]}
    record["kernels"] = kernels["kernels"]
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1))
    log(f"[done] {record['seconds']:.1f} s")
    print(card_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
