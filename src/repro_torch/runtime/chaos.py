"""Chaos smoke: the fault-injection harness exercising the whole stack.

    PYTHONPATH=src python -m repro_torch.runtime.chaos --seed 0
        [--graph tiny|resnet50|mobv3] [--arch llama3p2_3b]
        [--skip-serve] [--report out.json] [--device cuda|cpu]

The port of ``repro.runtime.chaos``, with the same phases, schedules and
counts, on ``--device`` (cuda by default; raises without CUDA): a planned
network execution (``rir_matmul``), a continuous-batching engine serve
(``rir_matmul``) and an LM serve smoke (``gqa_decode`` for a dense arch)
under a seeded ``FaultSchedule`` covering every fault site (plan
load/save, plan-cache I/O, kernel dispatch, checkpoint write/read,
heartbeat, serve-queue admission), asserting the three robustness claims:

1. **no injected fault escapes** — every scheduled fault fires
   (``schedule.all_fired()``, counter-verified against
   ``faults.injected{site=}``) and none surfaces as a crash;
2. **degradation preserves outputs** — when the ladder stays at tier <= 1
   (cached / re-planned) the faulted run's outputs are bit-identical to the
   fault-free baseline (the planner is deterministic);
3. **everything is observable** — each injection, retry, and tier choice
   lands in its obs counter.

The checkpoint phase includes the kill-between-write-and-rename case: a
save whose retries are all injected leaves the previous committed
checkpoint fully restorable.  ``--report`` writes a JSON summary (counters,
per-site injection counts, resolved tiers).  Where ``repro`` runs the LM
phase inside a one-device mesh, the port has no mesh yet (ROADMAP Queue 1
item 10) and runs on the device alone.  The port's ``decode_step`` writes
its cache in place, so each decode pass starts from its own copy of the
prefilled cache, and the faulted step fires its fault before it touches
the cache, which makes its retry safe.  The LM's weights and prompts come
from seeded ``torch.Generator``s, so its tokens are not ``repro``'s.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import tempfile
from typing import List, Optional


def _nosleep(_s: float) -> None:
    return None


def _fail(msg: str) -> None:
    print(f"[chaos] FAIL: {msg}", file=sys.stderr)
    raise AssertionError(msg)


def _counter_baseline(schedule) -> dict:
    """Per-site ``faults.injected`` counter values before arming, so the
    post-run check compares deltas (phases share one obs registry)."""
    from repro_torch import obs

    return {name: obs.counter_value("faults.injected", site=name)
            for name in schedule.sites}


def _check_schedule(schedule, label: str, base: dict) -> None:
    """Every count-mode site fired exactly its scheduled count, and the obs
    counters agree with the schedule's own books."""
    from repro_torch import obs

    for name, spec in schedule.sites.items():
        got = schedule.injected(name)
        if got != spec.count:
            _fail(f"{label}: site {name!r} injected {got} != "
                  f"scheduled {spec.count}")
        ctr = obs.counter_value("faults.injected", site=name) - base[name]
        if ctr != spec.count:
            _fail(f"{label}: counter faults.injected{{site={name}}} grew "
                  f"{ctr} != {spec.count}")
    if not schedule.all_fired():
        _fail(f"{label}: schedule.all_fired() is false")


def _network_phase(args, tmp: pathlib.Path) -> dict:
    """Planned network execution under plan-cache / plan-load / dispatch /
    checkpoint / heartbeat faults."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                        restore_pytree, save_pytree)
    from repro_torch.core.layout import Layout
    from repro_torch.core.layoutloop import EvalConfig
    from repro_torch.core.workloads import init_graph_weights
    from repro_torch.obs.smoke import build_graph
    from repro_torch.plan import (PlanCache, PlannerOptions, execute_network,
                                  resolve_plan)
    from repro_torch.runtime import HeartbeatRegistry, faults
    from repro_torch.runtime.retry import IO_POLICY, retry_call

    graph = build_graph(args.graph)
    layouts = tuple(Layout.parse(s) for s in ("HWC_C32", "HWC_H32"))
    opts = PlannerOptions(switch_modes=("rir",), layouts=layouts,
                          parallel_dims=("C", "P", "Q"))
    cfg = EvalConfig()
    plans_dir = tmp / "plans"

    # ---- fault-free baseline -------------------------------------------
    r0 = resolve_plan(graph, cfg, opts, cache=PlanCache(plans_dir),
                      sleep=_nosleep, policy=IO_POLICY)
    ws = init_graph_weights(list(graph.layers), seed=0)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=graph.input_shape())
                         .astype(np.float32))

    def run(plan) -> np.ndarray:
        return execute_network(plan, graph, x, ws,
                               device=args.device).cpu().numpy()

    y0 = run(r0.plan)

    # ---- the same work under a seeded fault schedule -------------------
    # count-mode arithmetic (IO_POLICY has max_attempts=3): the cache read
    # burns 2 plan_cache.io injections, its third attempt reaches the
    # artifact parse where plan.load injects -> retries exhausted -> miss ->
    # tier-1 re-plan, which the deterministic planner makes byte-identical
    # to the cached plan.  ckpt.write skips the first save (after=1), then
    # injects 3 = max_attempts times so the second save exhausts its
    # retries: the kill-between-write-and-rename case.
    schedule = faults.FaultSchedule(seed=args.seed, sites={
        "plan.load": faults.SiteSpec(count=1, exc="OSError"),
        "plan_cache.io": faults.SiteSpec(count=2, exc="OSError"),
        "exec.dispatch": faults.SiteSpec(count=1, exc="RuntimeError"),
        "ckpt.write": faults.SiteSpec(count=3, after=1, exc="OSError"),
        "ckpt.read": faults.SiteSpec(count=1, exc="OSError"),
        "heartbeat": faults.SiteSpec(count=2, exc="ConnectionError"),
    })
    base = _counter_baseline(schedule)
    with faults.injecting(schedule):
        r1 = resolve_plan(graph, cfg, opts,
                          cache=PlanCache(plans_dir, sleep=_nosleep),
                          sleep=_nosleep, policy=IO_POLICY)
        y1 = retry_call(lambda: run(r1.plan), site="exec.dispatch",
                        policy=IO_POLICY, sleep=_nosleep)

        # checkpointing: save one good step, then a save whose retries are
        # all injected (previous-good must survive), then a clean save
        root = tmp / "ckpt"
        tree1 = {"w": np.arange(8, dtype=np.float32), "b": np.float32(1.0)}
        tree2 = {"w": np.arange(8, dtype=np.float32) * 2,
                 "b": np.float32(2.0)}
        save_pytree(tree1, root / "step_00000001")        # visit 1: skipped
        try:
            retry_call(lambda: save_pytree(tree2, root / "step_00000002"),
                       site="ckpt.write", policy=IO_POLICY, sleep=_nosleep)
            _fail("second checkpoint save should have exhausted retries")
        except OSError:
            pass
        if latest_step(root) != 1:
            _fail(f"failed save corrupted the store: latest={latest_step(root)}")
        got = retry_call(                         # absorbs the ckpt.read fault
            lambda: restore_pytree({"w": np.zeros(8, np.float32),
                                    "b": np.float32(0)},
                                   root / "step_00000001"),
            site="ckpt.read", policy=IO_POLICY, sleep=_nosleep)
        if not np.array_equal(np.asarray(got["w"]), tree1["w"]):
            _fail("previous-good checkpoint no longer restores after "
                  "kill-between-write-and-rename")
        save_pytree(tree2, root / "step_00000002")        # injections spent
        if latest_step(root) != 2:
            _fail("clean save after exhausted injections did not commit")
        # restore_latest through the manager (read injections already spent)
        mgr = CheckpointManager(root, sleep=_nosleep)
        try:
            step, tree = mgr.restore_latest({"w": np.zeros(8, np.float32),
                                             "b": np.float32(0)})
        finally:
            mgr.close()
        if step != 2 or not np.array_equal(np.asarray(tree["w"]),
                                           tree2["w"]):
            _fail(f"restore_latest under read fault: step={step}")

        # heartbeats: 2 of 4 packets dropped, none crash, both land in obs
        reg = HeartbeatRegistry(["host0"])
        for _ in range(4):
            reg.beat("host0")
        if "host0" not in reg.alive():
            _fail("host0 should be alive after surviving beats")

    _check_schedule(schedule, "network", base)
    dropped = obs.counter_value("heartbeat.dropped", type="ConnectionError")
    if dropped != 2:
        _fail(f"heartbeat.dropped = {dropped} != 2")
    if r1.tier <= 1 and not np.array_equal(y0, y1):
        _fail(f"outputs differ at tier {r1.tier_name} — degradation must be "
              f"bit-exact at tier <= 1")
    if obs.counter_value("degrade.tier", level=r1.tier_name) < 1:
        _fail(f"degrade.tier{{level={r1.tier_name}}} counter missing")
    print(f"[chaos] network phase ok: graph={graph.name} "
          f"baseline_tier={r0.tier_name} faulted_tier={r1.tier_name} "
          f"injected={schedule.total_injected()} outputs_identical="
          f"{bool(np.array_equal(y0, y1))}")
    return {"graph": graph.name, "baseline_tier": r0.tier_name,
            "faulted_tier": r1.tier_name,
            "sites": schedule.summary()}


def _clone(tree):
    """A deep copy of a (nested dict) decode cache."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _serve_phase(args, tmp: pathlib.Path) -> dict:
    """LM serve smoke: plan resolution + decode loop under injection."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.layoutloop import EvalConfig
    from repro_torch.models import build_model
    from repro_torch.plan import (ExecutionPlan, PlanCache, PlannerOptions,
                                  from_arch_config, resolve_plan)
    from repro_torch.runtime import faults
    from repro_torch.runtime.retry import IO_POLICY, retry_call

    cfg = get_config(args.arch, smoke=True)
    prompt_len, gen, B = 8, 4, 2
    graph = from_arch_config(cfg, seq=prompt_len + gen)
    eval_cfg = EvalConfig()
    opts = PlannerOptions(switch_modes=("rir",),
                          parallel_dims=("C", "P", "Q"))
    artifact = tmp / "serve-plan.json"

    # fault-free resolve creates the artifact (tier 1, saved back)
    r0 = resolve_plan(graph, eval_cfg, opts, cache=PlanCache(),
                      artifact=artifact, sleep=_nosleep, policy=IO_POLICY)
    if not artifact.exists():
        _fail("serve plan artifact was not saved back")

    model = build_model(cfg, device=args.device)
    model.init(torch.Generator(device=model.device).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (B, prompt_len),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32).to(model.device)

    def run_decode(cache0, logits0, inject: bool) -> np.ndarray:
        tokens = torch.argmax(logits0, dim=-1)
        cache, out = _clone(cache0), [tokens]   # decode writes in place
        for _ in range(gen - 1):
            def step(c=cache, t=tokens):
                faults.site("exec.dispatch")    # before the cache is touched
                return model.decode_step(c, t)
            if inject:
                cache, logits = retry_call(step, site="exec.dispatch",
                                           policy=IO_POLICY, sleep=_nosleep)
            else:
                cache, logits = step()
            tokens = torch.argmax(logits, dim=-1)
            out.append(tokens)
        return torch.stack(out, dim=1).cpu().numpy()

    with torch.inference_mode():
        if cfg.family in ("ssm", "hybrid"):
            cache0 = model.init_cache(B, prompt_len + gen)
            logits0 = None
            for t in range(prompt_len):            # SSM prefill = scan-in
                cache0, logits0 = model.decode_step(cache0, prompts[:, t])
        else:
            cache0, logits0 = model.prefill(prompts, prompt_len + gen)
        gen0 = run_decode(cache0, logits0, inject=False)

        # plan.load exhausts all 3 retry attempts -> artifact miss -> tier-1
        # re-plan -> save-back absorbs one plan.save injection (proving the
        # temp-file+rename write recovers); decode absorbs one dispatch fault
        schedule = faults.FaultSchedule(seed=args.seed, sites={
            "plan.load": faults.SiteSpec(count=3, exc="OSError"),
            "plan.save": faults.SiteSpec(count=1, exc="OSError"),
            "exec.dispatch": faults.SiteSpec(count=1, exc="RuntimeError"),
        })
        base = _counter_baseline(schedule)
        with faults.injecting(schedule):
            r1 = resolve_plan(graph, eval_cfg, opts, cache=PlanCache(),
                              artifact=artifact, sleep=_nosleep,
                              policy=IO_POLICY)
            gen1 = run_decode(cache0, logits0, inject=True)

    _check_schedule(schedule, "serve", base)
    if r1.tier > 1:
        _fail(f"serve plan degraded past re-plan: tier={r1.tier_name}")
    if r1.plan.to_json() != r0.plan.to_json():
        _fail("re-planned serve plan differs from baseline plan JSON")
    reloaded = ExecutionPlan.load(artifact)
    if reloaded.to_json() != r0.plan.to_json():
        _fail("artifact after faulted save-back differs from baseline plan")
    if not np.array_equal(gen0, gen1):
        _fail("decoded tokens differ between fault-free and faulted serve")
    print(f"[chaos] serve phase ok: arch={cfg.name} tier={r1.tier_name} "
          f"injected={schedule.total_injected()} tokens_identical=True")
    return {"arch": cfg.name, "faulted_tier": r1.tier_name,
            "sites": schedule.summary()}


def _engine_phase(args, tmp: pathlib.Path) -> dict:
    """Continuous-batching engine under ``serve.queue`` admission faults.

    Injected admission faults must surface as typed ``QueueFullError``
    backpressure rejections — never an unhandled escape, never a deadlock —
    and the retried requests' outputs must stay bit-identical to a
    fault-free sequential serve."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.api import (PlanCache, QueueFullError, ServeConfig,
                                 ServeEngine)
    from repro_torch.runtime import faults

    cache = PlanCache(tmp / "engine-plans")
    cfg = ServeConfig(graph="tiny", max_batch=4, workers=2,
                      queue_capacity=16, device=args.device)
    rng = np.random.default_rng(args.seed)
    schedule = faults.FaultSchedule(seed=args.seed, sites={
        "serve.queue": faults.SiteSpec(count=2, exc="RuntimeError"),
    })
    base = _counter_baseline(schedule)
    rej0 = obs.counter_value("serve.rejected", reason="fault")
    with ServeEngine(cfg, cache=cache, sleep=_nosleep) as eng:
        samples = [rng.standard_normal(eng.sample_shape).astype(np.float32)
                   for _ in range(9)]
        with faults.injecting(schedule):
            # engine.serve absorbs QueueFullError rejections by resubmitting;
            # the two injected admission faults land on the first submits
            outs = eng.serve(samples)
            try:
                faults.site("serve.queue")   # spent schedule: admission clean
            except faults.STEP_FAULT_TYPES:
                _fail("engine: serve.queue fired past its scheduled count")
    _check_schedule(schedule, "engine", base)
    rejected = obs.counter_value("serve.rejected", reason="fault") - rej0
    if rejected != 2:
        _fail(f"engine: serve.rejected{{reason=fault}} grew {rejected} != 2")

    seq_cfg = ServeConfig(graph="tiny", max_batch=4, workers=1,
                          assemble_max=1, queue_capacity=16,
                          device=args.device)
    with ServeEngine(seq_cfg, cache=cache, sleep=_nosleep) as seq:
        if seq.resolved.tier != 0:
            _fail(f"engine: shared cache missed (tier={seq.resolved.tier_name})")
        ref = seq.serve(samples)
        try:
            seq.submit(np.zeros((3,), np.float32))
            _fail("engine: bad-shape submit should raise")
        except QueueFullError:
            _fail("engine: bad shape misreported as backpressure")
        except Exception:
            pass   # typed ServeError, the correct rejection
    for i, (a, b) in enumerate(zip(outs, ref)):
        if not np.array_equal(a, b):
            _fail(f"engine: request {i} differs from sequential serve")
    print(f"[chaos] engine phase ok: {len(samples)} requests, "
          f"{int(rejected)} typed admission rejections, "
          f"batched == sequential bit-identical")
    return {"graph": "tiny", "rejected": int(rejected),
            "sites": schedule.summary()}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.runtime.chaos")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--graph", default="resnet50",
                    choices=["tiny", "resnet50", "mobv3"])
    ap.add_argument("--arch", default="llama3p2_3b")
    ap.add_argument("--skip-serve", action="store_true",
                    help="network phase only (faster)")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write a JSON fault/degradation report here")
    ap.add_argument("--keep-dir", default=None, metavar="DIR",
                    help="run in DIR and keep it (plan artifacts survive); "
                         "default is a temp dir removed on exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import obs
    from repro_torch.device import resolve_device
    from repro_torch.runtime import faults

    resolve_device(args.device)          # fail before any phase, not inside
    report = {"seed": args.seed}
    with contextlib.ExitStack() as stack:
        if args.keep_dir:
            tmp = pathlib.Path(args.keep_dir)
            tmp.mkdir(parents=True, exist_ok=True)
        else:
            tmp = pathlib.Path(stack.enter_context(
                tempfile.TemporaryDirectory(prefix="chaos-")))
        obs.reset()
        obs.enable(str(tmp / "chaos-trace.jsonl"))
        try:
            report["network"] = _network_phase(args, tmp)
            report["engine"] = _engine_phase(args, tmp)
            if not args.skip_serve:
                report["serve"] = _serve_phase(args, tmp)
        except AssertionError:
            return 1
        except faults.STEP_FAULT_TYPES as e:
            if faults.is_injected(e):
                print(f"[chaos] FAIL: injected fault escaped as a crash: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
                return 1
            raise
        finally:
            faults.disarm()
            report["counters"] = {
                k: v for k, v in sorted(obs.snapshot()["counters"].items())
                if k.split("{")[0] in
                ("faults.injected", "retry.attempts", "retry.exhausted",
                 "degrade.tier", "plan_cache.io_error", "ckpt.write_failed",
                 "ckpt.restore_failed", "ckpt.restore_fallback",
                 "heartbeat.dropped", "serve.rejected")}
            obs.disable()

    print("[chaos] counters:")
    for k, v in report["counters"].items():
        print(f"  {k} = {v:g}")
    if args.report:
        pathlib.Path(args.report).write_text(json.dumps(report, indent=2))
        print(f"[chaos] report -> {args.report}")
    print(f"[chaos] ok: seed={args.seed}, every scheduled fault injected, "
          f"none escaped, outputs bit-identical at tier <= replanned")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
