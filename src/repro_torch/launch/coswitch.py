# check: ignore-file[api-boundary]  (pedagogical walkthrough of the internals the facade wraps, as examples/layout_coswitch.py)
"""The paper's core feature, end to end, on the port: per-layer (dataflow,
layout) co-switching with Reorder-In-Reduction, planned across the whole
network.  The counterpart of ``examples/layout_coswitch.py``:

    PYTHONPATH=src python -m repro_torch.launch.coswitch [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.coswitch --device cpu

Part 1 — the accelerator model: the network planner's Viterbi DP over
layer-boundary layouts on the first six ResNet-50 layers, against
per-layer-greedy and a fixed-layout baseline.

Part 2 — RIR on the card's kernels: ``rir_matmul`` writes its output
directly in the next layer's block layout (the relayout rides the
epilogue), and ``birrd_reduce`` runs a grouped reduction with an arbitrary
output reorder through the BIRRD switch program.

Part 3 — the planner's ``ExecutionPlan`` is serialized, reloaded and run
as a GEMM chain through ``execute_plan``, each epilogue permutation derived
from consecutive plan entries.

Part 4 — the complete ResNet-50 graph (convs, strides, residual joins)
through ``execute_network`` against ``execute_network_reference``.

Part 5 — the joint (dataflow x tile x layout) co-search, planned with and
without tiles on two hardware classes.

It prints what the example prints.  Where the example prints ``False`` for
an oracle check, this module raises ``AssertionError``, so a run that
finishes has passed every check.  ``--device`` is ``cuda`` by default
(the hand-written kernels; it raises without CUDA); ``cpu`` runs their
plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.dataflow import ConvWorkload
from repro_torch.core.layout import Layout
from repro_torch.core.layoutloop import EvalConfig
from repro_torch.core.workloads import init_graph_weights, resnet50_layers
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.plan import (ExecutionPlan, NetworkPlanner, PlannerOptions,
                              execute_network, execute_network_reference,
                              execute_plan, from_layers, resnet50_graph,
                              step_kernel_blocks)

#: the JAX executor tests' network tolerance
NET_TOL = dict(rtol=1e-4, atol=1e-3)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"coswitch: {what} failed")


def _opts(**kw) -> PlannerOptions:
    return PlannerOptions(switch_modes=("rir",),
                          parallel_dims=("C", "P", "Q"), **kw)


def part1_network_planning() -> Dict:
    print("=== Part 1: network-level (dataflow, layout) planning ===")
    graph = from_layers(resnet50_layers()[:6], "resnet50-head")
    planner = NetworkPlanner(graph, EvalConfig(), _opts())
    plan = planner.plan()
    for s in plan.steps:
        print(f"  {s.layer:18s} -> dataflow={s.dataflow.label():10s} "
              f"{s.in_layout:10s}->{s.out_layout:10s} reorder={s.reorder}")
    fixed = planner.fixed(Layout.parse("HWC_C32"))
    greedy = planner.greedy()
    print(f"  planned cycles: {plan.total_cycles:.3e}  "
          f"greedy: {greedy.total_cycles:.3e}  "
          f"fixed-layout: {fixed.total_cycles:.3e}  "
          f"speedup vs fixed: {fixed.total_cycles / plan.total_cycles:.2f}x")
    _check(plan.total_cycles <= greedy.total_cycles, "planned <= greedy")
    return {"planned_cycles": plan.total_cycles,
            "greedy_cycles": greedy.total_cycles,
            "fixed_cycles": fixed.total_cycles}


def part2_rir_kernels(device: torch.device) -> Dict:
    print("=== Part 2: RIR on the card's kernels ===")
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(256, 256)).astype(np.float32)
                         ).to(device)
    b = torch.from_numpy(rng.normal(size=(256, 512)).astype(np.float32)
                         ).to(device)
    # the NEXT layer wants N-blocks in order [2, 0, 3, 1] — the producing
    # matmul writes them there directly; no separate relayout pass runs
    perm = (2, 0, 3, 1)
    y = ops.rir_matmul(a, b, perm)
    plain = a @ b
    moved = bool(torch.allclose(y[:, 2 * 128:3 * 128], plain[:, 0:128],
                                atol=1e-4))
    print(f"  rir_matmul: consumer layout written in the epilogue: {moved}")
    _check(moved, "rir_matmul's epilogue layout")

    # BIRRD pass: 4 reduction groups of 4 wires, results scattered to the
    # banks the next layer's dataflow reads conflict-free
    x = torch.from_numpy(rng.normal(size=(16, 256)).astype(np.float32)
                         ).to(device)
    gids = [i // 4 for i in range(16)]
    ports = [0, 4, 8, 12]
    y = ops.birrd_reduce(x, gids, ports)
    want = ref.birrd_reduce(x, torch.tensor(gids, dtype=torch.int32),
                            torch.tensor(ports, dtype=torch.int32), 16)
    match = bool(torch.allclose(y, want, atol=1e-5))
    print(f"  birrd_reduce: grouped reduce+reorder matches oracle: {match}")
    print(f"  group sums landed at ports {ports} "
          f"(junk ports masked to zero): "
          f"{[round(float(v), 2) for v in y[:, 0].cpu()]}")
    _check(match, "birrd_reduce against the RIR oracle")
    return {"rir_matmul_layout": moved, "birrd_matches_oracle": match,
            "birrd_max_abs_err": float((y - want).abs().max())}


def part3_plan_execution(device: torch.device) -> Dict:
    print("=== Part 3: serialized plan driven through the card's kernels ===")
    chain = from_layers([
        ConvWorkload.from_gemm(M=384, N=128, K=256, name="fc1"),
        ConvWorkload.from_gemm(M=512, N=128, K=384, name="fc2"),
        ConvWorkload.from_gemm(M=256, N=128, K=512, name="fc3"),
    ], "mlp3")
    plan = NetworkPlanner(chain, EvalConfig(), _opts()).plan()
    plan = ExecutionPlan.from_json(plan.to_json())   # round-trip the artifact
    rng = np.random.default_rng(1)

    def t(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(device)

    x = t((128, 256))
    ws = [t((256, 384)), t((384, 512)), t((512, 256))]
    y = execute_plan(plan, x, ws, device=device)
    y_plain = x @ ws[0] @ ws[1] @ ws[2]
    ok = bool(torch.allclose(y, y_plain, rtol=1e-4, atol=0.1))
    print(f"  {len(plan)} planned layers executed via rir_matmul; "
          f"output matches plain chain: {ok}")
    _check(ok, "the planned chain against the plain chain")
    return {"steps": len(plan), "chain_matches": ok,
            "max_abs_err": float((y - y_plain).abs().max())}


def part4_full_network_execution(device: torch.device) -> Dict:
    print("=== Part 4: full ResNet-50 graph — convs + residual joins ===")
    graph = resnet50_graph()
    plan = NetworkPlanner(graph, EvalConfig(), _opts()).plan()
    plan = ExecutionPlan.from_json(plan.to_json())
    joined = [(s.layer, [(j.src, j.relayout) for j in s.joins])
              for s in plan.steps if s.joins]
    n_conv = sum(1 for s in plan.steps if s.lowering != "gemm")
    print(f"  {len(plan)} layers ({n_conv} conv-lowered), residual joins "
          f"at: {joined}")
    ws = init_graph_weights(list(graph.layers), seed=0)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=graph.input_shape())
                         .astype(np.float32))
    y = execute_network(plan, graph, x, ws, activation=torch.relu,
                        device=device)
    y_ref = execute_network_reference(graph, x, ws, activation=torch.relu,
                                      device=device)
    err = float((y - y_ref).abs().max())
    print(f"  executed {tuple(y.shape)} output through rir_matmul only "
          f"(no reference fallback); max |err| vs oracle = {err:.2e}")
    _check(bool(torch.allclose(y, y_ref, **NET_TOL)),
           f"ResNet-50 against the reference (max |err| {err:.2e})")
    return {"layers": len(plan), "max_abs_err": err,
            "ref_max_abs": float(y_ref.abs().max())}


def part5_joint_tile_planning() -> Dict:
    print("=== Part 5: joint (dataflow x tile x layout) co-search ===")
    graph = resnet50_graph()
    cfg = EvalConfig()
    hardware = {"offchip-only": ("offchip",), "rir+offchip": ("rir", "offchip")}
    out = {}
    for hw, modes in hardware.items():
        base = PlannerOptions(switch_modes=modes,
                              parallel_dims=("C", "P", "Q"),
                              search_tiles=False)
        untiled = NetworkPlanner(graph, cfg, base).plan()
        tiled = NetworkPlanner(
            graph, cfg, dataclasses.replace(base, search_tiles=True)).plan()

        def edp(p):
            return p.total_energy_pj * p.total_cycles

        _check(tiled.total_cycles <= untiled.total_cycles,
               f"[{hw}] tiled <= untiled")
        print(f"  [{hw}] planned-without-tiles: {untiled.total_cycles:.3e} "
              f"cycles, EDP {edp(untiled):.3e}")
        print(f"  [{hw}] planned-with-tiles:    {tiled.total_cycles:.3e} "
              f"cycles, EDP {edp(tiled):.3e}  "
              f"({edp(untiled) / edp(tiled):.1f}x EDP win, "
              f"{sum(1 for s in tiled.steps if s.tiles)}/{len(tiled)} "
              f"layers tiled)")
        for s in tiled.steps[:4]:
            print(f"    {s.layer:18s} tile={dict(s.tiles) or 'whole-tensor'} "
                  f"kernel blocks={step_kernel_blocks(s)}")
        out[hw] = {"untiled_cycles": untiled.total_cycles,
                   "tiled_cycles": tiled.total_cycles,
                   "edp_win": edp(untiled) / edp(tiled)}
    return out


def run(device: str | torch.device = "cuda") -> Dict:
    """Parts 1-5 on ``device``; returns each part's numbers.  Raises
    ``AssertionError`` on a failed check."""
    dev = resolve_device(device)
    return {"part1": part1_network_planning(),
            "part2": part2_rir_kernels(dev),
            "part3": part3_plan_execution(dev),
            "part4": part4_full_network_execution(dev),
            "part5": part5_joint_tile_planning()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.coswitch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
