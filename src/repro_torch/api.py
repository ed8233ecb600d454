"""repro_torch.api — the stable surface of the PyTorch port.

The counterpart of ``repro.api`` for what the port runs so far: planning,
execution of planned networks through the hand-written ``rir_matmul``
kernel, and serving.  Entry points take ``device="cuda"`` by default and
raise where CUDA is absent; ``device="cpu"`` runs the plain PyTorch path.
The function wrappers take keyword-only arguments beyond their primary
operands, as ``repro.api``'s do.

Typical use::

    from repro_torch import api

    with api.ServeEngine(api.ServeConfig(graph="resnet50", max_batch=8)) as eng:
        outs = eng.serve(samples)
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.layout import Layout
from repro_torch.core.layoutloop import EvalConfig
from repro_torch.core.workloads import init_graph_weights
from repro_torch.plan import (ExecutionPlan, LayerGraph, PlanCache,
                              PlannerOptions, PreparedNetwork, ResolvedPlan,
                              execute_network_reference, fold_batchnorm,
                              from_layers, mobilenet_v3_graph, resnet50_graph,
                              step_kernel_blocks)
from repro_torch.plan import execute_network as _execute_network
from repro_torch.plan import plan_network as _plan_network
from repro_torch.plan import prepare_network as _prepare_network
from repro_torch.plan import resolve_plan as _resolve_plan
from repro_torch.plan import upgrade_plan as _upgrade_plan
from repro_torch.serve import (QueueFullError, ServeConfig, ServeEngine,
                               ServeTicket)
from repro_torch.weights import to_torch_weights


def plan_network(graph: LayerGraph, cfg: EvalConfig, *,
                 opts: Optional[PlannerOptions] = None) -> ExecutionPlan:
    """Stable: full DP/Viterbi network co-search -> ``ExecutionPlan``."""
    return _plan_network(graph, cfg,
                         opts if opts is not None else PlannerOptions())


def resolve_plan(graph: LayerGraph, cfg: EvalConfig, *,
                 opts: Optional[PlannerOptions] = None,
                 cache: Optional[PlanCache] = None,
                 artifact: Optional[str] = None,
                 deadline_s: Optional[float] = None,
                 **kw) -> ResolvedPlan:
    """Stable: degradation-ladder plan resolution — always returns a plan."""
    return _resolve_plan(graph, cfg, opts, cache=cache, artifact=artifact,
                         deadline_s=deadline_s, **kw)


def upgrade_plan(graph: LayerGraph, cfg: EvalConfig, *,
                 opts: Optional[PlannerOptions] = None,
                 cache: Optional[PlanCache] = None,
                 **kw) -> Optional[ResolvedPlan]:
    """Stable: tier-1-only background re-plan; ``None`` means try later."""
    return _upgrade_plan(graph, cfg, opts, cache=cache, **kw)


def prepare_network(plan: ExecutionPlan, graph: LayerGraph, weights, *,
                    biases: Optional[Sequence] = None,
                    device: str | torch.device = "cuda") -> PreparedNetwork:
    """Stable: hoist a plan's per-batch setup onto ``device``."""
    return _prepare_network(plan, graph, weights, biases=biases,
                            device=device)


def execute_network(plan: ExecutionPlan, graph: LayerGraph, x, weights, *,
                    activation: Optional[Callable] = None,
                    prepared: Optional[PreparedNetwork] = None,
                    biases: Optional[Sequence] = None,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """Stable: run a planned network end to end through ``rir_matmul``."""
    return _execute_network(plan, graph, x, weights, activation=activation,
                            prepared=prepared, biases=biases, device=device)


__all__ = [
    # planning
    "EvalConfig", "Layout", "LayerGraph", "PlannerOptions", "ExecutionPlan",
    "PlanCache", "ResolvedPlan",
    "from_layers", "resnet50_graph", "mobilenet_v3_graph",
    "plan_network", "resolve_plan", "upgrade_plan",
    # execution
    "PreparedNetwork", "prepare_network", "execute_network",
    "execute_network_reference", "fold_batchnorm", "step_kernel_blocks",
    "init_graph_weights", "to_torch_weights",
    # serving
    "ServeEngine", "ServeConfig", "ServeTicket", "QueueFullError",
]
