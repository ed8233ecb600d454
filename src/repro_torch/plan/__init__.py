"""repro_torch.plan — network-level dataflow/layout planning and execution.

The planner half (``graph``, ``search``, ``plan``, ``fallback``) is the JAX
package's numpy code kept as copies, so both backends emit byte-identical
``ExecutionPlan`` artifacts; ``executor`` runs a plan (a GEMM chain or a
whole network) through the hand-written ``rir_matmul`` kernel on the card
(or its plain PyTorch version on the CPU).
"""
from .graph import (LayerGraph, bert_graph, from_arch_config, from_layers,
                    mobilenet_v3_graph, resnet50_graph)
from .plan import (ExecutionPlan, JoinSpec, PlanCache, PlanStep, config_key,
                   layout_block_perm)
from .search import (NetworkPlanner, PlannerOptions, brute_force_plan,
                     fixed_plan, greedy_plan, plan_network)
from .fallback import TIER_NAMES, ResolvedPlan, resolve_plan, upgrade_plan
from .executor import (PlanError, PreparedNetwork, PreparedPlan,
                       adapt_activation, execute_network,
                       execute_network_reference, execute_plan,
                       execute_plan_reference, fold_batchnorm,
                       permute_weight_blocks, prepare_network, prepare_plan,
                       step_kernel_blocks)

__all__ = [
    "LayerGraph", "from_layers", "resnet50_graph", "mobilenet_v3_graph",
    "bert_graph", "from_arch_config",
    "ExecutionPlan", "PlanStep", "JoinSpec", "PlanCache", "config_key",
    "layout_block_perm",
    "NetworkPlanner", "PlannerOptions", "plan_network", "greedy_plan",
    "brute_force_plan", "fixed_plan",
    "TIER_NAMES", "ResolvedPlan", "resolve_plan", "upgrade_plan",
    "PlanError", "PreparedPlan", "prepare_plan", "execute_plan",
    "execute_plan_reference", "permute_weight_blocks",
    "PreparedNetwork", "prepare_network", "execute_network",
    "execute_network_reference", "adapt_activation", "fold_batchnorm",
    "step_kernel_blocks",
]
