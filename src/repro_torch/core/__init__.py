"""FEATHER core: dataflow/layout co-switching, BIRRD, RIR, Layoutloop.

The port of ``repro.core``: the numpy modules copied (the BIRRD switch
model among them), the RIR oracle rewritten in torch.
"""
from .birrd import Birrd, BirrdTopology, birrd_cost, fan_cost, art_cost
from .conflicts import ConflictReport, assess_iact_conflicts, \
    assess_iact_conflicts_grid, concordant
from .dataflow import PING_PONG, ConvWorkload, Dataflow, \
    enumerate_dataflows, enumerate_tilings
from .layout import Buffer, Layout, conv_layout_space, gemm_layout_space
from .layoutloop import EvalConfig, LatticeMetrics, Metrics, SearchResult, \
    TileDramTerms, cosearch_layer, evaluate, evaluate_lattice, \
    exposed_stall_cycles, network_eval, tile_dram_terms
from .nest import NestConfig, nest_cycles, nest_walkthrough, systolic_cycles
from .rir import make_group_ids, rir_layout_write, rir_reduce_reorder

__all__ = [
    "Birrd", "BirrdTopology", "birrd_cost", "fan_cost", "art_cost",
    "ConflictReport", "assess_iact_conflicts", "assess_iact_conflicts_grid",
    "concordant",
    "PING_PONG", "ConvWorkload", "Dataflow", "enumerate_dataflows",
    "enumerate_tilings",
    "Buffer", "Layout", "conv_layout_space", "gemm_layout_space",
    "EvalConfig", "LatticeMetrics", "Metrics", "SearchResult",
    "TileDramTerms", "cosearch_layer", "evaluate", "evaluate_lattice",
    "exposed_stall_cycles", "network_eval", "tile_dram_terms",
    "NestConfig", "nest_cycles", "nest_walkthrough", "systolic_cycles",
    "make_group_ids", "rir_layout_write", "rir_reduce_reorder",
]
