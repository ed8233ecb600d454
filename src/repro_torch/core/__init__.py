"""FEATHER core cost model: dataflow/layout co-switching and Layoutloop.

The numpy-only half of ``repro.core``; the BIRRD/RIR oracles come with the
slice that ports the BIRRD kernel.
"""
from .conflicts import ConflictReport, assess_iact_conflicts, \
    assess_iact_conflicts_grid, concordant
from .dataflow import PING_PONG, ConvWorkload, Dataflow, \
    enumerate_dataflows, enumerate_tilings
from .layout import Buffer, Layout, conv_layout_space, gemm_layout_space
from .layoutloop import EvalConfig, LatticeMetrics, Metrics, SearchResult, \
    TileDramTerms, cosearch_layer, evaluate, evaluate_lattice, \
    exposed_stall_cycles, network_eval, tile_dram_terms
from .nest import NestConfig, nest_cycles, nest_walkthrough, systolic_cycles

__all__ = [
    "ConflictReport", "assess_iact_conflicts", "assess_iact_conflicts_grid",
    "concordant",
    "PING_PONG", "ConvWorkload", "Dataflow", "enumerate_dataflows",
    "enumerate_tilings",
    "Buffer", "Layout", "conv_layout_space", "gemm_layout_space",
    "EvalConfig", "LatticeMetrics", "Metrics", "SearchResult",
    "TileDramTerms", "cosearch_layer", "evaluate", "evaluate_lattice",
    "exposed_stall_cycles", "network_eval", "tile_dram_terms",
    "NestConfig", "nest_cycles", "nest_walkthrough", "systolic_cycles",
]
