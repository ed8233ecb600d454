"""Baseline accelerator archetypes (paper Tab. IV) for Layoutloop comparison.

Each model constrains the co-search: which dataflow dims are flexible
("T"/"TS"/"TO"/"TOP"/"TOPS"), which on-chip reordering the hardware provides,
and whether the layout is fixed or free per layer.

The port's copy of ``repro.core.accel_models`` (numpy only), unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from .dataflow import ConvWorkload, Dataflow, enumerate_dataflows
from .layout import Layout
from .layoutloop import EvalConfig, SearchResult, cosearch_layer, network_eval
from .nest import NestConfig


@dataclasses.dataclass(frozen=True)
class AccelModel:
    name: str
    flexibility: str = "TOPS"          # which of T,O,P,S may vary per layer
    reorder: str = "none"              # none|offchip|line_rotation|transpose|row_reorder|rir
    fixed_layout: Optional[str] = None # layout string, None = co-searched per net/layer
    per_layer_layout: bool = False     # True only for FEATHER-class designs
    aw: int = 16
    ah: int = 16

    def eval_config(self) -> EvalConfig:
        return EvalConfig(nest=NestConfig(self.aw, self.ah), reorder=self.reorder)

    def dataflow_space(self, wl: ConvWorkload) -> List[Dataflow]:
        pes = self.aw * self.ah
        if self.flexibility == "T":
            # fixed parallelism: NVDLA / DPU / Gemmini style (C x M systolic)
            return [Dataflow(spatial=(("C", self.aw), ("M", self.ah)),
                             name="CxM-fixed")]
        if self.flexibility == "TS":
            # Eyeriss-like row stationary: (R x P) spatial with flexible shape
            return [Dataflow(spatial=(("R", min(self.aw, wl.R or 1)),
                                      ("P", self.ah)), name="row-stationary"),
                    Dataflow(spatial=(("R", min(4, max(wl.R, 1))),
                                      ("P", pes // min(4, max(wl.R, 1)))),
                             name="row-stationary-tall")]
        if self.flexibility == "TO":
            return list(enumerate_dataflows(wl, pes, max_dims=1))
        if self.flexibility == "TOP":
            return list(enumerate_dataflows(wl, pes, max_dims=2))
        return list(enumerate_dataflows(wl, pes, max_dims=2))  # TOPS

    def run(self, layers: Sequence[ConvWorkload]) -> List[SearchResult]:
        cfg = self.eval_config()
        dfs_per_layer = {id(l): self.dataflow_space(l) for l in layers}
        if self.fixed_layout is not None:
            lay = Layout.parse(self.fixed_layout)
            return [cosearch_layer(l, cfg, layout_fixed=lay,
                                   dataflows=dfs_per_layer[id(l)])
                    for l in layers]
        if self.per_layer_layout:
            return [cosearch_layer(l, cfg, dataflows=dfs_per_layer[id(l)])
                    for l in layers]
        # single best network-wide layout, searched (SIGMA-style fixed layout)
        return network_eval(layers, cfg, per_layer_layout=False)


# ----------------------------------------------------------------- Tab. IV set
NVDLA_LIKE = AccelModel("NVDLA-like", flexibility="T", reorder="none",
                        fixed_layout="HWC_C32")
EYERISS_LIKE = AccelModel("Eyeriss-like", flexibility="TS", reorder="none",
                          fixed_layout="HWC_C32")
GEMMINI_LIKE = AccelModel("Gemmini-like", flexibility="T", reorder="none",
                          fixed_layout="HWC_C32")
SIGMA_C32 = AccelModel("SIGMA-like(HWC_C32)", flexibility="TOPS",
                       reorder="none", fixed_layout="HWC_C32")
SIGMA_C4W8 = AccelModel("SIGMA-like(HWC_C4W8)", flexibility="TOPS",
                        reorder="none", fixed_layout="HWC_C4W8")
SIGMA_OFFCHIP = AccelModel("SIGMA-like(off-chip)", flexibility="TOPS",
                           reorder="offchip", per_layer_layout=True)
MEDUSA_LIKE = AccelModel("Medusa-like(line-rot)", flexibility="TOPS",
                         reorder="line_rotation", per_layer_layout=True)
MTIA_LIKE = AccelModel("MTIA-like(transpose)", flexibility="TOP",
                       reorder="transpose", per_layer_layout=True)
TPU_LIKE = AccelModel("TPUv4-like(trans+row)", flexibility="TO",
                      reorder="row_reorder", per_layer_layout=True)
FEATHER = AccelModel("FEATHER", flexibility="TOPS", reorder="rir",
                     per_layer_layout=True)

ALL_MODELS = (NVDLA_LIKE, EYERISS_LIKE, SIGMA_C32, SIGMA_C4W8, SIGMA_OFFCHIP,
              MEDUSA_LIKE, MTIA_LIKE, TPU_LIKE, FEATHER)
