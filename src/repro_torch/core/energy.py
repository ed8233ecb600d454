"""Per-access energy tables for the Layoutloop EDP metric.

Relative magnitudes follow Horowitz (ISSCC'14) style estimates at ~28 nm for
int8 datapaths; only *ratios* matter for the paper's comparisons.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    mac_pj: float = 0.2           # int8 MAC
    sram_line_read_pj: float = 6.0    # read one buffer line (e.g. 32 B)
    sram_line_write_pj: float = 7.0
    reg_access_pj: float = 0.05   # PE-local register file
    dram_word_pj: float = 160.0   # per 8 B off-chip access
    noc_hop_pj: float = 0.03      # per word per switch stage (BIRRD Egg)
    adder_pj: float = 0.02        # 32-bit add in OB / Egg

    def dram_bytes_pj(self, nbytes: float) -> float:
        return self.dram_word_pj * nbytes / 8.0


DEFAULT_ENERGY = EnergyModel()
