"""Assigned architecture registry: one module per arch + reduced smoke twins."""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ArchConfig, SHAPES, ShapeCell, shape_by_name

ARCH_IDS = (
    "zamba2_2p7b", "whisper_small", "nemotron_4_15b", "minicpm_2b",
    "llama3p2_3b", "phi3_mini_3p8b", "llama4_scout_17b", "dbrx_132b",
    "chameleon_34b", "rwkv6_1p6b",
)

_ALIASES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "whisper-small": "whisper_small",
    "nemotron-4-15b": "nemotron_4_15b",
    "minicpm-2b": "minicpm_2b",
    "llama3.2-3b": "llama3p2_3b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "dbrx-132b": "dbrx_132b",
    "chameleon-34b": "chameleon_34b",
    "rwkv6-1.6b": "rwkv6_1p6b",
}


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> Dict[str, ArchConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}


def cells_for(arch: str) -> List[ShapeCell]:
    """The assigned shape cells this arch runs (skips per DESIGN.md §4)."""
    cfg = get_config(arch)
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.supports_long:
            continue  # quadratic attention: documented skip
        if s.kind in ("decode", "prefill") and not cfg.supports_decode:
            continue
        out.append(s)
    return out


__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "ARCH_IDS", "get_config",
           "all_configs", "cells_for", "shape_by_name"]
