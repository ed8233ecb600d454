"""Model zoo factory: the dense decoder-only LMs so far.

``build_model`` raises ``NotImplementedError`` naming the ROADMAP item for a
family the port does not run yet (MoE, SSM, hybrid, encoder-decoder).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig

from .lm import LMModel


def build_model(cfg: ArchConfig, device: str | torch.device = "cpu"
                ) -> LMModel:
    """The model for ``cfg`` with uninitialised parameters on ``device``
    (``LMModel.init`` draws them, ``LMModel.load_params`` copies them in)."""
    return LMModel(cfg, device=device)


__all__ = ["build_model", "LMModel"]
