"""Model zoo factory: the dense decoder-only LMs and rwkv6 so far.

``build_model`` raises ``NotImplementedError`` naming the ROADMAP item for a
family the port does not run yet (MoE, hybrid, encoder-decoder, and the
mamba2 mixer of the ssm family).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig

from .lm import LMModel


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda"
                ) -> LMModel:
    """The model for ``cfg`` with uninitialised parameters on ``device``
    (``LMModel.init`` draws them, ``LMModel.load_params`` copies them in).
    ``device="cuda"`` raises where there is no CUDA; ``"cpu"`` runs the
    plain PyTorch path."""
    return LMModel(cfg, device=device)


__all__ = ["build_model", "LMModel"]
