"""Model zoo factory: every family of the zoo — the dense and MoE
decoder-only LMs, the SSMs (rwkv6, mamba2), the zamba2 hybrid and the
whisper encoder-decoder.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig

from .encdec import EncDecModel
from .hybrid import HybridModel
from .lm import LMModel


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda"
                ) -> LMModel:
    """The model for ``cfg`` with uninitialised parameters on ``device``
    (``LMModel.init`` draws them, ``LMModel.load_params`` copies them in):
    ``EncDecModel`` for the encdec family, ``HybridModel`` for the hybrid
    family, ``LMModel`` otherwise.  ``device="cuda"`` raises where there
    is no CUDA; ``"cpu"`` runs the plain PyTorch path."""
    if cfg.family == "encdec":
        return EncDecModel(cfg, device=device)
    if cfg.family == "hybrid":
        return HybridModel(cfg, device=device)
    return LMModel(cfg, device=device)


__all__ = ["build_model", "LMModel", "HybridModel", "EncDecModel"]
