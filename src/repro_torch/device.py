"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` ("cuda" by default).  Asking
for CUDA where there is none raises: nothing quietly carries on on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device`` with its index; raise if unusable."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={str(device)!r} requested but CUDA is "
                               f"not available; pass device='cpu' to run the "
                               f"plain PyTorch path")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    elif d.type != "cpu":
        raise ValueError(f"device {str(device)!r}: only 'cuda' and 'cpu' run "
                         f"the port")
    return d
