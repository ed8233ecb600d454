"""Carry the JAX package's conv-network parameters into the port's tensors.

The input is what ``init_graph_weights`` returns (per-layer numpy arrays,
identical in both packages for one seed), ``np.asarray`` of a jax array, or
anything ``torch.as_tensor`` takes; each weight is checked against
``weight_shape(wl)`` (a 1x1 layer may come squeezed as ``(C, M)``) and each
bias against ``(M,)``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.dataflow import ConvWorkload
from repro_torch.core.workloads import weight_shape
from repro_torch.device import resolve_device


def to_torch_weights(weights: Sequence, biases: Optional[Sequence] = None, *,
                     layers: Sequence[ConvWorkload],
                     device: str | torch.device = "cuda"
                     ) -> Tuple[List[torch.Tensor],
                                Optional[List[Optional[torch.Tensor]]]]:
    """``(weights, biases)`` as float32 tensors on ``device``, shape-checked
    against ``layers``; ``biases`` stays None when not given."""
    dev = resolve_device(device)
    if len(weights) != len(layers):
        raise ValueError(f"{len(weights)} weights for {len(layers)} layers")
    if biases is not None and len(biases) != len(layers):
        raise ValueError(f"{len(biases)} biases for {len(layers)} layers")
    ws = []
    for wl, w in zip(layers, weights):
        shape = weight_shape(wl)
        got = tuple(np.shape(w))
        if got != shape and not (wl.R == wl.S == 1 and got == shape[-2:]):
            raise ValueError(f"layer {wl.name}: weight shape {got} != "
                             f"{shape}")
        ws.append(torch.as_tensor(np.asarray(w, np.float32)).to(dev))
    if biases is None:
        return ws, None
    bs: List[Optional[torch.Tensor]] = []
    for wl, b in zip(layers, biases):
        if b is None:
            bs.append(None)
            continue
        if tuple(np.shape(b)) != (wl.M,):
            raise ValueError(f"layer {wl.name}: bias shape "
                             f"{tuple(np.shape(b))} != ({wl.M},)")
        bs.append(torch.as_tensor(np.asarray(b, np.float32)).to(dev))
    return ws, bs
