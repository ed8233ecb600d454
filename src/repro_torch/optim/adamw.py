"""AdamW with model-dtype params and f32 moments and master copy.

The port of ``repro.optim.adamw``: the same update in the same order (clip
by global norm, bias-corrected moments, decoupled weight decay on the f32
master), over dicts of named tensors instead of pytrees.  Where the JAX
version returns new params and state, the port updates the state's f32
tensors and the params in place (under ``no_grad``, the params written from
the master in their own dtype), and returns them; the step counter is a
host integer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

Params = Mapping[str, torch.Tensor]
#: the ``torch.profiler`` range around ``adamw_update``
UPDATE_RANGE = "adamw.update"


@dataclasses.dataclass
class AdamWState:
    step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    master: Dict[str, torch.Tensor]   # f32 master weights (params may be bf16)


def adamw_init(params: Params) -> AdamWState:
    """Zero f32 moments and an f32 master copy of ``params``, on their
    devices.  The master never aliases a param, f32 ones included."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(
        step=0,
        mu={n: zeros(p) for n, p in params.items()},
        nu={n: zeros(p) for n, p in params.items()},
        master={n: p.detach().to(torch.float32, copy=True)
                for n, p in params.items()})


def clip_by_global_norm(grads: Params, max_norm: float,
                        reduce: Optional[Callable] = None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``grads`` scaled (in f32) so their global L2 norm is at most
    ``max_norm``, and that norm before scaling.  ``reduce`` maps the list
    of per-leaf sums of squares to the whole tensors' (a sharded step
    sums each over the ranks that split its leaf); they are added in leaf
    order."""
    sq = [torch.sum(torch.square(g.float())) for g in grads.values()]
    if reduce is not None:
        sq = reduce(sq)
    gnorm = torch.sqrt(sum(sq))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return {n: g.float() * scale for n, g in grads.items()}, gnorm


@torch.no_grad()
def adamw_update(grads: Params, state: AdamWState, params: Params,
                 lr: float, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 max_grad_norm: float = 1.0,
                 reduce: Optional[Callable] = None
                 ) -> Tuple[Params, AdamWState]:
    """One AdamW step over every name of ``params``; returns (params,
    state), both updated in place.  Runs under the profiler range
    ``UPDATE_RANGE``.  ``reduce``: as ``clip_by_global_norm`` takes it."""
    with torch.profiler.record_function(UPDATE_RANGE):
        grads, _ = clip_by_global_norm(grads, max_grad_norm, reduce)
        state.step += 1
        f32 = np.float32
        b1c = float(1 - f32(b1) ** f32(state.step))
        b2c = float(1 - f32(b2) ** f32(state.step))
        lr = float(lr)
        for name, p in params.items():
            g, m, v, w = grads[name], state.mu[name], state.nu[name], \
                state.master[name]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            upd = (m / b1c) / (torch.sqrt(v / b2c) + eps) + weight_decay * w
            w.copy_(w - lr * upd)
            p.copy_(w)                     # cast to the param's dtype
    return params, state
