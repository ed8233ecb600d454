"""AdamW with model-dtype params and f32 moments and master copy.

The port of ``repro.optim.adamw``: the same update in the same order (clip
by global norm, bias-corrected moments, decoupled weight decay on the f32
master), over dicts of named tensors instead of pytrees.  Where the JAX
version returns new params and state, the port updates the state's f32
tensors and the params in place (under ``no_grad``, the params written from
the master in their own dtype), and returns them; the step counter is a
host integer.

Under a mesh a parameter may carry a ZeRO-1 split of its state
(``p.zero1``, a ``distributed.sharding.DataBlock``, set by
``place_model``): its moments and master copy are then this rank's data
block (or, split on ``repro``'s layer axis, the layers this rank owns, and
nothing for the others), its gradient arrives as that block, and the
update writes the block cast to the parameter's dtype and all-gathers it
over the data group.
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


def _state_block(p: torch.Tensor) -> Optional[torch.Tensor]:
    """The part of ``p`` its state covers on this rank (None: none)."""
    block = getattr(p, "zero1", None)
    if block is None:
        return p.detach()
    if block.dim is None:
        return p.detach() if block.owns else None
    return block.take(p.detach())


def adamw_init(params: Params) -> AdamWState:
    """Zero f32 moments and an f32 master copy of ``params``, on their
    devices (of a parameter's ZeRO-1 block where it has one).  The master
    never aliases a param, f32 ones included."""
    blocks = {n: b for n, b in ((n, _state_block(p))
                                for n, p in params.items()) if b is not None}

    def zeros(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    return AdamWState(
        step=0,
        mu={n: zeros(t) for n, t in blocks.items()},
        nu={n: zeros(t) for n, t in blocks.items()},
        master={n: t.to(torch.float32, copy=True)
                for n, t in blocks.items()})


def clip_by_global_norm(grads: Params, max_norm: float,
                        reduce: Optional[Callable] = None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``grads`` scaled (in f32) so their global L2 norm is at most
    ``max_norm``, and that norm before scaling.  ``reduce`` maps the
    per-leaf sums of squares (by name) to a list of the whole tensors'
    (a sharded step sums each over the ranks that split its leaf); they
    are added in order."""
    sq = [torch.sum(torch.square(g.float())) for g in grads.values()]
    if reduce is not None:
        sq = reduce(dict(zip(grads, sq)))
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
    """One AdamW step over every name of ``grads`` (of ``params`` and
    ``state``); returns (params, state), both updated in place.  Runs
    under the profiler range ``UPDATE_RANGE``.  ``reduce``: as
    ``clip_by_global_norm`` takes it.

    Each leaf's arithmetic is ``repro``'s expression, ``m = b1 m + (1 -
    b1) g``, ``v = b2 v + (1 - b2) g g``, ``w -= lr ((m / b1c) / (sqrt(v /
    b2c) + eps) + wd w)``, op for op and rounded as the expression rounds
    it, but in place over two leaf-sized f32 temporaries (the expression
    held up to four), and each clipped gradient is dropped once its leaf
    is updated: a full-width MoE layer's 1e9-row embedding needed 4 GB
    more than one card had."""
    with torch.profiler.record_function(UPDATE_RANGE):
        grads, _ = clip_by_global_norm(grads, max_grad_norm, reduce)
        state.step += 1
        f32 = np.float32
        b1c = float(1 - f32(b1) ** f32(state.step))
        b2c = float(1 - f32(b2) ** f32(state.step))
        lr = float(lr)
        for name in list(grads):
            g = grads.pop(name)
            p, m, v, w = params[name], state.mu[name], state.nu[name], \
                state.master[name]
            t = torch.mul(g, 1 - b1)
            m.mul_(b1).add_(t)
            torch.mul(g, 1 - b2, out=t).mul_(g)
            v.mul_(b2).add_(t)
            del g
            torch.div(v, b2c, out=t).sqrt_().add_(eps)
            upd = torch.div(m, b1c).div_(t)
            upd.add_(torch.mul(w, weight_decay, out=t))
            w.sub_(upd.mul_(lr))
            del t, upd
            block = getattr(p, "zero1", None)
            if block is None or block.dim is None:
                p.copy_(w)                 # cast to the param's dtype
            else:
                p.copy_(block.whole(w.to(p.dtype)))
    return params, state
