"""The train step: loss, gradients, AdamW, on one device.

The port of ``repro.distributed.stepfn.make_train_step`` without its mesh:
the JAX step's ``hidden_sharding`` hook is a ``with_sharding_constraint``
that changes no number on one device, and it comes back with the mesh
(ROADMAP Queue 1 item 10).  The model holds its parameters, so the step
takes and returns the optimiser state only and updates the model in place.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.optim import AdamWState, adamw_update


def make_train_step(model, *, accum: int = 1, lr: float = 3e-4,
                    schedule: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``.

    ``model`` is an ``LMModel`` on its device; its parameters get gradients
    from here on.  ``batch`` is ``{"tokens": (B, T+1)}``, with ``"frames"``
    (B, Tenc, D) for an encoder-decoder (numpy or tensors), handed to
    ``model.loss``; ``accum`` > 1 splits it into that many microbatches
    and averages their f32 gradients, as the JAX step's ``lax.scan``
    does.
    The learning rate is ``schedule(opt_state.step)`` (the step count
    before this update) or ``lr``.  ``metrics``: ``{"loss": f32 scalar
    tensor on the model's device, "lr": float}``.
    """
    model.requires_grad_(True)
    params = model.params()
    names = list(params)
    leaves = [params[n] for n in names]

    def grads_of(mb: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, list]:
        loss = model.loss(mb)
        return loss, list(torch.autograd.grad(loss, leaves))

    def step(opt_state: AdamWState, batch: Mapping
             ) -> Tuple[AdamWState, Dict]:
        on_dev = {k: torch.as_tensor(batch[k], device=model.device)
                  for k in ("tokens", "frames") if k in batch}
        if accum == 1:
            loss, grads = grads_of(on_dev)
        else:
            B = on_dev["tokens"].shape[0]
            if B % accum:
                raise ValueError(f"batch {B} does not split into {accum} "
                                 f"microbatches")
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves]
            losses = []
            for i in range(accum):
                mb = {k: v[i * (B // accum):(i + 1) * (B // accum)]
                      for k, v in on_dev.items()}
                mb_loss, g = grads_of(mb)
                gsum = [a + b for a, b in zip(gsum, g)]
                losses.append(mb_loss.detach())
            grads = [g / accum for g in gsum]
            loss = torch.mean(torch.stack(losses))
        step_lr = schedule(opt_state.step) if schedule is not None else lr
        adamw_update(dict(zip(names, grads)), opt_state, params, step_lr)
        return opt_state, {"loss": loss.detach(), "lr": float(step_lr)}

    return step
