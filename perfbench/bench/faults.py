"""Faults planted in a training cell's timed path, underneath the harness:
``planted(name)`` patches the program for the length of a ``with`` and
gives the ``hook`` that ``train.run`` hands the built ``Program``.

* ``state_unchanged``: the step returns its state unchanged (AdamW skipped);
* ``half_batch``: half of each batch's sequences left out, the mean taken
  over the rest;
* ``scan_zeroed``: the scan's output (``ops.linear_scan``) zeroed;
* ``grad_scaled``: one leaf's gradient, as AdamW gets it, scaled by
  1 + ``SCALE``;
* ``bias_correction``: AdamW's bias correction taken at the step after;
* ``nan_loss``: the second step's loss reads NaN.
"""
from __future__ import annotations

import contextlib
import math

import torch

NAMES = ("state_unchanged", "half_batch", "scan_zeroed", "grad_scaled",
         "bias_correction", "nan_loss")
#: the leaf ``grad_scaled`` scales, and by how much more than 1
SCALED_LEAF = "layers.0.mixer.wr"
SCALE = 1e-2


@contextlib.contextmanager
def planted(name: str):
    from repro_torch.distributed import stepfn
    from repro_torch.kernels import ops

    if name not in NAMES:
        raise ValueError(f"no fault {name!r}: {NAMES}")
    update, scan = stepfn.adamw_update, ops.linear_scan

    def wrong_update(grads, state, params, lr, **kw):
        if name == "state_unchanged":
            return params, state
        if name == "grad_scaled":
            grads[SCALED_LEAF] = grads[SCALED_LEAF] * (1 + SCALE)
            return update(grads, state, params, lr, **kw)
        state.step += 1
        try:
            return update(grads, state, params, lr, **kw)
        finally:
            state.step -= 1

    def hook(prog) -> None:
        step, count = prog.step, [0]

        def wrong_step(opt, batch):
            count[0] += 1
            if name == "half_batch":
                t = batch["tokens"]
                batch = {"tokens": t[:max(1, t.shape[0] // 2)]}
            opt, m = step(opt, batch)
            if name == "nan_loss" and count[0] == 2:
                m = dict(m, loss=torch.full_like(m["loss"], math.nan))
            return opt, m
        prog.step = wrong_step

    try:
        if name in ("state_unchanged", "grad_scaled", "bias_correction"):
            stepfn.adamw_update = wrong_update
        if name == "scan_zeroed":
            ops.linear_scan = lambda *a: scan(*a) * 0
        yield hook
    finally:
        stepfn.adamw_update, ops.linear_scan = update, scan
