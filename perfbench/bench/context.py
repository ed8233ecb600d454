"""What a per-layer metric's reader is handed, and the arithmetic they share.

A reader (``metrics/<name>.py``) is ``read(ctx) -> float | None``: it takes
its number from the traced sub-window (``ctx.trace``) and the benchmark's
own count, and returns None where it finds nothing to read; the harness
then leaves the metric out of the result.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .spec import Cell, reader
from .trace import Trace


@dataclasses.dataclass
class Context:
    cell: Cell
    trace: Optional[Trace]
    batch: int              # the engine's batch extent (a step's sequences)
    #: a training run's steps a second over its measured window, untraced
    window_steps_per_s: Optional[float] = None

    @property
    def config(self) -> dict:
        return self.cell.config

    def ms_per_request(self, seconds: float) -> Optional[float]:
        """``seconds`` of the traced sub-window per request completed in it,
        in ms; None where either is nothing."""
        if self.trace is None or not self.trace.requests or seconds <= 0:
            return None
        return seconds * 1e3 / self.trace.requests

    def ms_per_step(self, seconds: float) -> Optional[float]:
        """``seconds`` of the traced steps per step, in ms; None where either
        is nothing."""
        if self.trace is None or not self.trace.steps or seconds <= 0:
            return None
        return seconds * 1e3 / self.trace.steps

    def per_layer(self) -> Dict[str, dict]:
        """Each reader's number; none where the trace saw no device work
        (a CPU run measures no device)."""
        out = {}
        if self.trace is None or not self.trace.events:
            return out
        for m in self.cell.per_layer:
            v = reader(m["name"])(self)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out
