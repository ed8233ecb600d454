"""repro_torch.serve — continuous-batching request serving for planned networks.

The port of ``repro.serve``: a bounded admission queue, dynamic batch
assembly up to the plan tile's batch extent (pad-and-mask, bit-identical to
sequential execution), a warm ``PlanCache`` shared across workers, and
background re-planning that upgrades degraded-tier plans to tier 1.  Each
batch runs through the ``rir_matmul`` kernel on ``ServeConfig.device``.

Import from ``repro_torch.api`` in application code; this package is the
implementation.
"""
from .config import DEFAULT_LAYOUTS, GRAPH_NAMES, ServeConfig
from .engine import (QueueFullError, ServeEngine, ServeError, ServeTicket,
                     build_graph)

__all__ = ["ServeConfig", "ServeEngine", "ServeTicket", "ServeError",
           "QueueFullError", "GRAPH_NAMES", "DEFAULT_LAYOUTS", "build_graph"]
