"""``ServeConfig`` — one frozen dataclass describing a serving deployment.

The port's copy of ``repro.serve.config``, shared by the engine
(``ServeEngine(config)``), ``chip_smoke.py`` and the tests, with the JAX
package's ``use_pallas`` switch replaced by ``device`` ("cuda" by default,
"cpu" for the plain path).  The LM-only fields (``smoke``, ``prompt_len``,
``gen``, ``model_axis``) come with LM serving, and the CLI glue
(``add_args`` / ``from_args``) with the port of ``launch/serve.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: graph names the network-serving mode accepts (``repro.obs.smoke``'s set)
GRAPH_NAMES = ("tiny", "resnet50", "mobv3")

#: the serving default layout set: two layouts keep the planning lattice
#: small enough that a cold re-plan stays inside a request deadline while
#: still giving the DP a real layout-switching decision per boundary
DEFAULT_LAYOUTS = ("HWC_C32", "HWC_H32")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything the serve engine, CLI, benchmark and tests agree on.

    Exactly one of ``arch`` (LM serving: prefill + decode through the model
    stack) or ``graph`` (planned-network serving: ``PreparedNetwork``
    through the ``rir_matmul`` kernel on ``device``) selects the workload.
    The port serves planned networks only so far: ``arch=`` raises
    ``NotImplementedError``.  ``max_batch`` is
    the batch extent the plan is built at — the ceiling for dynamic batch
    assembly; ``assemble_max`` caps how many queued requests one batch may
    actually carry (``None`` = ``max_batch``; ``1`` is the sequential
    baseline the benchmark compares against — same plan, same padded
    shapes, no batching).
    """

    arch: Optional[str] = None          # LM mode: raises until it is ported
    graph: Optional[str] = None         # network mode: tiny|resnet50|mobv3
    max_batch: int = 4
    plan: Optional[str] = None          # pinned plan artifact path
    plan_deadline: float = 30.0         # seconds before degrading to fixed
    layouts: Optional[Tuple[str, ...]] = DEFAULT_LAYOUTS  # None = full space
    queue_capacity: int = 64            # bounded admission queue
    workers: int = 1                    # batch-assembly worker threads
    assemble_max: Optional[int] = None  # requests per batch; None = max_batch
    upgrade_interval_s: float = 1.0     # degraded-tier re-plan poll period
    device: str = "cuda"                # "cpu" runs the plain PyTorch path
    log_level: Optional[str] = None
    seed: int = 0                       # weights/params PRNG seed

    def __post_init__(self):
        if (self.arch is None) == (self.graph is None):
            raise ValueError("exactly one of arch= (LM serving) or graph= "
                             "(planned-network serving) must be set")
        if self.arch is not None:
            raise NotImplementedError(
                "LM serving is not ported yet: ROADMAP.md Queue 1 item 6 "
                "(dense and MoE LMs, with the LM serve backend)")
        if self.graph is not None and self.graph not in GRAPH_NAMES:
            raise ValueError(f"graph {self.graph!r} not in {GRAPH_NAMES}")
        if self.max_batch < 1 or self.queue_capacity < 1 or self.workers < 1:
            raise ValueError("max_batch, queue_capacity and workers must "
                             "be >= 1")
        if self.assemble_max is not None and not (
                1 <= self.assemble_max <= self.max_batch):
            raise ValueError(f"assemble_max {self.assemble_max} outside "
                             f"[1, max_batch={self.max_batch}]")

    @property
    def batch_limit(self) -> int:
        """Requests one assembled batch may carry."""
        return self.max_batch if self.assemble_max is None \
            else self.assemble_max
