"""``ServeConfig`` — one frozen dataclass describing a serving deployment.

The port's copy of ``repro.serve.config``, shared by the CLI
(``ServeConfig.add_args``/``from_args``, behind ``python -m
repro_torch.launch.serve``), the engine (``ServeEngine(config)``),
``chip_smoke.py`` and the tests, with the JAX package's ``use_pallas``
switch replaced by ``device`` ("cuda" by default, "cpu" for the plain
path; the CLI's ``--device``).  ``model_axis`` comes with the mesh
(ROADMAP Queue 1 item 10): the CLI takes ``--model-axis`` and raises
``NotImplementedError`` above 1.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple

from repro_torch.configs import get_config
from repro_torch.models.lm import check_family

#: graph names the network-serving mode accepts (``repro.obs.smoke``'s set)
GRAPH_NAMES = ("tiny", "resnet50", "mobv3")

#: the serving default layout set: two layouts keep the planning lattice
#: small enough that a cold re-plan stays inside a request deadline while
#: still giving the DP a real layout-switching decision per boundary
DEFAULT_LAYOUTS = ("HWC_C32", "HWC_H32")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything the serve engine, CLI, benchmark and tests agree on.

    Exactly one of ``arch`` (LM serving: prefill + greedy decode through
    the model stack, every decode step's attention through the
    ``gqa_decode`` kernel on ``device``) or ``graph`` (planned-network
    serving: ``PreparedNetwork`` through the ``rir_matmul`` kernel) selects
    the workload.  The port serves dense LMs, rwkv6 and the zamba2 hybrid
    so far: an ``arch`` of another family raises ``NotImplementedError``
    naming its ROADMAP item.
    ``max_batch`` is
    the batch extent the plan is built at — the ceiling for dynamic batch
    assembly; ``assemble_max`` caps how many queued requests one batch may
    actually carry (``None`` = ``max_batch``; ``1`` is the sequential
    baseline the benchmark compares against — same plan, same padded
    shapes, no batching).
    """

    arch: Optional[str] = None          # LM mode: a repro_torch.configs id
    graph: Optional[str] = None         # network mode: tiny|resnet50|mobv3
    smoke: bool = False                 # shrink the LM config for CI
    max_batch: int = 4
    prompt_len: int = 32                # LM: tokens every request carries
    gen: int = 16                       # LM: tokens generated per request
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
            check_family(get_config(self.arch, smoke=self.smoke))
            if self.prompt_len < 1 or self.gen < 1:
                raise ValueError("prompt_len and gen must be >= 1")
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

    # -------------------------------------------------------------- CLI glue
    @staticmethod
    def add_args(ap: argparse.ArgumentParser) -> None:
        """Install the serving flags (``repro.serve.config``'s, plus
        ``--device``) on an argparse parser."""
        ap.add_argument("--arch", default=None,
                        help="LM arch id (default llama3p2_3b unless "
                        "--graph is given)")
        ap.add_argument("--graph", default=None, choices=GRAPH_NAMES,
                        help="serve a planned conv network instead of an LM")
        ap.add_argument("--smoke", action="store_true")
        ap.add_argument("--batch", type=int, default=4, dest="max_batch",
                        help="plan batch extent = dynamic-batching ceiling")
        ap.add_argument("--prompt-len", type=int, default=32)
        ap.add_argument("--gen", type=int, default=16)
        ap.add_argument("--model-axis", type=int, default=1)
        ap.add_argument("--plan", default=None, metavar="PATH",
                        help="execution-plan artifact: load it if it "
                        "exists, else plan and save it there")
        ap.add_argument("--plan-deadline", type=float, default=30.0,
                        help="seconds plan resolution may spend before "
                        "degrading straight to a fixed-layout plan")
        ap.add_argument("--workers", type=int, default=1,
                        help="batch-assembly worker threads")
        ap.add_argument("--queue-capacity", type=int, default=64,
                        help="bounded request queue size (admission limit)")
        ap.add_argument("--log-level", default=None,
                        choices=["debug", "info", "warning", "error"],
                        help="console log threshold "
                        "(default: REPRO_LOG or info)")
        ap.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without CUDA) or cpu")

    @staticmethod
    def from_args(args: argparse.Namespace) -> "ServeConfig":
        """Build the config from parsed CLI args (LM mode by default)."""
        if args.model_axis > 1:
            raise NotImplementedError("--model-axis > 1: the mesh is not "
                                      "ported yet: ROADMAP.md Queue 1 "
                                      "item 10")
        arch = args.arch
        if arch is None and args.graph is None:
            arch = "llama3p2_3b"
        return ServeConfig(
            arch=arch, graph=args.graph, smoke=args.smoke,
            max_batch=args.max_batch, prompt_len=args.prompt_len,
            gen=args.gen, plan=args.plan,
            plan_deadline=args.plan_deadline, workers=args.workers,
            queue_capacity=args.queue_capacity, device=args.device,
            log_level=args.log_level)
