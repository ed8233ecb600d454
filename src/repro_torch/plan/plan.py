"""Serializable execution plans — the planner's output artifact.

An ``ExecutionPlan`` records, per layer, the planned ``(dataflow, layout,
reorder mode, kernel variant, epilogue permutation)`` plus predicted totals.
It round-trips losslessly through JSON, so a plan computed once (planning
sweeps the whole co-search space) can be shipped to the serving launcher and
executed without re-searching.  ``PlanCache`` memoizes plans keyed by
``(graph hash, eval-config fingerprint)`` with optional on-disk persistence.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
from typing import Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.core.dataflow import ConvWorkload, Dataflow
from repro_torch.core.layoutloop import EvalConfig
from repro_torch.runtime import faults
from repro_torch.runtime.retry import IO_POLICY, RetryPolicy, retry_call

log = obs.get_logger("plan")

# v2 added the planned on-chip tiling (``PlanStep.tiles`` + the dataflow's
# ``tiles`` coordinate); v3 adds the double-buffer choice
# (``PlanStep.double_buffer`` + ``Dataflow.double_buffer``) — the ping-pong
# tile pipeline that overlaps refetch with compute; v4 adds cross-layer
# fusion (``PlanStep.fused_with`` chains a step to its consumer, whose
# intermediate never touches DRAM) and the per-tensor buffer allocation
# (``PlanStep.buffer_alloc`` / ``Dataflow.buffer_alloc`` — which of
# iact/w/oact got a ping-pong pair) plus the modeled exposed-stall share
# (``PlanStep.dram_stall_cycles``).  Older artifacts load with the
# defaults: v1 steps get the whole-tensor tiling, v1/v2 steps are
# single-buffered, v1-v3 steps are unfused with the uniform split — all
# executing exactly as before.
PLAN_VERSION = 4
COMPAT_VERSIONS = (1, 2, 3, 4)
RIR_BLOCK = 128   # kernel feature-block granularity (MXU lane width)


# ------------------------------------------------------------- (de)serializers
def workload_to_dict(wl: ConvWorkload) -> Dict:
    return {"name": wl.name, "N": wl.N, "M": wl.M, "C": wl.C, "P": wl.P,
            "Q": wl.Q, "R": wl.R, "S": wl.S, "stride": wl.stride}


def workload_from_dict(d: Dict) -> ConvWorkload:
    return ConvWorkload(**d)


def dataflow_to_dict(df: Dataflow) -> Dict:
    return {"spatial": [list(p) for p in df.spatial],
            "order": list(df.order),
            "tiles": [list(p) for p in df.tiles],
            "double_buffer": df.double_buffer,
            "buffer_alloc": list(df.buffer_alloc),
            "name": df.name}


def dataflow_from_dict(d: Dict) -> Dataflow:
    return Dataflow(spatial=tuple((x, int(f)) for x, f in d["spatial"]),
                    order=tuple(d["order"]),
                    tiles=tuple((x, int(f)) for x, f in d.get("tiles", ())),
                    double_buffer=bool(d.get("double_buffer", False)),
                    buffer_alloc=tuple(d.get("buffer_alloc", ())),
                    name=d["name"])


def config_key(cfg: EvalConfig, extra: str = "") -> str:
    """Stable fingerprint of an evaluation config (+ planner options)."""
    return hashlib.sha256((repr(cfg) + "|" + extra).encode()).hexdigest()


def layout_block_perm(layout_name: str, n_blocks: int) -> Tuple[int, ...]:
    """Deterministic bijection: canonical feature block -> StaB bank slot.

    The planner's layouts are line-level descriptions; at kernel granularity
    (128-wide feature blocks) a boundary layout reduces to *which bank order
    the blocks are stored in*.  Producer epilogue and consumer weight prep
    just need to agree on one fixed bijection per layout; blocks are ranked
    by a keyed hash so distinct layouts induce distinct block orders.
    ``perm[j]`` = slot receiving canonical block ``j`` (the ``rir_matmul``
    epilogue convention).
    """
    if n_blocks <= 1:
        return tuple(range(max(n_blocks, 1)))
    ranked = sorted(range(n_blocks), key=lambda j: hashlib.sha256(
        f"{layout_name}:{j}".encode()).digest())
    perm = [0] * n_blocks
    for slot, block in enumerate(ranked):
        perm[block] = slot
    return tuple(perm)


# -------------------------------------------------------------------- the plan
@dataclasses.dataclass(frozen=True)
class JoinSpec:
    """A residual/skip join landing at this step's *output* boundary.

    ``src`` indexes the producing layer; its buffered activation is stored in
    ``src_layout`` (the boundary layout the planner chose for boundary
    ``src + 1``).  ``relayout`` is how the tensor is brought into this step's
    output layout: ``"none"`` when the boundaries already agree (the add
    fuses into the consumer's epilogue for free), otherwise the planner's
    residual reorder mode (``offchip`` / RAR variants / ``rir``), whose cost
    the search already charged.
    """

    src: int
    src_layout: str
    relayout: str = "none"

    def to_dict(self) -> Dict:
        return {"src": self.src, "src_layout": self.src_layout,
                "relayout": self.relayout}

    @staticmethod
    def from_dict(d: Dict) -> "JoinSpec":
        return JoinSpec(src=int(d["src"]), src_layout=d["src_layout"],
                        relayout=d["relayout"])


@dataclasses.dataclass(frozen=True)
class PlanStep:
    """One layer's planned execution."""

    layer: str
    workload: ConvWorkload
    dataflow: Dataflow
    in_layout: str                 # boundary layout the layer reads
    out_layout: str                # boundary layout its oActs are written in
    reorder: str                   # none|offchip|...|rir (how out_layout is made)
    kernel: str                    # 'rir_matmul' | 'ref'
    epilogue_perm: Optional[Tuple[int, ...]]   # None = identity / not GEMM-able
    cycles: float
    energy_pj: float
    lowering: str = "gemm"         # gemm | im2col | depthwise (K-side transform)
    joins: Tuple[JoinSpec, ...] = ()   # skip edges adding at the out boundary
    tiles: Tuple[Tuple[str, int], ...] = ()   # planned on-chip tiling (v2)
    double_buffer: bool = False    # ping-pong tile buffers planned (v3)
    buffer_alloc: Tuple[str, ...] = ()   # per-tensor ping-pong subset (v4)
    fused_with: Optional[int] = None   # next-layer index this step fuses into
    dram_stall_cycles: float = 0.0     # modeled exposed-stall share (v4)

    def to_dict(self) -> Dict:
        return {"layer": self.layer,
                "workload": workload_to_dict(self.workload),
                "dataflow": dataflow_to_dict(self.dataflow),
                "in_layout": self.in_layout, "out_layout": self.out_layout,
                "reorder": self.reorder, "kernel": self.kernel,
                "epilogue_perm": (list(self.epilogue_perm)
                                  if self.epilogue_perm is not None else None),
                "cycles": self.cycles, "energy_pj": self.energy_pj,
                "lowering": self.lowering,
                "joins": [j.to_dict() for j in self.joins],
                "tiles": [list(p) for p in self.tiles],
                "double_buffer": self.double_buffer,
                "buffer_alloc": list(self.buffer_alloc),
                "fused_with": self.fused_with,
                "dram_stall_cycles": self.dram_stall_cycles}

    @staticmethod
    def from_dict(d: Dict) -> "PlanStep":
        # v1 steps carry no "tiles" key: fall back to the dataflow's tiling
        # (empty in v1 artifacts == the default whole-tensor tiling); v1/v2
        # steps carry no "double_buffer" and load single-buffered; v1-v3
        # steps carry no "buffer_alloc"/"fused_with" and load as
        # uniform-split unfused
        tiles = d.get("tiles", d["dataflow"].get("tiles", ()))
        db = d.get("double_buffer", d["dataflow"].get("double_buffer", False))
        fused = d.get("fused_with")
        return PlanStep(
            layer=d["layer"], workload=workload_from_dict(d["workload"]),
            dataflow=dataflow_from_dict(d["dataflow"]),
            in_layout=d["in_layout"], out_layout=d["out_layout"],
            reorder=d["reorder"], kernel=d["kernel"],
            epilogue_perm=(tuple(int(p) for p in d["epilogue_perm"])
                           if d["epilogue_perm"] is not None else None),
            cycles=float(d["cycles"]), energy_pj=float(d["energy_pj"]),
            lowering=d.get("lowering", "gemm"),
            joins=tuple(JoinSpec.from_dict(j) for j in d.get("joins", ())),
            tiles=tuple((x, int(f)) for x, f in tiles),
            double_buffer=bool(db),
            buffer_alloc=tuple(
                d.get("buffer_alloc", d["dataflow"].get("buffer_alloc", ()))),
            fused_with=int(fused) if fused is not None else None,
            dram_stall_cycles=float(d.get("dram_stall_cycles", 0.0)))


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A whole-network schedule: per-layer steps + predicted totals."""

    graph_name: str
    graph_hash: str
    config_key: str
    objective: str                 # cycles | edp
    planner: str                   # 'network-dp' | 'greedy' | 'fixed' | ...
    steps: Tuple[PlanStep, ...]
    total_cycles: float
    total_energy_pj: float
    transition_cycles: float = 0.0   # part of total spent on boundary reorders
    version: int = PLAN_VERSION

    def __len__(self) -> int:
        return len(self.steps)

    @property
    def plan_id(self) -> str:
        """Short stable provenance id — the ``(graph_hash, config_key)``
        digest trace spans carry so a measured interval can be joined back
        to exactly one plan artifact."""
        return hashlib.sha256(
            f"{self.graph_hash}|{self.config_key}".encode()).hexdigest()[:16]

    def boundary_layouts(self) -> List[str]:
        """[input layout of layer 0, out layout of each layer] — the DP path."""
        if not self.steps:
            return []
        return [self.steps[0].in_layout] + [s.out_layout for s in self.steps]

    def switch_count(self) -> int:
        return sum(1 for s in self.steps if s.in_layout != s.out_layout)

    # ------------------------------------------------------------- round trip
    def to_json(self, indent: int = 2) -> str:
        d = {"version": self.version, "graph_name": self.graph_name,
             "graph_hash": self.graph_hash, "config_key": self.config_key,
             "objective": self.objective, "planner": self.planner,
             "total_cycles": self.total_cycles,
             "total_energy_pj": self.total_energy_pj,
             "transition_cycles": self.transition_cycles,
             "steps": [s.to_dict() for s in self.steps]}
        return json.dumps(d, indent=indent)

    @staticmethod
    def from_json(text: str) -> "ExecutionPlan":
        d = json.loads(text)
        if d.get("version") not in COMPAT_VERSIONS:
            raise ValueError(f"plan version {d.get('version')} not in "
                             f"{COMPAT_VERSIONS}")
        return ExecutionPlan(
            graph_name=d["graph_name"], graph_hash=d["graph_hash"],
            config_key=d["config_key"], objective=d["objective"],
            planner=d["planner"],
            steps=tuple(PlanStep.from_dict(s) for s in d["steps"]),
            total_cycles=float(d["total_cycles"]),
            total_energy_pj=float(d["total_energy_pj"]),
            transition_cycles=float(d.get("transition_cycles", 0.0)),
            version=int(d["version"]))

    def save(self, path: str | pathlib.Path) -> None:
        """Atomic write: temp file + rename, so a crash mid-write (the
        ``plan.save`` fault site fires between the two) always leaves the
        previous artifact loadable — never a half-written plan."""
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_name(p.name + ".tmp")
        tmp.write_text(self.to_json())
        faults.site(faults.PLAN_SAVE)
        os.replace(tmp, p)

    @staticmethod
    def load(path: str | pathlib.Path) -> "ExecutionPlan":
        faults.site(faults.PLAN_LOAD)
        return ExecutionPlan.from_json(pathlib.Path(path).read_text())

    def summary(self) -> str:
        lines = [f"plan[{self.planner}] {self.graph_name}: "
                 f"{len(self.steps)} layers, {self.switch_count()} layout "
                 f"switches, total {self.total_cycles:.3e} cycles "
                 f"({self.transition_cycles:.3e} on transitions), "
                 f"{self.total_energy_pj:.3e} pJ"]
        for s in self.steps:
            lines.append(
                f"  {s.layer:22s} df={s.dataflow.label():12s} "
                f"{s.in_layout:12s}->{s.out_layout:12s} "
                f"reorder={s.reorder:8s} kernel={s.kernel}")
        return "\n".join(lines)


# ------------------------------------------------------------------ plan cache
class PlanCache:
    """Memoize plans by (graph hash, config fingerprint).

    In-memory by default; pass ``directory`` to persist artifacts as JSON so
    later processes (e.g. the serving launcher) skip planning entirely.

    Robustness contract: ``get`` never raises and never returns a plan for a
    different (graph, config).  Disk reads/writes go through the
    ``plan_cache.io`` fault site under retry (``io_policy``), so transient
    I/O faults are absorbed; a *persistently* failing read is just a miss
    (``plan_cache.io_error``).  A corrupt or identity-mismatched artifact is
    **quarantined** — moved aside into ``<dir>/quarantine/`` for postmortem
    instead of silently deleted — and treated as a miss.

    With observability enabled (``repro.obs``), every lookup lands in the
    ``plan_cache.*`` counters: hits by tier (``mem``/``disk``), misses,
    evictions/quarantines by reason (``corrupt``/``mismatch``), and I/O
    failures — the numbers behind any claim that serving hides planning
    latency behind the cache.
    """

    def __init__(self, directory: str | pathlib.Path | None = None, *,
                 io_policy: RetryPolicy = IO_POLICY,
                 sleep=None):
        self._mem: Dict[Tuple[str, str], ExecutionPlan] = {}
        self._dir = pathlib.Path(directory) if directory else None
        self._io_policy = io_policy
        self._sleep = sleep
        if self._dir:
            self._dir.mkdir(parents=True, exist_ok=True)

    def _path(self, key: Tuple[str, str]) -> Optional[pathlib.Path]:
        if not self._dir:
            return None
        return self._dir / f"plan-{key[0][:16]}-{key[1][:16]}.json"

    def _retry(self, fn):
        kw = {} if self._sleep is None else {"sleep": self._sleep}
        return retry_call(fn, site=faults.PLAN_CACHE_IO, policy=self._io_policy,
                          **kw)

    def _quarantine(self, p: pathlib.Path, reason: str) -> None:
        """Move a bad artifact aside (keep it for postmortem); never raise."""
        try:
            qdir = p.parent / "quarantine"
            qdir.mkdir(exist_ok=True)
            target = qdir / p.name
            n = 0
            while target.exists():
                n += 1
                target = qdir / f"{p.name}.{n}"
            os.replace(p, target)
            log.warning("quarantined %s artifact %s -> %s", reason, p, target)
        except OSError:
            p.unlink(missing_ok=True)   # quarantine is best-effort
        obs.inc_counter("plan_cache.evict", reason=reason)
        obs.inc_counter("plan_cache.quarantined", reason=reason)

    def get(self, graph_hash: str, cfg_key: str) -> Optional[ExecutionPlan]:
        """Cached plan for the FULL ``(graph_hash, cfg_key)``, or ``None``.

        The on-disk filename only encodes truncated hashes, so a loaded
        artifact is re-validated against the full key: a corrupt/unreadable
        file or one whose recorded identity mismatches (hash collision,
        hand-edited artifact) is quarantined and treated as a miss.
        """
        key = (graph_hash, cfg_key)
        if key in self._mem:
            obs.inc_counter("plan_cache.hit", tier="mem")
            return self._mem[key]
        p = self._path(key)
        if p and p.exists():
            try:
                plan = self._retry(lambda: self._disk_load(p))
            except (ValueError, KeyError, TypeError):
                self._quarantine(p, "corrupt")
                obs.inc_counter("plan_cache.miss")
                return None
            except faults.STEP_FAULT_TYPES as e:
                # persistent I/O failure: the file may be fine, the disk is
                # not — miss without quarantining, the planner covers for it
                obs.inc_counter("plan_cache.io_error", op="get")
                obs.inc_counter("plan_cache.miss")
                log.warning("plan cache read failed (%s: %s); re-planning",
                            type(e).__name__, e)
                return None
            if (plan.graph_hash, plan.config_key) != key:
                self._quarantine(p, "mismatch")
                obs.inc_counter("plan_cache.miss")
                return None
            self._mem[key] = plan
            obs.inc_counter("plan_cache.hit", tier="disk")
            return plan
        obs.inc_counter("plan_cache.miss")
        return None

    def _disk_load(self, p: pathlib.Path) -> ExecutionPlan:
        faults.site(faults.PLAN_CACHE_IO)
        return ExecutionPlan.load(p)

    def _disk_store(self, plan: ExecutionPlan, p: pathlib.Path) -> None:
        faults.site(faults.PLAN_CACHE_IO)
        plan.save(p)

    def put(self, plan: ExecutionPlan) -> None:
        """Cache a plan; the disk write is retried and, if it persistently
        fails, *dropped* (the in-memory tier still serves it) — a full disk
        must never take serving down."""
        key = (plan.graph_hash, plan.config_key)
        self._mem[key] = plan
        obs.inc_counter("plan_cache.put")
        p = self._path(key)
        if p:
            try:
                self._retry(lambda: self._disk_store(plan, p))
            except faults.STEP_FAULT_TYPES as e:
                obs.inc_counter("plan_cache.io_error", op="put")
                log.warning("plan cache write failed (%s: %s); serving from "
                            "memory only", type(e).__name__, e)

    def get_or_plan(self, graph, cfg: EvalConfig, planner_fn,
                    extra_key: str = "") -> ExecutionPlan:
        """Return the cached plan for (graph, cfg) or compute via planner_fn."""
        ck = config_key(cfg, extra_key)
        hit = self.get(graph.graph_hash(), ck)
        if hit is not None:
            return hit
        with obs.span("plan_cache.plan") as sp:
            sp.set("graph", getattr(graph, "name", "?"))
            plan = planner_fn(graph, cfg)
        self.put(plan)
        return plan
