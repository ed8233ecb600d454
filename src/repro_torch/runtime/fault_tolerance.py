"""Fault tolerance: heartbeats, elastic re-meshing, straggler mitigation.

Designed for 1000+ node fleets; the mechanisms are host-count agnostic and
exercised in tests with simulated failures:

* ``HeartbeatRegistry`` — liveness tracking with configurable timeout; the
  supervisor polls it between steps (cheap: one monotonic read per host).
  Hosts can ``register``/``forget`` after construction, so a re-meshed or
  recovered host reports alive again; ``sync_to_plan`` reconciles the
  tracked set to an ``ElasticPlan``'s surviving hosts.  ``beat`` routes
  through the ``heartbeat`` fault site and *absorbs* injected faults — a
  dropped liveness packet is a missed beat, never a crash.
* ``plan_elastic_mesh`` — given the surviving host set, choose the largest
  (data, model) mesh that keeps the model axis intact (TP groups must be
  co-located; DP width shrinks), and report the batch re-sharding plan.
  Checkpoints store logical shardings, so restore-on-new-mesh is exact.
* ``StragglerMonitor`` — per-step duration EWMA + tail detection; hosts
  slower than ``threshold x`` the fleet median for ``patience`` consecutive
  steps are flagged for eviction (the supervisor then treats them as failed —
  eviction beats waiting at scale).
* ``TrainSupervisor`` — the restart loop: run steps, on failure back off
  (exponential + jitter, shared ``RetryPolicy`` shape), restore the latest
  checkpoint onto the re-planned mesh and continue.  The restart budget is a
  sliding window (``restart_window_s``): old restarts age out, so a fleet
  that hiccups once a day is not killed by a lifetime cap, while a crash
  loop still exhausts the budget fast.  The data pipeline is a pure function
  of (seed, step, shard), so no data state is lost.

The port's copy of ``repro.runtime.fault_tolerance`` (no jax), changed
only in its imports.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch import obs

from . import faults
from .faults import STEP_FAULT_TYPES
from .retry import RetryPolicy


class HeartbeatRegistry:
    def __init__(self, hosts: Sequence[str], timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self._last: Dict[str, float] = {h: clock() for h in hosts}

    def register(self, host: str) -> None:
        """Start tracking ``host`` (fresh arrival counts as alive now)."""
        self._last[host] = self.clock()

    def forget(self, host: str) -> None:
        """Stop tracking ``host`` (evicted / re-meshed away)."""
        self._last.pop(host, None)

    def hosts(self) -> Set[str]:
        return set(self._last)

    def sync_to_plan(self, plan: "ElasticPlan") -> None:
        """Reconcile the tracked set to an elastic re-mesh: hosts the plan
        dropped are forgotten, hosts it (re)introduced start alive — the
        recovered-host path that used to be impossible without
        ``register``."""
        used = set(plan.hosts_used)
        for h in self.hosts() - used:
            self.forget(h)
        for h in used - self.hosts():
            self.register(h)

    def beat(self, host: str) -> None:
        try:
            faults.site(faults.HEARTBEAT)
        except STEP_FAULT_TYPES as e:
            # an injected fault here models a lost liveness packet: the beat
            # is dropped (the host will look dead if drops persist), the
            # reporting path itself never crashes
            obs.inc_counter("heartbeat.dropped", type=type(e).__name__)
            return
        self._last[host] = self.clock()

    def alive(self) -> Set[str]:
        now = self.clock()
        return {h for h, t in self._last.items()
                if now - t <= self.timeout_s}

    def dead(self) -> Set[str]:
        return set(self._last) - self.alive()


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    hosts_used: Tuple[str, ...]
    dropped_batch_shards: int

    @property
    def chips(self) -> int:
        return self.data * self.model


def plan_elastic_mesh(alive_hosts: Sequence[str], chips_per_host: int,
                      model_axis: int, old_data_axis: int) -> ElasticPlan:
    """Largest (data, model) mesh from survivors, keeping model groups whole.

    model-axis groups must be intact (TP collectives are latency-critical),
    so hosts are consumed in model-group quanta; the data axis shrinks to the
    largest power of two that the surviving chips support (power-of-two DP
    keeps gradient all-reduce butterflies regular).
    """
    alive = sorted(alive_hosts)
    total_chips = len(alive) * chips_per_host
    max_data = total_chips // model_axis
    if max_data < 1:
        raise RuntimeError("not enough hosts for one model group")
    data = 2 ** int(math.log2(max_data))
    used_chips = data * model_axis
    hosts_needed = math.ceil(used_chips / chips_per_host)
    return ElasticPlan(data=data, model=model_axis,
                       hosts_used=tuple(alive[:hosts_needed]),
                       dropped_batch_shards=old_data_axis - data)


class StragglerMonitor:
    def __init__(self, threshold: float = 1.5, patience: int = 3,
                 ewma: float = 0.7):
        self.threshold = threshold
        self.patience = patience
        self.ewma = ewma
        self._avg: Dict[str, float] = {}
        self._strikes: Dict[str, int] = {}

    def record(self, host: str, step_seconds: float) -> None:
        prev = self._avg.get(host, step_seconds)
        self._avg[host] = self.ewma * prev + (1 - self.ewma) * step_seconds

    def stragglers(self) -> Set[str]:
        if len(self._avg) < 2:
            return set()
        vals = sorted(self._avg.values())
        n = len(vals)
        # true median: even host counts average the two middle elements —
        # taking the upper-middle element skews the threshold toward the
        # slow host, so on a 2-host fleet the slow host could never exceed
        # 1.5x "the median" (itself) and a genuine straggler went unflagged
        med = vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1] + vals[n // 2])
        out = set()
        for h, v in self._avg.items():
            if v > self.threshold * med:
                self._strikes[h] = self._strikes.get(h, 0) + 1
            else:
                self._strikes[h] = 0
            if self._strikes.get(h, 0) >= self.patience:
                out.add(h)
        return out


@dataclasses.dataclass
class TrainSupervisor:
    """Checkpoint/restart orchestration (mesh-agnostic, tested in-process).

    run(): executes ``step_fn(step) -> metrics`` until ``total_steps``;
    ``failure_detector()`` is polled between steps; on failure the supervisor
    backs off (exponential + deterministic jitter per ``backoff``), calls
    ``restart_fn()`` (rebuild mesh + restore checkpoint) and continues from
    the restored step.

    The restart budget: with ``restart_window_s=None`` (default) at most
    ``max_restarts`` over the run's lifetime — the original behaviour.  With
    a window, only restarts inside the trailing ``restart_window_s`` seconds
    count, so isolated faults spread over a long run never exhaust the
    budget but a tight crash loop still does.

    With observability on, every recovery lands in counters: ``train.faults``
    labeled by exception type, ``train.restarts`` labeled by cause
    (``fault`` vs ``detector``), plus a ``train.backoff_s`` histogram — the
    data behind any claim about how often the fleet actually falls over.
    """
    total_steps: int
    step_fn: Callable[[int], Dict]
    save_every: int
    save_fn: Callable[[int], None]
    restore_fn: Callable[[], int]            # returns step to resume from
    failure_detector: Callable[[], bool]
    restart_fn: Callable[[], None]
    max_restarts: int = 8
    restart_window_s: Optional[float] = None   # None = lifetime budget
    backoff: RetryPolicy = RetryPolicy(max_attempts=1, base_delay_s=0.05,
                                       max_delay_s=5.0, jitter=0.25)
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    seed: int = 0
    _restart_times: List[float] = dataclasses.field(
        default_factory=list, init=False, repr=False)

    def _recent_restarts(self) -> int:
        if self.restart_window_s is None:
            return len(self._restart_times)
        now = self.clock()
        self._restart_times = [t for t in self._restart_times
                               if now - t <= self.restart_window_s]
        return len(self._restart_times)

    def _budget_ok(self) -> bool:
        return self._recent_restarts() < self.max_restarts

    def _recover(self, cause: str, rng: random.Random) -> int:
        """Back off, restart, note the restart; returns the restored step."""
        recent = self._recent_restarts()
        obs.inc_counter("train.restarts", cause=cause)
        self._restart_times.append(self.clock())
        delay = self.backoff.delay_s(recent, rng.random())
        if delay > 0:
            obs.observe("train.backoff_s", delay)
            self.sleep(delay)
        self.restart_fn()
        return self.restore_fn()

    def run(self, start_step: int = 0) -> Tuple[int, List[Dict]]:
        step = start_step
        restarts = 0
        history: List[Dict] = []
        rng = random.Random(f"{self.seed}:train.restart")
        self._restart_times = []
        while step < self.total_steps:
            if self.failure_detector():
                if not self._budget_ok():
                    raise RuntimeError("restart budget exhausted")
                restarts += 1
                step = self._recover("detector", rng)
                continue
            try:
                metrics = self.step_fn(step)
            except STEP_FAULT_TYPES as e:
                obs.inc_counter("train.faults", type=type(e).__name__)
                if not self._budget_ok():
                    raise
                restarts += 1
                step = self._recover("fault", rng)
                continue
            history.append(metrics)
            step += 1
            if step % self.save_every == 0:
                self.save_fn(step)
        return restarts, history
