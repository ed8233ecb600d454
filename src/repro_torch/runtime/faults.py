"""Deterministic, seed-driven fault injection for the plan→execute→serve stack.

Production serving must never crash for lack of a plan — only degrade to a
cheaper plan tier whose cost the model already quantifies.  This module is
how that claim gets *tested*: named choke points (``site(...)``) are threaded
through every layer that touches disk, dispatches kernels, or reports
liveness, and a ``FaultSchedule`` armed over them raises realistic runtime
faults exactly where a flaky fleet would.  The same discipline as
``repro.obs``: with no schedule armed every ``site()`` call is a strict
no-op — one module-global load and a ``None`` test, no dict lookup, no
allocation (wall-time guarded in ``tests/test_faults.py``).

Site contract
-------------
These names are the stable contract between the injector, the hardened code,
and the chaos smoke (``python -m repro.runtime.chaos``).  Tests rely on them.
The machine-readable registry is ``SITES`` (injectable sites, each with an
exported ``PLAN_LOAD``-style constant) and ``RETRY_SITES`` (the superset
``repro.runtime.retry`` call sites may label themselves with); the table
below is generated from it and ``repro_torch.check`` lints every
``faults.site(...)`` / ``retry_call(site=...)`` literal of the port against
the registry.

-- generated by `python -m repro_torch.check docs --write`; do not edit --
================= =========================================================
site              fires inside
================= =========================================================
``plan.load``     ``ExecutionPlan.load`` — plan artifact read/parse
``plan.save``     ``ExecutionPlan.save`` — between the temp-file write and
                  the atomic rename (the kill-mid-write point)
``plan_cache.io`` ``PlanCache`` disk reads (``get``) and writes (``put``)
``plan.replan``   the tier-1 full re-plan inside ``resolve_plan`` /
                  ``upgrade_plan``, before the planner runs — "the
                  planner fleet is down" for the degradation ladder
``exec.dispatch`` the plan executors, once per plan step, immediately
                  before the kernel dispatch (``PreparedNetwork.__call__``
                  and ``PreparedPlan.__call__``)
``ckpt.write``    ``checkpoint.save_pytree`` — between the fully-written
                  temp directory (COMMIT included) and the atomic rename
``ckpt.read``     ``checkpoint.restore_pytree`` — before manifest/array
                  reads and the sha256 integrity check
``heartbeat``     ``HeartbeatRegistry.beat`` — an injected fault here is a
                  *dropped* liveness packet (the registry absorbs it; the
                  host simply fails to report alive)
``serve.queue``   ``ServeEngine.submit`` — request admission; an injected
                  fault here surfaces as a typed ``QueueFullError``
                  backpressure rejection (reason ``"fault"``), never an
                  unhandled escape: clients back off and resubmit
``plan.greedy``   retry label for the tier-2 greedy planner fallback
                  (no injection choke point; ``plan.replan`` is the
                  injectable stage of the same ladder)
================= =========================================================
-- end generated --

Schedule format
---------------
A ``FaultSchedule`` is ``(seed, {site_name: SiteSpec})``.  Each ``SiteSpec``
is either

* **count mode** (``count=N``): fire on the first ``N`` visits to the site
  (after skipping the first ``after`` visits) — fully deterministic, the mode
  the chaos smoke uses so "every scheduled fault was injected" is an exact
  counter equality; or
* **probability mode** (``p=q``): an independent draw per visit from a
  per-site ``random.Random`` seeded with ``f"{seed}:{site}"`` — deterministic
  for a given (seed, visit sequence), different across seeds.

``exc`` names the exception type raised, one of ``FAULT_EXC_TYPES``
(exactly the ``STEP_FAULT_TYPES`` the recovery layers treat as
machine/runtime faults).  Every injected exception carries
``.injected = True`` (see ``is_injected``) and lands in the
``faults.injected{site=}`` obs counter.

Usage::

    from repro_torch.runtime import faults
    sched = faults.FaultSchedule(seed=0, sites={
        "plan.load": faults.SiteSpec(count=1, exc="OSError")})
    with faults.injecting(sched):
        ...   # exercise the stack; recovery paths absorb the faults
    assert sched.all_fired()
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
from typing import Dict, Iterator, Optional

from repro_torch import obs

# Failure types the recovery layers (retry, degradation ladder, supervisor)
# treat as node/runtime faults: XLA device errors surface as RuntimeError,
# collective timeouts as TimeoutError, host/network/filesystem loss as
# ConnectionError/OSError.  Anything else (TypeError, ValueError, assertion
# failures, ...) is a bug and must propagate instead of being retried as if
# a machine had died.  Canonical home is here; ``runtime.fault_tolerance``
# re-exports it.
STEP_FAULT_TYPES = (RuntimeError, TimeoutError, ConnectionError, OSError)

FAULT_EXC_TYPES: Dict[str, type] = {
    "RuntimeError": RuntimeError,
    "TimeoutError": TimeoutError,
    "ConnectionError": ConnectionError,
    "OSError": OSError,
}

# ------------------------------------------------------------- site registry
# Exported constants for every injectable choke point.  Hardened code passes
# these to ``site()`` / ``retry_call(site=...)`` instead of re-typing the
# string; ``repro_torch.check`` flags any literal that does not resolve here.
PLAN_LOAD = "plan.load"
PLAN_SAVE = "plan.save"
PLAN_CACHE_IO = "plan_cache.io"
PLAN_REPLAN = "plan.replan"
EXEC_DISPATCH = "exec.dispatch"
CKPT_WRITE = "ckpt.write"
CKPT_READ = "ckpt.read"
HEARTBEAT = "heartbeat"
SERVE_QUEUE = "serve.queue"
# retry-only site: the tier-2 greedy planner is retried but has no
# ``site()`` choke point of its own (the injectable one is ``plan.replan``)
PLAN_GREEDY = "plan.greedy"

# site -> where it fires (the generated docstring table renders from this)
_SITE_DOCS: Dict[str, str] = {
    PLAN_LOAD:
        "``ExecutionPlan.load`` — plan artifact read/parse",
    PLAN_SAVE:
        "``ExecutionPlan.save`` — between the temp-file write and\n"
        "the atomic rename (the kill-mid-write point)",
    PLAN_CACHE_IO:
        "``PlanCache`` disk reads (``get``) and writes (``put``)",
    PLAN_REPLAN:
        "the tier-1 full re-plan inside ``resolve_plan`` /\n"
        "``upgrade_plan``, before the planner runs — \"the\n"
        "planner fleet is down\" for the degradation ladder",
    EXEC_DISPATCH:
        "the plan executors, once per plan step, immediately\n"
        "before the kernel dispatch (``PreparedNetwork.__call__``\n"
        "and ``PreparedPlan.__call__``)",
    CKPT_WRITE:
        "``checkpoint.save_pytree`` — between the fully-written\n"
        "temp directory (COMMIT included) and the atomic rename",
    CKPT_READ:
        "``checkpoint.restore_pytree`` — before manifest/array\n"
        "reads and the sha256 integrity check",
    HEARTBEAT:
        "``HeartbeatRegistry.beat`` — an injected fault here is a\n"
        "*dropped* liveness packet (the registry absorbs it; the\n"
        "host simply fails to report alive)",
    SERVE_QUEUE:
        "``ServeEngine.submit`` — request admission; an injected\n"
        "fault here surfaces as a typed ``QueueFullError``\n"
        "backpressure rejection (reason ``\"fault\"``), never an\n"
        "unhandled escape: clients back off and resubmit",
}

_RETRY_ONLY_SITE_DOCS: Dict[str, str] = {
    PLAN_GREEDY:
        "retry label for the tier-2 greedy planner fallback\n"
        "(no injection choke point; ``plan.replan`` is the\n"
        "injectable stage of the same ladder)",
}

#: Every injectable fault site.  ``FaultSchedule`` rejects names outside it.
SITES = frozenset(_SITE_DOCS)

#: Every name ``retry_call(site=...)`` may use in ``src/`` (lint-enforced).
RETRY_SITES = SITES | frozenset(_RETRY_ONLY_SITE_DOCS)


def render_site_table() -> str:
    """The generated docstring table (``python -m repro_torch.check
    docs``)."""
    rows = list(_SITE_DOCS.items()) + list(_RETRY_ONLY_SITE_DOCS.items())
    left = max(len(f"``{name}``") for name, _ in rows)
    bar = "=" * left + " " + "=" * 57
    out = [bar, "site".ljust(left) + " fires inside", bar]
    for name, doc in rows:
        lines = doc.split("\n")
        out.append(f"``{name}``".ljust(left) + " " + lines[0])
        out.extend(" " * (left + 1) + ln for ln in lines[1:])
    out.append(bar)
    return "\n".join(out)


class UnknownSiteError(ValueError):
    """A ``FaultSchedule`` named a site outside the ``SITES`` registry —
    the schedule would silently never fire, so it is rejected up front."""


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """What one site injects: count mode (exact) or probability mode."""

    count: int = 0            # fire on the first `count` eligible visits
    p: float = 0.0            # else: independent per-visit probability
    exc: str = "RuntimeError"
    after: int = 0            # skip the first `after` visits entirely
    message: str = ""

    def __post_init__(self):
        if self.exc not in FAULT_EXC_TYPES:
            raise ValueError(f"exc {self.exc!r} not in "
                             f"{sorted(FAULT_EXC_TYPES)}")
        if self.count < 0 or not (0.0 <= self.p <= 1.0) or self.after < 0:
            raise ValueError(f"invalid SiteSpec {self!r}")


class FaultSchedule:
    """Seeded per-site fault plan; tracks visits and injections.

    Thread-safe: the checkpoint writer thread and the main thread may hit
    sites concurrently; per-site counts stay exact under a lock (the lock is
    only ever taken while a schedule is armed).
    """

    def __init__(self, seed: int = 0,
                 sites: Optional[Dict[str, SiteSpec]] = None):
        self.seed = seed
        self.sites: Dict[str, SiteSpec] = dict(sites or {})
        unknown = sorted(set(self.sites) - SITES)
        if unknown:
            raise UnknownSiteError(
                f"unknown fault site(s) {unknown}; registered sites are "
                f"{sorted(SITES)}")
        self._visits: Dict[str, int] = {}
        self._injected: Dict[str, int] = {}
        self._rngs = {name: random.Random(f"{seed}:{name}")
                      for name in self.sites}
        self._lock = threading.Lock()

    def visit(self, name: str) -> None:
        """One pass through site ``name``; raises if the schedule says so."""
        spec = self.sites.get(name)
        with self._lock:
            self._visits[name] = v = self._visits.get(name, 0) + 1
            if spec is None or v <= spec.after:
                return
            if spec.count:
                fire = self._injected.get(name, 0) < spec.count
            else:
                fire = spec.p > 0.0 and self._rngs[name].random() < spec.p
            if not fire:
                return
            self._injected[name] = n = self._injected.get(name, 0) + 1
        obs.inc_counter("faults.injected", site=name)
        err = FAULT_EXC_TYPES[spec.exc](
            spec.message or f"injected {spec.exc} at site {name!r} (#{n})")
        err.injected = True
        raise err

    # ------------------------------------------------------------- inspection
    def visits(self, name: str) -> int:
        return self._visits.get(name, 0)

    def injected(self, name: str) -> int:
        return self._injected.get(name, 0)

    def total_injected(self) -> int:
        return sum(self._injected.values())

    def all_fired(self) -> bool:
        """True when every count-mode site reached its scheduled count."""
        return all(self.injected(name) >= spec.count
                   for name, spec in self.sites.items() if spec.count)

    def summary(self) -> Dict[str, Dict[str, int]]:
        return {name: {"scheduled": spec.count,
                       "visits": self.visits(name),
                       "injected": self.injected(name)}
                for name, spec in sorted(self.sites.items())}


# ------------------------------------------------------------- process state
_schedule: Optional[FaultSchedule] = None


def site(name: str) -> None:
    """A named choke point.  Strict no-op unless a schedule is armed."""
    s = _schedule
    if s is not None:
        s.visit(name)


def arm(schedule: FaultSchedule) -> None:
    global _schedule
    _schedule = schedule


def disarm() -> None:
    global _schedule
    _schedule = None


def is_armed() -> bool:
    return _schedule is not None


def current() -> Optional[FaultSchedule]:
    return _schedule


@contextlib.contextmanager
def injecting(schedule: FaultSchedule) -> Iterator[FaultSchedule]:
    """Arm ``schedule`` for the body; always disarm on exit."""
    arm(schedule)
    try:
        yield schedule
    finally:
        disarm()


def is_injected(exc: BaseException) -> bool:
    """True when ``exc`` was raised by this module (not a real fault)."""
    return getattr(exc, "injected", False)
