"""Retry with exponential backoff and deterministic jitter.

One helper, ``retry_call``, shared by every layer that talks to flaky
substrates: ``PlanCache`` disk I/O, plan-artifact load/save, checkpoint
write/restore, the degradation ladder's plan tiers, and the chaos smoke's
kernel re-dispatch.  Only ``STEP_FAULT_TYPES`` (machine/runtime faults) are
retried — a ``ValueError`` from a corrupt artifact is a *content* problem
and must surface to the caller's quarantine path immediately, not burn
retries.

Observability: each absorbed failure lands in ``retry.attempts{site=}`` and
a final give-up in ``retry.exhausted{site=}`` — the counters behind any
claim about how flaky the substrate actually is.  Jitter is drawn from a
``random.Random(f"{seed}:{site}")`` so backoff sequences are reproducible
run-to-run (the chaos smoke depends on this); pass ``sleep=`` to make tests
instant.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, TypeVar

from repro_torch import obs

from .faults import STEP_FAULT_TYPES

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape: ``min(max_delay, base * 2**k) * (1 + jitter * u)``."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.25              # fraction of the delay, u ~ U[0, 1)
    fault_types: Tuple[type, ...] = STEP_FAULT_TYPES

    def delay_s(self, failure_index: int, u: float = 0.0) -> float:
        """Backoff after the ``failure_index``-th (0-based) failure."""
        d = min(self.max_delay_s, self.base_delay_s * (2 ** failure_index))
        return d * (1.0 + self.jitter * u)


DEFAULT_POLICY = RetryPolicy()

# artifact/cache I/O wants to fail fast (a serving request is waiting):
# short base delay, few attempts — persistent failure degrades instead
IO_POLICY = RetryPolicy(max_attempts=3, base_delay_s=0.01, max_delay_s=0.25)


def retry_call(fn: Callable[[], T], *, site: str,
               policy: RetryPolicy = DEFAULT_POLICY,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic,
               deadline: Optional[float] = None,
               seed: int = 0) -> T:
    """Call ``fn`` with up to ``policy.max_attempts`` attempts.

    ``site`` labels the counters (use the fault-site name when the retried
    body contains one).  ``deadline`` is an absolute ``clock()`` value: a
    backoff sleep that would land past it is skipped and the last failure
    re-raised — a serving request's latency budget beats one more retry.
    Exceptions outside ``policy.fault_types`` propagate immediately.
    """
    rng = random.Random(f"{seed}:{site}")
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except policy.fault_types as e:
            last = e
            obs.inc_counter("retry.attempts", site=site)
            if attempt == policy.max_attempts - 1:
                break
            delay = policy.delay_s(attempt, rng.random())
            if deadline is not None and clock() + delay > deadline:
                break
            sleep(delay)
    obs.inc_counter("retry.exhausted", site=site)
    assert last is not None
    raise last
