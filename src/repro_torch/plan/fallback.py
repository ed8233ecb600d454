"""Degradation ladder: always return *a* plan, never crash for lack of one.

``resolve_plan`` walks four tiers, cheapest-to-obtain first, stopping at the
first that yields a valid plan for ``(graph, cfg)``:

====  ===========  ==========================================================
tier  name         source
====  ===========  ==========================================================
0     cached       plan cache (memory, then disk) and/or a pinned artifact
                   path — zero planning latency
1     replanned    full DP/Viterbi co-search (``NetworkPlanner.plan``) —
                   the planner is deterministic, so a tier-1 plan is
                   byte-identical to the cached artifact it replaces and
                   execution outputs are bit-identical
2     greedy       ``NetworkPlanner.greedy`` — local boundary choices, no DP
                   table; an approximation, still a *valid* plan
3     fixed        one network-wide layout, no search at all
                   (``NetworkPlanner.fixed``) — the floor; always succeeds
                   if the graph itself is executable
====  ===========  ==========================================================

Each tier's work runs under ``retry_call`` (exponential backoff,
deterministic jitter), so transient faults are absorbed *within* a tier
before the ladder descends.  ``deadline_s`` bounds the whole resolution: once
past the deadline the expensive tiers are skipped straight to ``fixed`` — a
serving request's latency budget beats a better plan.

Only tier-1 (replanned) results are written back to the cache/artifact:
greedy and fixed plans share the same ``(graph_hash, config_key)`` as the
full plan, and caching them would poison every future request with a
degraded plan.  The chosen tier lands in the ``degrade.tier{level=}``
counter — the number behind any claim about how often serving degrades —
and a degraded ``ResolvedPlan`` carries the machine-readable ``reason``
(which tiers failed and why) for span attribution.

``upgrade_plan`` is the ladder's ascent: a tier-1-only attempt that returns
``None`` instead of descending, so a serving loop holding a degraded plan
can retry in the background and swap in the full plan once the planner
recovers (``ServeEngine`` drives this).
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Callable, List, Optional

from repro_torch import obs
from repro_torch.core.layout import Layout
from repro_torch.core.layoutloop import EvalConfig
from repro_torch.runtime import faults
from repro_torch.runtime.retry import DEFAULT_POLICY, RetryPolicy, retry_call

from .graph import LayerGraph
from .plan import ExecutionPlan, PlanCache, config_key
from .search import NetworkPlanner, PlannerOptions

log = obs.get_logger("plan.fallback")

TIER_NAMES = ("cached", "replanned", "greedy", "fixed")


@dataclasses.dataclass(frozen=True)
class ResolvedPlan:
    """A plan plus which ladder tier produced it.

    ``reason`` is the machine-readable degradation record: one
    ``"tier: cause"`` clause per tier that was tried and failed (or skipped
    on deadline) before this plan was obtained, ``;``-joined in ladder
    order, empty for an undegraded (tier <= 1, no-failure) resolution.
    Serving surfaces it on span attributes so a trace can distinguish a
    deadline-miss from a fault-injection degradation without re-running
    anything.
    """

    plan: ExecutionPlan
    tier: int
    reason: str = ""

    @property
    def tier_name(self) -> str:
        return TIER_NAMES[self.tier]

    @property
    def degraded(self) -> bool:
        """True when serving got anything less than the full DP plan."""
        return self.tier > 1


def _default_fixed_layout(opts: PlannerOptions) -> Layout:
    if opts.layouts:
        return opts.layouts[0]
    return Layout.parse("HWC_C32")


def resolve_plan(graph: LayerGraph, cfg: EvalConfig,
                 opts: Optional[PlannerOptions] = None, *,
                 cache: Optional[PlanCache] = None,
                 artifact: Optional[str | pathlib.Path] = None,
                 extra_key: Optional[str] = None,
                 deadline_s: Optional[float] = None,
                 policy: RetryPolicy = DEFAULT_POLICY,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 planner_fn: Optional[Callable[..., ExecutionPlan]] = None,
                 greedy_fn: Optional[Callable[..., ExecutionPlan]] = None,
                 default_layout: Optional[Layout] = None,
                 save_back: bool = True) -> ResolvedPlan:
    """Resolve a plan for ``(graph, cfg)`` down the degradation ladder.

    ``artifact`` optionally names a pinned plan JSON (e.g. serving's
    ``--plan``); it seeds the cache if it matches the requested identity.
    ``extra_key`` defaults to ``opts.key()`` — the same fingerprint the
    planner records in its plans, so cache lookups and planner output agree.
    ``planner_fn``/``greedy_fn`` override the tier-1/tier-2 planners
    (``(graph, cfg, opts) -> ExecutionPlan``) — the tests' fault hooks.
    Never raises for tiers 0–2; only the final ``fixed`` tier propagates
    failure (at that point there is no cheaper plan to degrade to).
    """
    opts = opts or PlannerOptions()
    ghash = graph.graph_hash()
    ck = config_key(cfg, opts.key() if extra_key is None else extra_key)
    t_deadline = None if deadline_s is None else clock() + deadline_s
    fails: List[str] = []   # one "tier: cause" clause per failed/skipped tier

    def past_deadline() -> bool:
        return t_deadline is not None and clock() >= t_deadline

    def _retry(fn, site):
        return retry_call(fn, site=site, policy=policy, sleep=sleep,
                          clock=clock, deadline=t_deadline)

    def _done(plan: ExecutionPlan, tier: int) -> ResolvedPlan:
        obs.inc_counter("degrade.tier", level=TIER_NAMES[tier])
        reason = "; ".join(fails) if tier > 1 else ""
        if tier > 0:
            log.warning("plan resolved at tier %d (%s) for %s%s",
                        tier, TIER_NAMES[tier], plan.graph_name,
                        f" ({reason})" if reason else "")
        if tier == 1:
            # only the FULL plan is worth persisting — greedy/fixed plans
            # share the cache key and would poison future requests
            if cache is not None:
                cache.put(plan)
            if save_back and artifact is not None:
                try:
                    _retry(lambda: plan.save(pathlib.Path(artifact)),
                           site=faults.PLAN_SAVE)
                except Exception as e:   # noqa: BLE001 — save-back is best-effort
                    log.warning("plan save-back failed (%s: %s)",
                                type(e).__name__, e)
        return ResolvedPlan(plan=plan, tier=tier, reason=reason)

    # ---- tier 0: cached -------------------------------------------------
    if artifact is not None and cache is not None:
        p = pathlib.Path(artifact)
        if p.exists():
            try:
                pinned = _retry(lambda: ExecutionPlan.load(p),
                                site=faults.PLAN_LOAD)
                if (pinned.graph_hash, pinned.config_key) == (ghash, ck):
                    cache.put(pinned)
                else:
                    log.warning("pinned plan %s is for a different "
                                "(graph, config); ignoring", p)
            except Exception as e:   # noqa: BLE001 — a bad artifact is a miss
                obs.inc_counter("plan.artifact_error",
                                type=type(e).__name__)
                fails.append(f"cached: {type(e).__name__}: {e}")
                log.warning("pinned plan %s unreadable (%s: %s); falling "
                            "through the ladder", p, type(e).__name__, e)
    if cache is not None:
        plan = cache.get(ghash, ck)   # never raises
        if plan is not None:
            return _done(plan, 0)

    # ---- tier 1: full re-plan -------------------------------------------
    if past_deadline():
        fails.append("replanned: deadline exceeded")
    else:
        try:
            def _full() -> ExecutionPlan:
                faults.site(faults.PLAN_REPLAN)   # injection point: planner down
                if planner_fn is not None:
                    return planner_fn(graph, cfg, opts)
                return NetworkPlanner(graph, cfg, opts).plan()
            plan = _retry(_full, site=faults.PLAN_REPLAN)
            return _done(plan, 1)
        except Exception as e:   # noqa: BLE001 — ladder absorbs, descends
            fails.append(f"replanned: {type(e).__name__}: {e}")
            log.warning("full re-plan failed (%s: %s); degrading to greedy",
                        type(e).__name__, e)

    # ---- tier 2: greedy --------------------------------------------------
    if past_deadline():
        fails.append("greedy: deadline exceeded")
    else:
        try:
            if greedy_fn is not None:
                plan = _retry(lambda: greedy_fn(graph, cfg, opts),
                              site=faults.PLAN_GREEDY)
            else:
                plan = _retry(
                    lambda: NetworkPlanner(graph, cfg, opts).greedy(),
                    site=faults.PLAN_GREEDY)
            return _done(plan, 2)
        except Exception as e:   # noqa: BLE001
            fails.append(f"greedy: {type(e).__name__}: {e}")
            log.warning("greedy plan failed (%s: %s); degrading to fixed",
                        type(e).__name__, e)

    # ---- tier 3: fixed layout (the floor; failure propagates) ------------
    layout = default_layout or _default_fixed_layout(opts)
    reduced = dataclasses.replace(opts, search_tiles=False,
                                  double_buffer=False)
    plan = NetworkPlanner(graph, cfg, reduced).fixed(layout)
    return _done(plan, 3)


def upgrade_plan(graph: LayerGraph, cfg: EvalConfig,
                 opts: Optional[PlannerOptions] = None, *,
                 cache: Optional[PlanCache] = None,
                 artifact: Optional[str | pathlib.Path] = None,
                 extra_key: Optional[str] = None,
                 policy: RetryPolicy = DEFAULT_POLICY,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 planner_fn: Optional[Callable[..., ExecutionPlan]] = None,
                 save_back: bool = True) -> Optional[ResolvedPlan]:
    """One tier-1-only rung of the ladder: re-plan, or report not-yet.

    The background re-planner's primitive: where ``resolve_plan`` descends
    to a cheaper tier when the full planner fails, ``upgrade_plan`` returns
    ``None`` instead — the caller keeps serving its degraded plan and tries
    again later, so a request admitted at a degraded tier upgrades itself
    to tier 1 once the planner recovers without ever blocking the serving
    loop.  A cache hit counts as success (another worker may have planned
    it first — the warm ``PlanCache`` tier is shared); a fresh tier-1 plan
    is cached and saved back exactly like ``resolve_plan``'s tier 1.
    """
    opts = opts or PlannerOptions()
    ghash = graph.graph_hash()
    ck = config_key(cfg, opts.key() if extra_key is None else extra_key)
    if cache is not None:
        plan = cache.get(ghash, ck)   # only tier-1 results are ever cached
        if plan is not None:
            obs.inc_counter("degrade.tier", level=TIER_NAMES[0])
            return ResolvedPlan(plan=plan, tier=0)

    def _replan() -> ExecutionPlan:
        faults.site(faults.PLAN_REPLAN)   # same injection point as resolve_plan
        if planner_fn is not None:
            return planner_fn(graph, cfg, opts)
        return NetworkPlanner(graph, cfg, opts).plan()

    try:
        plan = retry_call(_replan, site=faults.PLAN_REPLAN, policy=policy,
                          sleep=sleep, clock=clock)
    except Exception as e:   # noqa: BLE001 — not-yet, the caller retries later
        log.warning("plan upgrade attempt failed (%s: %s); still degraded",
                    type(e).__name__, e)
        obs.inc_counter("plan.upgrade_failed", type=type(e).__name__)
        return None
    obs.inc_counter("degrade.tier", level=TIER_NAMES[1])
    if cache is not None:
        cache.put(plan)
    if save_back and artifact is not None:
        try:
            retry_call(lambda: plan.save(pathlib.Path(artifact)),
                       site=faults.PLAN_SAVE, policy=policy, sleep=sleep,
                       clock=clock)
        except Exception as e:   # noqa: BLE001 — save-back is best-effort
            log.warning("plan save-back failed (%s: %s)",
                        type(e).__name__, e)
    return ResolvedPlan(plan=plan, tier=1)
