"""One run of one cell: set up, warm up, measure, check, report.

Set-up draws the weights and the input pool from the seed on the device,
builds ``repro_torch``'s ``ServeEngine`` on the configuration's layer graph
(its plan pinned in ``cache/plans/``: a cell's first run in a checkout plans
and writes it, later runs load it), and warms the engine on the one batch
shape it serves.  The window then offers the cell's traffic for
``seconds``.  Every admitted request has to be answered, in the window or
in the minute after it; a sample of the answers, drawn from the seed with
every answer equally likely to be in it, is kept, and once the engine is
freed each sampled answer is held to the plain reference (``reference.py``,
fp32 with TF32 off) for its input.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import gc
import math
import os
import pathlib
import queue
import resource
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import count, reference, traffic as traffic_mod
from .spec import HERE, Cell

#: how long after the window's close an answer may still come
DRAIN_S = 60.0
#: the traced sub-window: its length, and the profiler's lead before it
TRACE_S = 5.0
TRACE_LEAD_S = 0.5
#: warm-up rounds, each as many full batches as the engine has workers
WARM_ROUNDS = 1
#: the longest a closed loop may take to ramp up before its window opens
RAMP_S = 120.0
#: a pause between two answers longer than this ends a burst: a batch's
#: answers are handed out within a few milliseconds of each other
BURST_GAP = 0.010
#: reference inputs a block
REF_BLOCK = 32
#: answers sampled for the reference check, and the seed's sub-stream that
#: draws them (the inputs and weights draw from the card's generator,
#: seeded with the seed itself; arrivals use sub-stream 1)
SAMPLE = 256
SAMPLE_STREAM = 2


@dataclasses.dataclass
class Overrides:
    """What a test on the CPU shrinks; a chip run uses none of it."""

    max_batch: Optional[int] = None
    pool: Optional[int] = None
    outstanding: Optional[int] = None
    queue_capacity: Optional[int] = None
    cache_dir: Optional[pathlib.Path] = None


class Answers:
    """Every answer's completion, and a sample of the answers drawn from the
    seed: a reservoir, in which each answer served is equally likely to be
    held, whatever the order in which they come."""

    def __init__(self, seed: int, size: int = SAMPLE):
        self.rng = np.random.default_rng([seed, SAMPLE_STREAM])
        self.size = size
        self.sample: List[Tuple[int, np.ndarray]] = []   # (input, answer)
        self.seen = 0
        self.unserved = 0          # admitted, and errored or never came
        self.done: List[float] = []   # completion times (perf_counter)

    def keep(self, index: int, out) -> None:
        """Offer the answer for input ``index`` to the sample."""
        if self.seen < self.size:
            self.sample.append((index, np.array(out, copy=True)))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.sample[j] = (index, np.array(out, copy=True))
        self.seen += 1

    def take(self, index: int, ticket, deadline: float) -> Optional[float]:
        """Wait for ``ticket``'s answer; offer it to the sample; its
        completion time."""
        try:
            out = ticket.result(timeout=max(deadline - time.perf_counter(),
                                            1e-3))
        except Exception:   # noqa: BLE001 — an error or a timeout: unserved
            self.unserved += 1
            return None
        t = time.perf_counter()
        self.done.append(t)
        self.keep(index, out)
        return t


def process_start() -> float:
    """This process's start on the ``perf_counter`` clock (10 ms grain)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return now - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


# ------------------------------------------------------------------ set-up
def weight_shapes(config: dict) -> List[tuple]:
    return [(L["R"], L["S"], L["M"]) if count.is_depthwise(L)
            else (L["R"], L["S"], L["C"], L["M"]) for L in config["layers"]]


def make_inputs(config: dict, pool: int, seed: int, device: str):
    """The weights (on ``device``) and the input pool (on the host), from
    ``seed``, drawn on ``device`` in two calls: normals over the layer's
    fan-in, and inputs of the configuration's ``input`` shape zero-padded to
    the first layer's H x W."""
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = weight_shapes(config)
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    weights, o = [], 0
    for L, shp, n in zip(config["layers"], shapes, sizes):
        fan_in = L["R"] * L["S"] * (1 if count.is_depthwise(L) else L["C"])
        weights.append(flat[o:o + n].view(shp) / math.sqrt(fan_in))
        o += n
    h, w, c = config["input"]
    L0 = config["layers"][0]
    H, W = count.in_extent(L0, "P"), count.in_extent(L0, "Q")
    imgs = torch.randn((pool, h, w, c), generator=g, device=device)
    imgs = torch.nn.functional.pad(
        imgs, (0, 0, (W - w) // 2, W - w - (W - w) // 2,
               (H - h) // 2, H - h - (H - h) // 2))
    return weights, imgs.cpu().contiguous()


#: ``ServeConfig.graph`` selects the engine's network mode and names one of
#: its built-in graphs; the engine serves the graph it is handed instead
NETWORK_MODE = "tiny"


def layer_graph(config: dict):
    """The configuration's layers and residual edges as the program's
    layer graph, each layer one ``ConvWorkload``."""
    from repro_torch.core.dataflow import ConvWorkload
    from repro_torch.plan import from_layers

    layers = [ConvWorkload(N=1, M=L["M"], C=L["C"], P=L["P"], Q=L["Q"],
                           R=L["R"], S=L["S"], stride=L["stride"],
                           name=L["name"]) for L in config["layers"]]
    return from_layers(layers, name=config["name"],
                       skip_edges=[tuple(e) for e in config["skip_edges"]])


def build_engine(config: dict, traffic: dict, weights, device: str,
                 ov: Overrides):
    from repro_torch import obs
    from repro_torch.api import ServeConfig, ServeEngine

    batch = ov.max_batch or config["max_batch"]
    plans = (ov.cache_dir or HERE / "cache") / "plans"
    plans.mkdir(parents=True, exist_ok=True)
    cfg = ServeConfig(
        graph=NETWORK_MODE, max_batch=batch, workers=config["workers"],
        queue_capacity=ov.queue_capacity or traffic["queue_capacity"],
        device=device, plan=str(plans / f"{config['name']}-b{batch}.json"))
    eng = ServeEngine(cfg, graph=layer_graph(config), weights=weights)
    if eng.resolved.tier > 1:
        raise RuntimeError(f"plan resolved at tier {eng.resolved.tier} "
                           f"({eng.resolved.tier_name}): it would upgrade "
                           f"itself inside the window")
    if obs.enabled():
        raise RuntimeError("the program's tracing (obs) is on: it fences "
                           "every layer")
    return eng


def warm(eng, pool: torch.Tensor, batch: int, workers: int) -> None:
    n = batch * workers
    for r in range(WARM_ROUNDS):
        tickets = [eng.submit(pool[(r * n + i) % len(pool)])
                   for i in range(n)]
        for t in tickets:
            t.result(timeout=600)


# ------------------------------------------------------------------ traffic
class Window:
    """The measured window's end, which a closed loop's client reads: none
    until the loop has ramped up (its first ``outstanding`` answers came)
    and the window opens."""

    def __init__(self, t_end: float = math.inf):
        self.t_end = t_end
        self.ramped = threading.Event()

    def deadline(self) -> float:
        """When an answer still due counts as never served."""
        return self.t_end + DRAIN_S if math.isfinite(self.t_end) \
            else time.perf_counter() + RAMP_S + DRAIN_S


def closed_loop(eng, pool, outstanding: int, window: Window, ans: Answers,
                sent: List[int]) -> None:
    """Keep ``outstanding`` requests in the engine until the window closes;
    wait for every answer."""
    from repro_torch.api import QueueFullError

    pending = collections.deque()

    def submit(i: int) -> None:
        while True:
            try:
                pending.append((i % len(pool), eng.submit(pool[i % len(pool)])))
                return
            except QueueFullError as e:    # retried, not a failure
                if e.reason == "stopped":
                    raise
                time.sleep(1e-4)

    for i in range(outstanding):
        submit(i)
    n = outstanding
    while pending:
        index, ticket = pending.popleft()
        ans.take(index, ticket, window.deadline())
        if len(ans.done) + ans.unserved >= outstanding:
            window.ramped.set()
        if time.perf_counter() < window.t_end:
            submit(n)
            n += 1
    window.ramped.set()
    sent.append(n)


def answered(done: List[float], a: float, b: float,
             gap: float = BURST_GAP) -> Tuple[int, float]:
    """The rate at which answers came in the window [a, b], as (answers,
    seconds).  A batch's answers come together, in a burst; a burst ends at
    an answer that the next one follows by more than ``gap`` seconds.  The
    count runs over the whole bursts from the last one that ended at or
    before ``a`` to the last one that ended at or before ``b``, and the
    seconds between those two ends: a count over [a, b] alone moves by a
    whole batch with the phase at which the window opens.  Where fewer than
    two bursts end in reach, the answers in [a, b] over its seconds."""
    ts = sorted(done)
    ends = [t for k, t in enumerate(ts)
            if k == len(ts) - 1 or ts[k + 1] - t > gap]
    i = bisect.bisect_right(ends, a) - 1
    j = bisect.bisect_right(ends, b) - 1
    if i < 0 or j <= i:
        return (bisect.bisect_right(ts, b) - bisect.bisect_left(ts, a),
                b - a)
    n = bisect.bisect_right(ts, ends[j]) - bisect.bisect_right(ts, ends[i])
    return n, ends[j] - ends[i]


def open_loop(eng, pool, sched: np.ndarray, t0: float, ans: Answers,
              latency: np.ndarray, late: List[float]) -> Callable[[], None]:
    """Start the generator and the collector; return a join."""
    from repro_torch.api import QueueFullError

    q: "queue.Queue" = queue.Queue()
    deadline = t0 + (sched[-1] if len(sched) else 0.0) + DRAIN_S

    def generate() -> None:
        for k, at in enumerate(sched):
            target = t0 + at
            delay = target - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            late.append(time.perf_counter() - target)
            try:
                q.put((k, target, eng.submit(pool[k % len(pool)])))
            except QueueFullError:
                q.put((k, target, None))
        q.put(None)

    def collect() -> None:
        while True:
            item = q.get()
            if item is None:
                return
            k, target, ticket = item
            if ticket is None:
                continue        # rejected: stays at +inf
            done = ans.take(k % len(pool), ticket, deadline)
            if done is not None:
                latency[k] = done - target

    threads = [threading.Thread(target=f, name=f"perfbench-{f.__name__}",
                                daemon=True) for f in (generate, collect)]
    for t in threads:
        t.start()

    def join() -> None:
        for t in threads:
            t.join(timeout=deadline - time.perf_counter() + 5.0)
            if t.is_alive():
                raise RuntimeError(f"{t.name} did not finish")
    return join


# ------------------------------------------------------------------ checks
def reference_check(config: dict, weights, pool: torch.Tensor,
                    ans: Answers, device: str,
                    tf32: bool = False) -> float:
    """The worst relative error of the sampled answers against the
    reference: max |answer - reference| over max |reference|, per answer."""
    worst = 0.0
    for i in range(0, len(ans.sample), REF_BLOCK):
        block = ans.sample[i:i + REF_BLOCK]
        want = reference.forward(config, weights,
                                 pool[[j for j, _ in block]].to(device),
                                 tf32=tf32)
        got = torch.from_numpy(np.stack([a for _, a in block])
                               ).to(device)
        err = (got - want).abs().flatten(1).amax(1)
        scale = want.abs().flatten(1).amax(1)
        worst = max(worst, float((err / scale).max()))
    return worst


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, or the JAX package's."""
    bad = {"jax", "jaxlib", "flax", "repro"}
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in bad)


# ------------------------------------------------------------------ the run
@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    checks: Dict[str, dict]
    correct: bool
    metrics: Dict[str, dict]
    device: dict
    breakdown: Optional[dict]
    notes: List[str]


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        ov: Optional[Overrides] = None,
        hook: Optional[Callable] = None,
        stamps: Optional[List[Tuple[str, float]]] = None) -> Outcome:
    """Run ``cell`` once.  ``hook(engine)``, if given, is called once the
    engine is built (the fault tests plant their faults there); ``stamps``
    are (phase, end) times of the set-up before the call.  A training
    configuration (``"kind": "lm_train"``) runs ``train.run`` instead."""
    if cell.config.get("kind") == "lm_train":
        from . import train
        return train.run(cell, seed, seconds, trace, device=device,
                         t_start=t_start, hook=hook, stamps=stamps)
    from .context import Context

    ov = ov or Overrides()
    t_start = process_start() if t_start is None else t_start
    config, tr = cell.config, cell.traffic
    batch = ov.max_batch or config["max_batch"]
    pool_n = ov.pool or tr["pool"]
    notes: List[str] = []
    cuda = device.startswith("cuda")

    stamps = [("process start", t_start)] + list(stamps or []) + \
        [("set-up's start", time.perf_counter())]
    weights, pool = make_inputs(config, pool_n, seed, device)
    stamps.append(("inputs", time.perf_counter()))
    eng = build_engine(config, tr, weights, device, ov)
    stamps.append(("engine", time.perf_counter()))
    notes.append(f"plan tier {eng.resolved.tier} "
                 f"({eng.resolved.tier_name}) {eng.resolved.plan.plan_id}")
    if hook is not None:
        hook(eng)
    if trace:
        warm_profiler()
    ans = Answers(seed)
    prof = None
    window = None
    try:
        eng.start()
        warm(eng, pool, batch, config["workers"])
        if cuda:
            torch.cuda.synchronize()
        stamps.append(("warm-up", time.perf_counter()))
        sched = traffic_mod.arrivals(tr, seconds, seed)
        sent: List[int] = []
        late: List[float] = []
        latency = None
        if sched is None:
            # the closed loop runs from before the window: it opens on an
            # engine already as full as the traffic keeps it
            loop = Window()
            client = threading.Thread(
                target=closed_loop, name="perfbench-client",
                args=(eng, pool, ov.outstanding or tr["outstanding"], loop,
                      ans, sent), daemon=True)
            client.start()
            if not loop.ramped.wait(timeout=RAMP_S):
                raise RuntimeError("the closed loop did not ramp up")
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        stamps.append(("ramp", t0))
        notes.append("set-up s: " + ", ".join(
            f"{name} {b - a:.3f}" for (_, a), (name, b)
            in zip(stamps, stamps[1:])))
        t_end = t0 + seconds
        if sched is None:
            loop.t_end = t_end

            def join() -> None:
                client.join(timeout=seconds + DRAIN_S + 5.0)
                if client.is_alive():
                    raise RuntimeError("the client did not finish")
        else:
            latency = np.full(len(sched), np.inf)
            join = open_loop(eng, pool, sched, t0, ans, latency, late)
        if trace:
            prof, window = traced_window(t0, seconds)
        join()
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        notes.append(f"host in the window and drain: user "
                     f"{ru1.ru_utime - ru0.ru_utime:.3f} s, sys "
                     f"{ru1.ru_stime - ru0.ru_stime:.3f} s, minor faults "
                     f"{ru1.ru_minflt - ru0.ru_minflt}")
        if cuda:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        else:
            peak = 0
    finally:
        eng.stop()
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    in_window = sum(1 for t in ans.done if t0 <= t <= t_end)
    if sched is None:
        attempted, failed = sent[0], ans.unserved
        n, span = answered(ans.done, t0, t_end)
        e2e = {"requests_per_s": n / span if span > 0 else 0.0}
        notes.append(f"answered from answer to answer: {n} in {span!r} s")
    else:
        attempted = len(sched)
        rejected = int(np.isinf(latency).sum()) - ans.unserved
        failed = rejected + ans.unserved
        lat = np.sort(latency)
        p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)] if len(lat) \
            else math.inf
        # a request that never came counts as missing: it reads as the
        # window's whole length past its arrival, and more
        e2e = {"e2e_p95_ms": (p95 if math.isfinite(p95)
                              else seconds + DRAIN_S) * 1e3}
        lt = np.array(late) * 1e3
        notes.append(f"generator late ms: median "
                     f"{float(np.median(lt)) if len(lt) else 0.0!r} p99 "
                     f"{float(np.percentile(lt, 99)) if len(lt) else 0.0!r} "
                     f"max {float(lt.max()) if len(lt) else 0.0!r}; "
                     f"rejected {rejected}")
    e2e["setup_s"] = setup_s
    notes.append(f"completed in window {in_window} of {attempted} sent")

    rel = reference_check(config, weights, pool, ans, device) \
        if ans.sample else 1e30
    limits = config["limits"]
    checks = {
        "rel_err": {"value": rel, "limit": limits["rel_err"]},
        "unserved": {"value": ans.unserved, "limit": 0},
        "answers_checked": {"value": len(ans.sample), "limit": 1},
    }
    correct = (rel <= limits["rel_err"] and ans.unserved == 0
               and len(ans.sample) >= 1)

    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        tr_s = window_trace(prof, window, ans)
        ctx = Context(cell=cell, trace=tr_s, batch=batch)
        metrics = ctx.per_layer()
        dev["busy_s"] = tr_s.busy_s()
        dev["window_s"] = tr_s.window_s
        breakdown = {"device_ops": tr_s.top_ops(), "idle_gaps":
                     tr_s.top_gaps()}
        notes.append(f"traced: {tr_s.requests} requests, "
                     f"{len(tr_s.events)} device events")
    else:
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()
                   if k in units}
    return Outcome(attempted=attempted, failed=failed, checks=checks,
                   correct=correct, metrics=metrics, device=dev,
                   breakdown=breakdown, notes=notes)


def warm_profiler() -> None:
    """Start and stop the profiler once during set-up.  Its first start in
    a process initialises the device's tracing for about 12 s, with every
    thread held up: started first inside the window it stalled the engine
    for as long."""
    from torch.profiler import profile
    with profile(activities=_activities()):
        torch.ones(1).sum().item()


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def traced_window(t0: float, seconds: float):
    """Profile a steady sub-window in the middle of the window, from this
    thread; return the profile and the range's host bounds."""
    from torch.profiler import profile, record_function

    span = min(TRACE_S, seconds / 2)
    start = t0 + (seconds - span) / 2 - TRACE_LEAD_S
    time.sleep(max(0.0, start - time.perf_counter()))
    prof = profile(activities=_activities())
    prof.start()
    time.sleep(TRACE_LEAD_S)
    with record_function("perfbench.window"):
        a = time.perf_counter()
        time.sleep(span)
        b = time.perf_counter()
    prof.stop()
    return prof, (a, b)


def window_trace(prof, window, ans: Answers):
    from . import trace as trace_mod
    tr = trace_mod.export_and_read(prof)
    a, b = window
    n, span = answered(ans.done, a, b)
    tr.requests = n / span * (b - a) if span > 0 else 0.0
    return tr
