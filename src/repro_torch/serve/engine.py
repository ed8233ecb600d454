"""Continuous-batching serve engine for planned networks and the LM zoo.

The port of ``repro.serve.engine``: requests enter a bounded admission
queue, worker threads assemble dynamic batches up to the plan tile's batch
extent (pad-and-mask — outputs are bit-identical to serving each request
alone, asserted in the tests), and every batch runs on ``config.device``
through one of two backends.  Planned networks go through one
``PreparedNetwork``: one host-to-device copy of the assembled batch, one
``rir_matmul`` launch per layer, one device-to-host copy of the results.
LMs (``arch=``) run prefill, then greedy decode: every decode step's
attention layers each launch ``gqa_decode`` once, the tokens stay on the
device, and one copy at the end brings the batch's tokens back.  An SSM
(rwkv6) or the hybrid scans its prompt in through ``decode_step``, one
token at a time, as the JAX engine does (``serve.prefill_ms`` covers that
scan-in); every other family runs ``prefill`` (the encoder-decoder's
encoder over its zero stub frames, the model's default).  Plan
resolution rides the degradation ladder (``repro_torch.plan.resolve_plan``)
against a warm ``PlanCache`` shared across workers, and a request admitted
at a degraded tier upgrades itself: a background thread retries the full
planner (``repro_torch.plan.upgrade_plan``) and atomically swaps in the
tier-1 prepared network once it recovers — the serving loop never blocks
on planning.

Pipeline::

    submit() -> [bounded queue] -> assembler (<= plan batch extent)
             -> PreparedNetwork / LM prefill+decode -> per-request results
                          ^ background tier upgrader (degraded plans only)

Backpressure is a *typed* contract: a full queue (or an injected
``serve.queue`` admission fault — the chaos schedule's new site) rejects
with ``QueueFullError`` immediately; admission never blocks and never
deadlocks.  Observability: ``serve.queue_depth`` gauge,
``serve.batch_size`` / ``serve.time_in_queue_ms`` / ``serve.ttft_ms`` /
``serve.e2e_ms`` (and, for LMs, ``serve.prefill_ms`` /
``serve.decode_ms_per_token``, fenced with ``torch.cuda.synchronize``)
histograms, ``serve.requests`` / ``serve.rejected{reason=}``
/ ``serve.batches`` / ``serve.plan_upgrade`` counters, and a ``serve.batch``
span carrying ``plan_id`` / ``plan_tier`` / ``plan_reason``.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.runtime import faults

from .config import ServeConfig

log = obs.get_logger("serve")


class ServeError(Exception):
    """Base class for engine-surface failures.

    Deliberately NOT a ``RuntimeError``: the recovery layers retry
    ``STEP_FAULT_TYPES`` as machine faults, and an engine-surface error
    (bad request shape, stopped engine, typed backpressure) is a caller
    condition to handle, not a fault to retry blindly."""


class QueueFullError(ServeError):
    """Typed backpressure rejection: admission failed, retry later.

    ``reason`` is ``"capacity"`` (bounded queue full), ``"fault"`` (an
    injected/real admission fault at the ``serve.queue`` site), or
    ``"stopped"`` (engine shut down).  Clients treat all three the same
    way: back off and resubmit, or shed the request.
    """

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


class ServeTicket:
    """A submitted request's handle: blocks on ``result()`` until served."""

    __slots__ = ("rid", "payload", "submit_us", "_event", "_value", "_exc")

    def __init__(self, rid: int, payload):
        self.rid = rid
        self.payload = payload
        self.submit_us = obs.now_us()
        self._event = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None

    def _resolve(self, value=None, exc: Optional[BaseException] = None):
        self._value, self._exc = value, exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """The request's output (LM: its generated int32 tokens; network:
        its own sample's activation), as numpy.  Raises the batch's
        failure, or ``TimeoutError`` if not served within ``timeout``
        seconds."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not served within "
                               f"{timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._value


# ========================================================================
# Backends: what one assembled batch *does*
# ========================================================================
def build_graph(name: str):
    """The layer graph a ``ServeConfig.graph`` name serves (the JAX
    package's ``repro.obs.smoke.build_graph``)."""
    from repro_torch.core.dataflow import ConvWorkload
    from repro_torch.plan import (from_layers, mobilenet_v3_graph,
                                  resnet50_graph)
    if name == "resnet50":
        return resnet50_graph()
    if name == "mobv3":
        return mobilenet_v3_graph()
    wls = [ConvWorkload(name=f"tiny-l{i}", N=1, M=128, C=16 if i == 0
                        else 128, P=8, Q=8, R=1, S=1, stride=1)
           for i in range(3)]
    return from_layers(wls, name="tiny")


class _NetworkBackend:
    """Planned conv-network serving through ``PreparedNetwork``."""

    def __init__(self, config: ServeConfig, cache, graph, weights,
                 sleep: Callable[[float], None]):
        from repro_torch.core.layoutloop import EvalConfig
        from repro_torch.core.workloads import init_graph_weights
        from repro_torch.device import resolve_device
        from repro_torch.plan import prepare_network, resolve_plan

        resolve_device(config.device)   # fail before planning, not after
        self.config = config
        self.cache = cache
        self.eval_cfg = EvalConfig()
        self.opts = _planner_options(config)
        base = graph if graph is not None else build_graph(config.graph)
        self.graph = base.with_batch(config.max_batch)
        self.weights = weights if weights is not None else \
            init_graph_weights(list(self.graph.layers), seed=config.seed)
        with obs.span("serve.plan", {"graph": self.graph.name}):
            self.resolved = resolve_plan(
                self.graph, self.eval_cfg, self.opts, cache=cache,
                artifact=config.plan, deadline_s=config.plan_deadline,
                sleep=sleep)
        self.prepared = prepare_network(self.resolved.plan, self.graph,
                                        self.weights, device=config.device)

    @property
    def sample_shape(self):
        return self.prepared.input_shape[1:]

    def validate(self, payload) -> None:
        a = np.asarray(payload)
        if a.shape != self.sample_shape:
            raise ServeError(f"request shape {a.shape} != planned "
                             f"per-sample shape {self.sample_shape}")

    def run(self, prepared, payloads: Sequence) -> List[np.ndarray]:
        # one host-to-device copy of the assembled batch in, one
        # device-to-host copy of the real requests' rows out (the fence)
        k = len(payloads)
        y = prepared(prepared.assemble_batch(payloads))
        host = y[:k].cpu().numpy()
        return [host[i] for i in range(k)]

    def upgraded(self, resolved):
        """Build the tier-1 prepared network for an upgraded plan."""
        from repro_torch.plan import prepare_network
        return prepare_network(resolved.plan, self.graph, self.weights,
                               device=self.config.device)


class _LMBackend:
    """LM serving: prefill, then greedy decode, on ``config.device``."""

    def __init__(self, config: ServeConfig, cache, weights,
                 sleep: Callable[[float], None]):
        import torch

        from repro_torch.configs import get_config
        from repro_torch.device import resolve_device
        from repro_torch.models import build_model

        self.device = resolve_device(config.device)   # before building
        self.config = config
        self.cache = cache
        self.cfg = get_config(config.arch, smoke=config.smoke)
        self.resolved = None
        self.graph = None
        if config.plan is not None:
            from repro_torch.core.layoutloop import EvalConfig
            from repro_torch.plan import from_arch_config, resolve_plan

            self.eval_cfg = EvalConfig()
            self.opts = _planner_options(config)
            self.graph = from_arch_config(
                self.cfg, seq=config.prompt_len + config.gen)
            with obs.span("serve.plan", {"arch": self.cfg.name}):
                self.resolved = resolve_plan(
                    self.graph, self.eval_cfg, self.opts, cache=cache,
                    artifact=config.plan, deadline_s=config.plan_deadline,
                    sleep=sleep)
        self.model = build_model(self.cfg, device=self.device)
        if weights is not None:
            self.model.load_params(weights)
        else:
            self.model.init(torch.Generator(device=self.device)
                            .manual_seed(config.seed))
        self.max_seq = config.prompt_len + config.gen

    @property
    def prepared(self):
        return None   # decode runs through the model's own step

    @property
    def sample_shape(self):
        return (self.config.prompt_len,)

    def validate(self, payload) -> None:
        a = np.asarray(payload)
        if a.shape != self.sample_shape:
            raise ServeError(f"prompt shape {a.shape} != "
                             f"({self.config.prompt_len},) — requests carry "
                             f"exactly prompt_len tokens")

    def _fence(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, _prepared, payloads: Sequence) -> List[np.ndarray]:
        import torch

        B = self.config.max_batch
        k = len(payloads)
        prompts = np.zeros((B, self.config.prompt_len), np.int64)
        for i, p in enumerate(payloads):
            prompts[i] = np.asarray(p, np.int64)
        gen = self.config.gen
        with torch.inference_mode():
            tokens = torch.from_numpy(prompts).to(self.device)
            t0 = time.perf_counter()
            if self.cfg.family in ("ssm", "hybrid"):
                # scan the prompt in one token at a time, as the JAX engine
                # does: the recurrent states come from stepping
                cache = self.model.init_cache(B, self.max_seq)
                for t in range(self.config.prompt_len):
                    cache, logits = self.model.decode_step(cache,
                                                           tokens[:, t])
            else:
                cache, logits = self.model.prefill(tokens, self.max_seq)
            self._fence()
            t_prefill = time.perf_counter() - t0
            obs.observe("serve.prefill_ms", t_prefill * 1e3)
            tok = torch.argmax(logits, dim=-1)
            out = [tok]
            t0 = time.perf_counter()
            for _ in range(gen - 1):
                cache, logits = self.model.decode_step(cache, tok)
                tok = torch.argmax(logits, dim=-1)
                out.append(tok)
            self._fence()
            t_decode = time.perf_counter() - t0
            # the one device-to-host copy: (B, gen) tokens
            toks = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
        if gen > 1:
            obs.observe("serve.decode_ms_per_token",
                        t_decode * 1e3 / (gen - 1))
        log.debug("batch of %d: prefill %.1f ms; decode %.1f ms/token",
                  k, t_prefill * 1e3, t_decode * 1e3 / max(1, gen - 1))
        return [toks[i] for i in range(k)]

    def upgraded(self, resolved):
        return None


def _planner_options(config: ServeConfig):
    from repro_torch.core.layout import Layout
    from repro_torch.plan import PlannerOptions

    layouts = None
    if config.layouts is not None:
        layouts = tuple(Layout.parse(s) for s in config.layouts)
    return PlannerOptions(switch_modes=("rir",), layouts=layouts,
                          parallel_dims=("C", "P", "Q"))


# ========================================================================
# The engine
# ========================================================================
_SENTINEL = object()


class ServeEngine:
    """Request-level continuous batching over a planned network or LM.

    Construction resolves the plan (degradation ladder + shared cache) and
    hoists all per-plan setup; ``start()`` spawns the assembler workers;
    ``submit()`` is non-blocking admission returning a ``ServeTicket``.
    Use as a context manager::

        with ServeEngine(ServeConfig(graph="tiny", max_batch=4)) as eng:
            outs = eng.serve(samples)

    ``weights``: the network's per-layer weights (network mode) or the
    LM's named parameters from ``to_torch_lm_params`` (LM mode); None
    draws them from ``config.seed``.
    """

    def __init__(self, config: ServeConfig, *, cache=None, graph=None,
                 weights=None, sleep: Callable[[float], None] = time.sleep):
        from repro_torch.plan import PlanCache

        self.config = config
        self._sleep = sleep
        self.cache = cache if cache is not None else PlanCache()
        if config.log_level:
            obs.set_level(config.log_level)
        if config.arch is not None:
            self._backend = _LMBackend(config, self.cache, weights, sleep)
        else:
            self._backend = _NetworkBackend(config, self.cache, graph,
                                            weights, sleep)
        self._resolved = self._backend.resolved
        self._prepared = self._backend.prepared
        self._swap_lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue(maxsize=config.queue_capacity)
        self._rid = itertools.count()
        self._workers: List[threading.Thread] = []
        self._upgrader: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._started = False
        if self._resolved is not None:
            log.info("plan %s tier=%s%s", self._resolved.plan.plan_id,
                     self._resolved.tier_name,
                     f" reason={self._resolved.reason!r}"
                     if self._resolved.reason else "")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ServeEngine":
        if self._started:
            return self
        self._started = True
        self._stop.clear()
        for i in range(self.config.workers):
            t = threading.Thread(target=self._worker_loop,
                                 name=f"serve-worker-{i}", daemon=True)
            t.start()
            self._workers.append(t)
        if self.resolved is not None and self.resolved.degraded:
            self._upgrader = threading.Thread(
                target=self._upgrade_loop, name="serve-upgrader", daemon=True)
            self._upgrader.start()
        return self

    def stop(self) -> None:
        if not self._started:
            return
        self._stop.set()
        for _ in self._workers:
            try:
                self._queue.put_nowait(_SENTINEL)
            except queue.Full:
                pass
        for t in self._workers:
            t.join(timeout=30.0)
        if self._upgrader is not None:
            self._upgrader.join(timeout=30.0)
        # fail anything still queued — a stopped engine must not strand
        # callers blocked on result()
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _SENTINEL:
                item._resolve(exc=ServeError("engine stopped before "
                                             "this request was served"))
        self._workers = []
        self._upgrader = None
        self._started = False

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # ------------------------------------------------------------ admission
    @property
    def resolved(self):
        """The currently-serving ``ResolvedPlan`` (upgrades swap it)."""
        with self._swap_lock:
            return self._resolved

    @property
    def model(self):
        """The served LM (``repro_torch.models.LMModel``, LM mode), else
        None."""
        return getattr(self._backend, "model", None)

    def queue_depth(self) -> int:
        return self._queue.qsize()

    @property
    def sample_shape(self):
        """Per-request payload shape: the planned per-sample activation
        shape (network mode) or ``(prompt_len,)`` of int tokens (LM)."""
        return self._backend.sample_shape

    def submit(self, payload) -> ServeTicket:
        """Admit one request; non-blocking, typed-rejection backpressure.

        Raises ``QueueFullError`` when the bounded queue is full, admission
        faults (the ``serve.queue`` site), or the engine is stopped —
        admission never blocks, so a saturated engine can never deadlock
        its clients.
        """
        if not self._started or self._stop.is_set():
            obs.inc_counter("serve.rejected", reason="stopped")
            raise QueueFullError("engine is not running", reason="stopped")
        try:
            faults.site(faults.SERVE_QUEUE)
        except faults.STEP_FAULT_TYPES as e:
            obs.inc_counter("serve.rejected", reason="fault")
            raise QueueFullError(
                f"admission fault: {type(e).__name__}: {e}",
                reason="fault") from e
        self._backend.validate(payload)
        ticket = ServeTicket(next(self._rid), payload)
        try:
            self._queue.put_nowait(ticket)
        except queue.Full:
            obs.inc_counter("serve.rejected", reason="capacity")
            raise QueueFullError(
                f"queue at capacity ({self.config.queue_capacity})",
                reason="capacity") from None
        obs.inc_counter("serve.requests")
        obs.set_gauge("serve.queue_depth", self._queue.qsize())
        return ticket

    def serve(self, payloads: Sequence, *, timeout: float = 600.0,
              backoff_s: float = 0.01) -> List:
        """Submit a request list (retrying typed rejections) and collect
        every result in submission order — the convenience loop the CLI,
        smoke and benchmark share."""
        tickets = []
        for p in payloads:
            while True:
                try:
                    tickets.append(self.submit(p))
                    break
                except QueueFullError as e:
                    if e.reason == "stopped":
                        raise
                    self._sleep(backoff_s)
        return [t.result(timeout=timeout) for t in tickets]

    # ------------------------------------------------------------- assembler
    def _worker_loop(self) -> None:
        limit = self.config.batch_limit
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is _SENTINEL:
                return
            batch = [first]
            while len(batch) < limit:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is _SENTINEL:
                    try:
                        # keep the shutdown token visible to sibling workers
                        self._queue.put_nowait(_SENTINEL)
                    except queue.Full:
                        pass   # workers also exit on the stop event
                    break
                batch.append(item)
            obs.set_gauge("serve.queue_depth", self._queue.qsize())
            self._run_batch(batch)

    def _run_batch(self, batch: List[ServeTicket]) -> None:
        with self._swap_lock:
            resolved, prepared = self._resolved, self._prepared
        t_asm = obs.now_us()
        traced = obs.enabled()
        if traced:
            obs.observe("serve.batch_size", len(batch))
            for t in batch:
                obs.observe("serve.time_in_queue_ms",
                            (t_asm - t.submit_us) / 1e3)
        attrs = None
        if traced:
            attrs = {"batch": len(batch)}
            if resolved is not None:
                attrs.update(plan_id=resolved.plan.plan_id,
                             plan_tier=resolved.tier_name,
                             plan_reason=resolved.reason)
        try:
            with obs.span("serve.batch", attrs):
                outs = self._backend.run(prepared,
                                         [t.payload for t in batch])
        except Exception as e:   # noqa: BLE001 — fail the batch, keep serving
            obs.inc_counter("serve.batch_failed", type=type(e).__name__)
            log.warning("batch of %d failed (%s: %s)", len(batch),
                        type(e).__name__, e)
            for t in batch:
                t._resolve(exc=e)
            return
        obs.inc_counter("serve.batches")
        done = obs.now_us()
        for t, out in zip(batch, outs):
            t._resolve(value=out)
            if traced:
                # one batch yields each request's first (and, for the
                # network backend, only) output token/tensor
                obs.observe("serve.ttft_ms", (done - t.submit_us) / 1e3)
                obs.observe("serve.e2e_ms", (done - t.submit_us) / 1e3)

    # ---------------------------------------------------------- tier upgrade
    def _upgrade_loop(self) -> None:
        """Background re-planning: degraded tier -> tier 1, never blocking.

        Runs only while the engine serves a degraded plan.  Each round
        waits ``upgrade_interval_s``, retries the full planner via
        ``upgrade_plan`` (cache hit counts — another worker may win the
        race), builds the new prepared network *off* the serving path, and
        swaps it in atomically between batches.
        """
        from repro_torch.plan import upgrade_plan

        b = self._backend
        while not self._stop.wait(self.config.upgrade_interval_s):
            up = upgrade_plan(b.graph, b.eval_cfg, b.opts, cache=self.cache,
                              artifact=self.config.plan, sleep=self._sleep)
            if up is None:
                continue
            prepared = b.upgraded(up)
            with self._swap_lock:
                old = self._resolved
                self._resolved, self._prepared = up, prepared
            obs.inc_counter("serve.plan_upgrade")
            log.info("plan upgraded %s -> %s (plan %s)", old.tier_name,
                     up.tier_name, up.plan.plan_id)
            return
