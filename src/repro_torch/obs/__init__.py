"""repro_torch.obs — zero-dependency tracing, metrics, and structured logging.

FEATHER's pitch is that per-layer dataflow/layout switching is worth it only
if the switching overheads are actually negligible; this package is how the
repro *measures* that instead of asserting it.  It threads through every
layer of the stack — planner phases, plan-cache traffic, per-step executor
device time (a pair of CUDA timing events around each step, never a
device-wide sync, recorded next to the step's modeled cycles/energy), the
continuous-batching serve loop (batch assembly, the host-to-device copy,
the forward's enqueue, the wait for the answers), the training supervisor,
and the whole robustness layer whose counters ``python -m
repro.runtime.chaos`` verifies injections against.  Tracing on changes no
value and adds no sync, so it can stay on inside a measured run.  While a
``torch.profiler`` session is active every span is also a
``record_function`` range, so the program's spans show in the profiler's
chrome trace as ``user_annotation`` events on the profiler's clock.

Every emitted family lives in the ``repro_torch.obs.names`` registry
(name + label keys); ``repro_torch.check`` lints call sites against it,
and the inventory below is generated from it.

-- generated by `python -m repro_torch.check docs --write`; do not edit --
Counters:
  ``faults.injected{site=}``
      fault injections fired, by site
  ``retry.attempts{site=}``
      retries performed, by retry site
  ``retry.exhausted{site=}``
      retry budgets exhausted, by site
  ``heartbeat.dropped{type=}``
      liveness packets absorbed as lost
  ``degrade.tier{level=}``
      plan resolutions, by ladder tier
  ``plan.artifact_error{type=}``
      unreadable/invalid plan artifacts
  ``plan.upgrade_failed{type=}``
      background re-plans that errored
  ``planner.lattice_builds``
      per-layer candidate lattices built
  ``plan_cache.hit{tier=}``
      cache hits (tier=mem|disk)
  ``plan_cache.miss``
      cache misses (both tiers)
  ``plan_cache.put``
      plans written through the cache
  ``plan_cache.evict{reason=}``
      cache entries evicted
  ``plan_cache.quarantined{reason=}``
      artifacts quarantined
  ``plan_cache.io_error{op=}``
      cache disk failures (op=get|put)
  ``ckpt.write_failed{type=}``
      checkpoint saves dropped after retry
  ``ckpt.restore_failed{type=}``
      unrestorable checkpoints skipped
  ``ckpt.restore_fallback``
      restores that fell back past newest
  ``serve.requests``
      requests admitted to the queue
  ``serve.rejected{reason=}``
      admissions rejected (reason=capacity|stopped|fault)
  ``serve.batches``
      continuous batches executed
  ``serve.batch_failed{type=}``
      batches whose execution raised
  ``serve.plan_upgrade``
      live plan-tier upgrades swapped in
  ``train.restarts{cause=}``
      supervisor restarts, by cause
  ``train.faults{type=}``
      step faults absorbed by the supervisor
Gauges:
  ``serve.queue_depth``
      admission queue depth after submit/drain
  ``planner.layers``
      layers in the graph being planned
  ``planner.dataflow_candidates``
      dataflow candidates per layer
  ``planner.tiling_candidates``
      tiling candidates per layer
  ``planner.lattice_points``
      total lattice points in the DP
  ``moe.load_max_over_mean``
      a held-expert block's busiest expert's rows over the held experts' mean
Histograms:
  ``train.backoff_s``
      supervisor restart backoff delays
  ``train.step_ms``
      traced training-step wall clock
  ``serve.batch_size``
      assembled continuous-batch sizes
  ``serve.time_in_queue_ms``
      request wait before batch assembly
  ``serve.e2e_ms``
      submit-to-completion latency
  ``serve.prefill_ms``
      LM prefill device time per batch
  ``serve.decode_ms_per_token``
      LM decode device time per token
Spans:
  ``planner.plan``
      whole network co-search (root span)
  ``planner.lattice``
      per-layer lattice phase (legacy planner path)
  ``planner.lattice_build``
      candidate lattice construction
  ``planner.dp_extend``
      DP forward extension over boundaries
  ``planner.argmin``
      backtrack/argmin over the DP table
  ``plan_cache.plan``
      cache-wrapped plan resolution
  ``exec.network``
      whole planned-network execution (host enqueue)
  ``exec.chain``
      one fused-chain dispatch
  ``exec.step``
      one plan-step kernel dispatch (device time)
  ``serve.plan``
      engine plan resolution at startup
  ``serve.batch``
      one continuous batch (batch id, plan id/tier in attrs)
  ``serve.assemble``
      host batch assembly: zero-padded batch, row copies
  ``serve.h2d``
      the assembled batch's host-to-device copy
  ``serve.collect``
      wait for the answers, copy them back, split them
  ``train.step``
      one traced training step
  ``moe.experts``
      a held-expert block's routing, sort, grouped products and combine, and its grouped products' backward (a torch.profiler range)
-- end generated --

The disabled path is a hard no-op: one module-level flag, no event dicts, no
string formatting, no timestamps (see ``trace.NULL_SPAN``), so production
code keeps its instrumentation with tracing off at zero measurable cost.

Capturing a trace
-----------------
Set ``REPRO_TRACE`` to a path and run any launcher (they all call
``configure_from_env``)::

    REPRO_TRACE=out.jsonl PYTHONPATH=src \\
        python -m repro_torch.launch.serve --arch llama3p2_3b --smoke \\
        --plan p.json

or programmatically::

    from repro_torch import obs
    obs.enable("out.jsonl")
    ...   # plan / execute / serve
    obs.flush()

Reading the trace
-----------------
``python -m repro_torch.obs.report out.jsonl`` (or ``repro.obs.report``:
both read the trace alike) prints the per-plan-step modeled-cycles vs
measured-device-time table (gap ratios, worst offenders)
plus planner/cache/serve summaries — the calibration artifact the
measured-vs-modeled roadmap item asks for.  ``--chrome out.json`` converts
the same events to Chrome ``trace_event`` format: open it in
``chrome://tracing`` or https://ui.perfetto.dev to see the span timeline.
``python -m repro_torch.obs.smoke`` runs a small planned network with
tracing on and validates the trace schema end-to-end (the CI smoke).

Beside the device's work, enable tracing inside a ``torch.profiler``
session; to see the serve workers' spans, profile every thread::

    from torch._C._profiler import _ExperimentalConfig
    with torch.profiler.profile(activities=[...], experimental_config=
            _ExperimentalConfig(profile_all_threads=True)) as prof:
        obs.enable()
        ...   # serve
        obs.disable()
    prof.export_chrome_trace("trace.json")   # serve.* / exec.* ranges
"""
from . import names
from .log import Logger, get_logger, set_level
from .metrics import (counter_value, gauge_value, hist_samples, hist_stats,
                      inc_counter, observe, registry, set_gauge, snapshot)
from .trace import (NULL_SPAN, TRACE_SCHEMA, Mark, Span, configure_from_env,
                    disable, enable, enabled, events, export_chrome_trace,
                    flush, measure, now_us, read_trace, record_event,
                    record_span, reset, resolve, span, validate_trace)

__all__ = [
    "names",
    "Logger", "get_logger", "set_level",
    "inc_counter", "set_gauge", "observe", "counter_value", "gauge_value",
    "hist_samples", "hist_stats", "snapshot", "registry",
    "NULL_SPAN", "TRACE_SCHEMA", "Span", "span", "record_span",
    "Mark", "resolve", "record_event", "now_us", "enable", "disable", "enabled", "reset",
    "events", "flush", "read_trace", "validate_trace",
    "export_chrome_trace", "configure_from_env", "measure",
]
