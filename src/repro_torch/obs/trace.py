"""Zero-dependency tracing: context-manager spans with a strict no-op off path.

One module-level enabled flag gates everything.  When tracing is OFF (the
default), ``span`` returns a shared singleton whose ``__enter__``/``__exit__``
do nothing — no event dict is built, no string is formatted, no timestamp is
read — so instrumented hot paths cost one attribute load + truth test.  When
ON, every span records ``(name, ts, dur, tid, depth, attrs)`` against a
process start reference, events accumulate in memory, and ``flush`` writes
them as JSONL (one event per line, first line a ``meta`` header).  Spans may
carry *plan provenance* attributes — ``plan_id``, ``graph_hash``,
``schema_version``, ``step`` — which is what lets the report CLI join a
measured wall-clock interval back to the plan step whose analytical
cycles/energy it is supposed to validate.

Event schema (``TRACE_SCHEMA`` = 1), one JSON object per line:

* ``{"ev": "meta", "schema": 1, "pid": ..., "unix_time": ...}``
* ``{"ev": "span", "name": ..., "ts": us, "dur": us, "tid": ..., "depth": ...,
  "attrs": {...}}``
* ``{"ev": "log", "level": ..., "name": ..., "msg": ..., "ts": us}``
* ``{"ev": "counter" | "gauge", "name": ..., "value": ..., "ts": us}``
* ``{"ev": "hist", "name": ..., "count": ..., "sum": ..., "min": ..., "max":
  ..., "p50": ..., "p99": ..., "ts": us}``

``export_chrome_trace`` converts the same events to the Chrome
``trace_event`` JSON array format (spans as ``ph: "X"`` complete events,
sorted by start time, logs as instants, counters as ``ph: "C"``), loadable in
``chrome://tracing`` or https://ui.perfetto.dev.

Capture without touching code: ``REPRO_TRACE=out.jsonl`` — the launchers call
``configure_from_env()``, which enables tracing and registers an atexit
flush to that path.
"""
from __future__ import annotations

import atexit
import json
import os
import pathlib
import threading
import time
from typing import Any, Dict, List, Optional

TRACE_SCHEMA = 1

# ------------------------------------------------------------- process state
# Mutated only through enable()/disable(); read on every instrumented call.
_enabled = False
_events: List[Dict[str, Any]] = []
_sink_path: Optional[pathlib.Path] = None
_t0 = time.perf_counter()
_t0_unix = time.time()
_tls = threading.local()
_atexit_registered = False


def enabled() -> bool:
    """True when tracing is recording events (the hot-path gate)."""
    return _enabled


def _now_us() -> float:
    return (time.perf_counter() - _t0) * 1e6


def _depth() -> int:
    return getattr(_tls, "depth", 0)


class _NullSpan:
    """The disabled path: a shared, attribute-less, allocation-free span."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, key: str, value) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """A live span: times the ``with`` body, records one event on exit."""

    __slots__ = ("name", "attrs", "_start")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.attrs = attrs

    def set(self, key: str, value) -> "Span":
        """Attach/overwrite one attribute (usable before or inside the body)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value
        return self

    def __enter__(self) -> "Span":
        _tls.depth = _depth() + 1
        self._start = _now_us()
        return self

    def __exit__(self, *exc) -> bool:
        end = _now_us()
        _tls.depth = _depth() - 1
        if _enabled:   # disable() between enter/exit drops the event
            _events.append({
                "ev": "span", "name": self.name, "ts": self._start,
                "dur": end - self._start, "tid": threading.get_ident(),
                "depth": _depth(),
                "attrs": self.attrs if self.attrs is not None else {}})
        return False


def span(name: str, attrs: Optional[Dict[str, Any]] = None):
    """Open a span; ``attrs`` is an optional plain dict of attributes.

    Disabled tracing returns the shared ``NULL_SPAN`` — callers building an
    expensive attrs dict on a hot path should gate on ``enabled()`` first.
    """
    if not _enabled:
        return NULL_SPAN
    return Span(name, attrs)


def record_span(name: str, start_us: float,
                attrs: Optional[Dict[str, Any]] = None,
                end_us: Optional[float] = None) -> None:
    """Record an already-timed interval (for paths that cannot use ``with``).

    ``start_us``/``end_us`` are ``now_us()`` values; ``end_us`` defaults to
    the current time.  No-op when disabled.
    """
    if not _enabled:
        return
    _events.append({
        "ev": "span", "name": name, "ts": start_us,
        "dur": (_now_us() if end_us is None else end_us) - start_us,
        "tid": threading.get_ident(), "depth": _depth(),
        "attrs": attrs if attrs is not None else {}})


def now_us() -> float:
    """Microseconds since the trace clock epoch (pairs with record_span)."""
    return _now_us()


def record_event(event: Dict[str, Any]) -> None:
    """Append a pre-built non-span event (log/counter lines).  No-op off."""
    if not _enabled:
        return
    event.setdefault("ts", _now_us())
    _events.append(event)


# ------------------------------------------------------------ lifecycle / IO
def enable(trace_path: Optional[str | os.PathLike] = None) -> None:
    """Start recording; with ``trace_path`` also flush there at process exit."""
    global _enabled, _sink_path, _atexit_registered
    _enabled = True
    if trace_path is not None:
        _sink_path = pathlib.Path(trace_path)
        if not _atexit_registered:
            atexit.register(_atexit_flush)
            _atexit_registered = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop all recorded events and metrics; disable tracing (test hook)."""
    global _enabled, _sink_path
    from . import metrics
    _enabled = False
    _sink_path = None
    _events.clear()
    for store in metrics.registry():
        store.clear()


def events() -> List[Dict[str, Any]]:
    """The in-memory event list (live reference; treat as read-only)."""
    return _events


def configure_from_env() -> None:
    """Honour ``REPRO_TRACE=<path>`` (enable + atexit flush) if set."""
    path = os.environ.get("REPRO_TRACE")
    if path:
        enable(path)


def _meta_event() -> Dict[str, Any]:
    return {"ev": "meta", "schema": TRACE_SCHEMA, "pid": os.getpid(),
            "unix_time": _t0_unix}


def flush(path: Optional[str | os.PathLike] = None) -> pathlib.Path:
    """Write meta + all events + a final metrics snapshot as JSONL."""
    from . import metrics
    p = pathlib.Path(path) if path is not None else _sink_path
    if p is None:
        raise ValueError("no trace path: pass one or enable(trace_path=...)")
    p.parent.mkdir(parents=True, exist_ok=True)
    lines = [json.dumps(_meta_event())]
    lines += [json.dumps(e) for e in _events]
    lines += [json.dumps(e) for e in metrics.snapshot_events(_now_us())]
    p.write_text("\n".join(lines) + "\n")
    return p


def _atexit_flush() -> None:
    if _enabled and _sink_path is not None:
        flush()


def read_trace(path: str | os.PathLike) -> List[Dict[str, Any]]:
    """Parse a JSONL trace back into its event list (meta line included)."""
    out = []
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            out.append(json.loads(line))
    return out


def validate_trace(evs: List[Dict[str, Any]]) -> List[str]:
    """Schema errors in a parsed trace ([] == valid).

    Checks: a leading meta line with a known schema, every event carries a
    known ``ev`` kind and its required fields, span timestamps/durations are
    finite and non-negative.
    """
    errors: List[str] = []
    if not evs:
        return ["empty trace"]
    if evs[0].get("ev") != "meta":
        errors.append("first line is not a meta event")
    elif evs[0].get("schema") != TRACE_SCHEMA:
        errors.append(f"unknown trace schema {evs[0].get('schema')}")
    required = {"span": ("name", "ts", "dur", "tid", "depth", "attrs"),
                "log": ("level", "name", "msg", "ts"),
                "counter": ("name", "value", "ts"),
                "gauge": ("name", "value", "ts"),
                "hist": ("name", "count", "sum", "min", "max", "p50",
                         "p99", "ts"),
                "meta": ("schema", "pid")}
    for i, e in enumerate(evs):
        kind = e.get("ev")
        if kind not in required:
            errors.append(f"line {i}: unknown event kind {kind!r}")
            continue
        missing = [k for k in required[kind] if k not in e]
        if missing:
            errors.append(f"line {i}: {kind} missing {missing}")
        if kind == "span" and not missing:
            if not (e["ts"] >= 0 and e["dur"] >= 0):
                errors.append(f"line {i}: negative ts/dur")
    return errors


# ----------------------------------------------------------- chrome trace_event
def export_chrome_trace(path: str | os.PathLike,
                        evs: Optional[List[Dict[str, Any]]] = None,
                        pid: Optional[int] = None) -> pathlib.Path:
    """Write events in Chrome ``trace_event`` JSON-array format.

    Spans become ``ph: "X"`` complete events sorted by start timestamp (so
    ``ts`` is monotonically non-decreasing in the file), log lines become
    instants, counters/gauges become ``ph: "C"`` counter samples.  Open the
    result in ``chrome://tracing`` or Perfetto.
    """
    evs = _events if evs is None else evs
    pid = os.getpid() if pid is None else pid
    out = []
    for e in evs:
        kind = e.get("ev")
        if kind == "span":
            out.append({"name": e["name"], "cat": "repro", "ph": "X",
                        "ts": e["ts"], "dur": e["dur"], "pid": pid,
                        "tid": e.get("tid", 0), "args": e.get("attrs", {})})
        elif kind == "log":
            out.append({"name": f"[{e['name']}] {e['msg']}", "cat": "log",
                        "ph": "i", "s": "t", "ts": e["ts"], "pid": pid,
                        "tid": e.get("tid", 0),
                        "args": {"level": e["level"]}})
        elif kind in ("counter", "gauge"):
            out.append({"name": e["name"], "cat": "metric", "ph": "C",
                        "ts": e.get("ts", 0.0), "pid": pid,
                        "args": {"value": e["value"]}})
    out.sort(key=lambda d: d["ts"])
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(out, indent=1))
    return p


# -------------------------------------------------------------------- measure
def measure(fn, *args, **kwargs):
    """``(result, seconds)`` of ``fn(*args, **kwargs)``, async dispatch fenced.

    CUDA launches are asynchronous: timing ``fn()`` alone measures Python
    call overhead, not the computation.  When the result holds a CUDA tensor
    ``measure`` calls ``torch.cuda.synchronize()`` *inside* the timed region,
    so wall-clock covers the device work.  Other results (plans, numpy, CPU
    tensors) pass through untouched; the helper stays usable — and torch
    stays unimported — in pure-python benchmarks.
    """
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if _holds_cuda_tensor(out):
        import torch
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _holds_cuda_tensor(out) -> bool:
    """True when ``out`` (or a list/tuple/dict of it) holds a CUDA tensor."""
    if isinstance(out, (list, tuple)):
        return any(_holds_cuda_tensor(o) for o in out)
    if isinstance(out, dict):
        return any(_holds_cuda_tensor(o) for o in out.values())
    return getattr(getattr(out, "device", None), "type", None) == "cuda"
