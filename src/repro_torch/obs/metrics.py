"""Process-wide metric registry: counters, gauges, histograms.

Same contract as the tracer: every mutation is gated on the module-level
enabled flag, so with observability off ``inc_counter``/``set_gauge``/
``observe`` cost one attribute load + truth test and allocate nothing.
Metrics are plain module state keyed by name; optional labels fold into the
key as ``name{k=v,...}`` (sorted, so label order never splits a series).

``snapshot`` returns the current values; ``snapshot_events`` renders them as
trace events (``counter`` / ``gauge`` / ``hist`` lines) that ``trace.flush``
appends after the spans — the report CLI reads cache hit rates, planner
candidate counts and serve latency percentiles from exactly these lines.
"""
from __future__ import annotations

from typing import Any, Dict, List

from . import trace

_counters: Dict[str, float] = {}
_gauges: Dict[str, float] = {}
_hists: Dict[str, List[float]] = {}

# keep raw histogram samples bounded: enough for exact percentiles at repo
# scale, a hard cap against a serving loop running for days with metrics on
_HIST_CAP = 65536


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def inc_counter(name: str, n: float = 1.0, **labels) -> None:
    """Add ``n`` to a monotonically increasing counter.  No-op when off."""
    if not trace._enabled:
        return
    k = _key(name, labels)
    _counters[k] = _counters.get(k, 0.0) + n


def set_gauge(name: str, value: float, **labels) -> None:
    """Set a point-in-time value (last write wins).  No-op when off."""
    if not trace._enabled:
        return
    _gauges[_key(name, labels)] = float(value)


def observe(name: str, value: float, **labels) -> None:
    """Record one histogram sample.  No-op when off."""
    if not trace._enabled:
        return
    k = _key(name, labels)
    samples = _hists.setdefault(k, [])
    if len(samples) < _HIST_CAP:
        samples.append(float(value))


def counter_value(name: str, **labels) -> float:
    return _counters.get(_key(name, labels), 0.0)


def gauge_value(name: str, **labels) -> float:
    return _gauges.get(_key(name, labels), 0.0)


def hist_samples(name: str, **labels) -> List[float]:
    return list(_hists.get(_key(name, labels), ()))


def registry() -> List[Dict[str, Any]]:
    """The three stores, for bulk clear (``trace.reset``) and tests."""
    return [_counters, _gauges, _hists]


def _percentile(sorted_samples: List[float], q: float) -> float:
    if not sorted_samples:
        return 0.0
    idx = min(len(sorted_samples) - 1, int(q * (len(sorted_samples) - 1) + 0.5))
    return sorted_samples[idx]


def hist_stats(name: str, **labels) -> Dict[str, float]:
    s = sorted(_hists.get(_key(name, labels), ()))
    return {"count": len(s), "sum": sum(s),
            "min": s[0] if s else 0.0, "max": s[-1] if s else 0.0,
            "p50": _percentile(s, 0.50), "p99": _percentile(s, 0.99)}


def snapshot() -> Dict[str, Dict[str, Any]]:
    """Current values of every metric, plain dicts (hists as stats)."""
    return {"counters": dict(_counters), "gauges": dict(_gauges),
            "hists": {k: hist_stats_raw(v) for k, v in _hists.items()}}


def hist_stats_raw(samples: List[float]) -> Dict[str, float]:
    s = sorted(samples)
    return {"count": len(s), "sum": sum(s),
            "min": s[0] if s else 0.0, "max": s[-1] if s else 0.0,
            "p50": _percentile(s, 0.50), "p99": _percentile(s, 0.99)}


def snapshot_events(ts_us: float) -> List[Dict[str, Any]]:
    """Render the registry as trace-schema metric events (for flush)."""
    out: List[Dict[str, Any]] = []
    for name, value in sorted(_counters.items()):
        out.append({"ev": "counter", "name": name, "value": value,
                    "ts": ts_us})
    for name, value in sorted(_gauges.items()):
        out.append({"ev": "gauge", "name": name, "value": value, "ts": ts_us})
    for name, samples in sorted(_hists.items()):
        st = hist_stats_raw(samples)
        st.update({"ev": "hist", "name": name, "ts": ts_us})
        out.append(st)
    return out
