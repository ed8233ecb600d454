"""The device trace of a traced run, reduced to what the readers need.

``torch.profiler`` (host and device activity) records a steady sub-window
in the middle of the measured window; a ``record_function`` range opened on
the controlling thread marks its bounds on the trace's own clock.  The
chrome trace is written under ``TMPDIR``, read back and deleted.

From it: every device event (kernels, copies, memsets) clipped to the
range, each classed by ``kernel_classes.json`` (first pattern found in the
name wins); the busy time as the union of their intervals, not their sum;
the idle gaps between them, each named by what the host thread that ended
it was doing (the innermost host event covering the gap's middle on the
thread whose launch the next device event answers, else ``after_<the last
event that thread finished>``); and the device-side copies of the
program's ``record_function`` ranges (``gpu_user_annotation``: from the
first device event launched under the range to the end of the last),
clipped to the range, so that a reader can take the device time under a
range of the program's, such as ``adamw.update``.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import itertools
import json
import os
import pathlib
import tempfile
from typing import Dict, List, Tuple

from .spec import HERE

RANGE = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
DEVICE_RANGE_CAT = "gpu_user_annotation"


def kernel_classes() -> List[Tuple[str, str]]:
    with open(HERE / "kernel_classes.json") as f:
        return [tuple(p) for p in json.load(f)["patterns"]]


def classify(name: str, patterns) -> str:
    for cls, pat in patterns:
        if pat in name:
            return cls
    return "other"


@dataclasses.dataclass
class DeviceEvent:
    name: str
    cls: str
    cat: str
    start: float       # us, clipped to the range
    end: float
    whole: bool = True     # the event lies inside the range, not clipped


@dataclasses.dataclass
class Trace:
    """A traced sub-window's device activity.  Times in seconds."""

    window_s: float
    events: List[DeviceEvent]
    gaps: List[Tuple[str, float]]       # (host label, seconds), every gap
    requests: float = 0.0   # answered in the range (at the answers' rate)
    #: the program's ranges on the device: (name, start us, end us),
    #: clipped to the range
    ranges: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list)
    steps: float = 0.0      # training steps completed in the range

    def busy_s(self) -> float:
        total, cur_s, cur_e = 0.0, None, None
        for e in sorted(self.events, key=lambda e: e.start):
            if cur_e is None or e.start > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = e.start, e.end
            else:
                cur_e = max(cur_e, e.end)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-6

    def class_s(self, cls: str) -> float:
        return sum(e.end - e.start for e in self.events
                   if e.cls == cls) * 1e-6

    def range_s(self, name: str) -> float:
        """Device time of the events inside the program's device-side ranges
        called ``name`` (their union: a nested or repeated range counts
        once)."""
        spans = sorted((a, b) for n, a, b in self.ranges if n == name)
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        events = sorted(self.events, key=lambda e: e.start)
        starts = [e.start for e in events]
        reach = list(itertools.accumulate((e.end for e in events), max))
        total = 0.0
        for a, b in merged:
            # the first event that may reach past a, to the last starting
            # before b
            j = bisect.bisect_right(reach, a)
            for e in events[j:bisect.bisect_left(starts, b)]:
                total += max(0.0, min(e.end, b) - max(e.start, a))
        return total * 1e-6

    def kernel_s(self) -> float:
        return sum(e.end - e.start for e in self.events
                   if e.cat == "kernel") * 1e-6

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = collections.defaultdict(float)
        for e in self.events:
            by[e.name] += (e.end - e.start) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def top_gaps(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = collections.defaultdict(float)
        for label, s in self.gaps:
            by[label] += s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def trace_path() -> pathlib.Path:
    d = pathlib.Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    return d / f"perfbench-trace-{os.getpid()}.json"


def _host_index(events):
    """Per thread: host events sorted by start, and their starts."""
    by_tid = collections.defaultdict(list)
    for e in events:
        by_tid[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0.0),
                                 e["name"]))
    out = {}
    for tid, evs in by_tid.items():
        evs.sort()
        out[tid] = (evs, [s for s, _, _ in evs],
                    sorted((end, name) for _, end, name in evs))
    return out


def _label(index, tid, t: float) -> str:
    if tid not in index:
        return "no_host_thread"
    evs, starts, ends = index[tid]
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 4000), -1):
        s, e, name = evs[j]
        if e >= t:
            return name
    k = bisect.bisect_right(ends, (t, chr(0x10FFFF))) - 1
    return f"after_{ends[k][1]}" if k >= 0 else "before_any_host_event"


def read_chrome_trace(path: pathlib.Path) -> Trace:
    """Reduce an exported chrome trace to the range's ``Trace``."""
    with open(path) as f:
        raw = json.load(f)
    evs = [e for e in raw.get("traceEvents", raw)
           if isinstance(e, dict) and e.get("ph") == "X"]
    rng = [e for e in evs if e.get("cat") == "user_annotation"
           and e["name"] == RANGE]
    if not rng:
        raise RuntimeError(f"the trace has no {RANGE!r} range")
    t0 = rng[0]["ts"]
    t1 = t0 + rng[0]["dur"]
    patterns = kernel_classes()
    device = []
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, d = e["ts"], e["ts"] + e.get("dur", 0.0)
        if d > t0 and s < t1:
            device.append((max(s, t0), min(d, t1), e, e.get("args", {})))
    device.sort(key=lambda x: x[0])
    host = [e for e in evs if e.get("cat") in HOST_CATS
            and e["name"] != RANGE]
    launch_tid = {e["args"]["correlation"]: e["tid"] for e in host
                  if e.get("cat") == "cuda_runtime"
                  and "correlation" in e.get("args", {})}
    index = _host_index(host)
    events = [DeviceEvent(name=e["name"], cls=classify(e["name"], patterns),
                          cat=e["cat"], start=s, end=d,
                          whole=e["ts"] >= t0
                          and e["ts"] + e.get("dur", 0.0) <= t1)
              for s, d, e, _ in device]
    ranges = [(e["name"], max(e["ts"], t0),
               min(e["ts"] + e.get("dur", 0.0), t1)) for e in evs
              if e.get("cat") == DEVICE_RANGE_CAT and e["name"] != RANGE
              and e["ts"] < t1 and e["ts"] + e.get("dur", 0.0) > t0]
    gaps: List[Tuple[str, float]] = []
    cur = t0
    for s, d, e, args in device + [(t1, t1, None, {})]:
        if s > cur:
            tid = launch_tid.get(args.get("correlation")) if e else None
            label = _label(index, tid, (cur + s) / 2) if tid is not None \
                else "end_of_window" if e is None else "unlinked"
            gaps.append((label, (s - cur) * 1e-6))
        cur = max(cur, d)
    return Trace(window_s=(t1 - t0) * 1e-6, events=events, gaps=gaps,
                 ranges=ranges)


def export_and_read(prof) -> Trace:
    """Write ``prof``'s chrome trace under TMPDIR, reduce it, delete it."""
    path = trace_path()
    prof.export_chrome_trace(str(path))
    try:
        return read_chrome_trace(path)
    finally:
        path.unlink(missing_ok=True)
