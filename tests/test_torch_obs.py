"""The port's tracing on the CPU: span ids, device-timed spans, and the
served path's spans inside a ``torch.profiler`` trace.

Tracing on adds no device sync: a step's ``dur`` comes from two timing
marks, filled in once the device has passed the second (``obs.resolve``
after a sync the path makes anyway, or ``obs.events()``), and while a
profiler session is active every span is also a ``record_function`` range
on its own thread.  The card's side of the same claims is in
``tests/test_torch_cuda.py``.
"""
import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs
from repro_torch.obs import trace
from repro_torch.plan import PlanCache
from repro_torch.serve import ServeConfig, ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVE_SPANS = ("serve.assemble", "serve.h2d", "exec.network",
               "serve.collect")


@pytest.fixture(autouse=True)
def _clean():
    obs.reset()
    yield
    obs.reset()


@pytest.fixture(scope="module")
def cache():
    """One warm PlanCache for the module: tiny is planned once."""
    return PlanCache()


def _samples(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _spans(name=None):
    return [e for e in obs.events() if e.get("ev") == "span"
            and (name is None or e["name"] == name)]


def test_span_ids_nest_as_run_on_each_thread():
    obs.enable()

    def work(tag):
        with obs.span("serve.batch", {"tag": tag}):
            with obs.span("exec.network"):
                obs.record_span("exec.step", obs.now_us(), {"tag": tag})
            with obs.span("serve.collect"):
                pass

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    with obs.span("planner.plan"):
        pass
    evs = _spans()
    by_id = {e["id"]: e for e in evs}
    assert len(by_id) == len(evs) == 9
    for e in evs:
        parent = by_id.get(e["parent"])
        if e["name"] in ("serve.batch", "planner.plan"):
            assert e["parent"] is None and e["depth"] == 0
            continue
        # a child hangs off the span open around it on its own thread
        assert parent["tid"] == e["tid"]
        assert e["depth"] == parent["depth"] + 1
        want = "exec.network" if e["name"] == "exec.step" else "serve.batch"
        assert parent["name"] == want
        root = parent if want == "serve.batch" else by_id[parent["parent"]]
        if e["name"] == "exec.step":
            assert root["attrs"]["tag"] == e["attrs"]["tag"]
        assert parent["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= parent["ts"] + parent["dur"] + 1e-6


class _Event:
    """A CUDA timing event's interface, completed when told."""

    def __init__(self, t_ms):
        self.t_ms, self.completed, self.waited = t_ms, False, False

    def query(self):
        return self.completed

    def synchronize(self):
        self.waited = self.completed = True

    def elapsed_time(self, end):
        return end.t_ms - self.t_ms


def _mark(t_ms, host_us):
    m = trace.Mark.__new__(trace.Mark)
    m.event, m.host_us = _Event(t_ms), host_us
    return m


def test_device_timed_span_waits_for_its_end_mark():
    """``dur`` is the marks' device time, filled in only once the device
    has passed the end mark; ``host_us`` is the host's enqueue time."""
    obs.enable()
    m0, m1 = _mark(10.0, 100.0), _mark(12.5, 130.0)
    m2, m3 = _mark(20.0, 200.0), _mark(21.0, 240.0)
    obs.record_span("exec.step", m0.host_us, {"step": 0}, marks=(m0, m1))
    obs.record_span("exec.step", m2.host_us, {"step": 1}, marks=(m2, m3))
    raw = [e for e in trace._events if e.get("ev") == "span"]
    assert [e["dur"] for e in raw] == [None, None]
    assert [e["attrs"]["host_us"] for e in raw] == [30.0, 40.0]
    assert [e["ts"] for e in raw] == [100.0, 200.0]
    m1.event.completed = True
    obs.resolve()                       # never waits: only the first is done
    assert [e["dur"] for e in raw] == [2500.0, None]
    assert not m3.event.waited
    steps = _spans("exec.step")         # reading waits for the rest
    assert [e["dur"] for e in steps] == [2500.0, 1000.0]
    assert m3.event.waited and not trace._pending
    assert obs.validate_trace([{"ev": "meta", "schema": obs.TRACE_SCHEMA,
                                "pid": 0}] + steps) == []


def test_cpu_marks_time_the_host():
    obs.enable()
    m0 = obs.Mark(torch.device("cpu"))
    m1 = obs.Mark(torch.device("cpu"))
    assert m0.event is None and m1.done()
    obs.record_span("exec.step", m0.host_us, marks=(m0, m1))
    e, = _spans("exec.step")
    assert e["dur"] == pytest.approx(m1.host_us - m0.host_us)
    assert e["attrs"]["host_us"] == e["dur"]


def test_tracing_needs_no_torch():
    """Tracing on, with no profiler, imports nothing of torch; the
    package stays importable without it."""
    code = ("import sys\n"
            "from repro_torch import obs\n"
            "obs.enable()\n"
            "with obs.span('serve.batch'):\n"
            "    obs.record_span('exec.step', obs.now_us())\n"
            "assert len(obs.events()) == 2\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]


def test_served_batch_spans_hang_off_their_batch(cache):
    obs.enable()
    cfg = ServeConfig(graph="tiny", max_batch=4, workers=2, device="cpu")
    with ServeEngine(cfg, cache=cache) as eng:
        eng.serve(_samples(eng.sample_shape, 7))
    batches = _spans("serve.batch")
    assert sum(b["attrs"]["batch"] for b in batches) == 7
    assert len({b["attrs"]["batch_id"] for b in batches}) == len(batches)
    by_id = {e["id"]: e for e in _spans()}
    for name in SERVE_SPANS:
        got = _spans(name)
        assert len(got) == len(batches), name
        for e in got:
            parent = by_id[e["parent"]]
            assert parent["name"] == "serve.batch"
            assert e["tid"] == parent["tid"]
            if name != "exec.network":
                assert e["attrs"]["batch"] == parent["attrs"]["batch"]
    steps = _spans("exec.step")
    assert steps and all(by_id[e["parent"]]["name"] == "exec.network"
                         and e["dur"] >= 0 and "host_us" in e["attrs"]
                         for e in steps)


@pytest.mark.parametrize("traced", [True, False])
def test_served_spans_in_the_profilers_trace(cache, tmp_path, traced):
    """With tracing on under a profiler session that sees every thread,
    a served batch's spans are ``user_annotation`` ranges on the worker
    that ran it, nested in its ``serve.batch``; with tracing off, none."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, record_function

    cfg = ServeConfig(graph="tiny", max_batch=4, workers=1, device="cpu")
    with ServeEngine(cfg, cache=cache) as eng:
        samples = _samples(eng.sample_shape, 4, seed=1)
        eng.serve(samples)                           # warm
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            if traced:
                obs.enable()
            with record_function("client"):
                eng.serve(samples)
            obs.disable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    client, = [e for e in evs if e["name"] == "client"]
    named = [e for e in evs if e["name"] in ("serve.batch",) + SERVE_SPANS]
    if not traced:
        assert named == []
        return
    batches = [e for e in named if e["name"] == "serve.batch"]
    assert batches and all(b["tid"] != client["tid"] for b in batches)
    for b in batches:                                # on a worker thread
        inside = sorted((e for e in named if e["tid"] == b["tid"]
                         and e is not b and b["ts"] <= e["ts"]
                         and e["ts"] + e["dur"] <= b["ts"] + b["dur"]),
                        key=lambda e: e["ts"])
        assert [e["name"] for e in inside] == list(SERVE_SPANS)
    assert len(named) == len(batches) * (1 + len(SERVE_SPANS))


def test_lm_batch_times_prefill_and_decode_only_when_traced(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    cfg = ServeConfig(arch="llama3p2_3b", smoke=True, device="cpu",
                      max_batch=2, prompt_len=8, gen=4, workers=1)
    prompts = [np.arange(8) % 7, np.arange(8) % 5]
    with ServeEngine(cfg) as eng:
        off = eng.serve(prompts)
        assert obs.hist_samples("serve.prefill_ms") == []
        obs.enable()
        on = eng.serve(prompts)
    assert calls == []
    for a, b in zip(off, on):
        assert np.array_equal(a, b)
    assert len(obs.hist_samples("serve.prefill_ms")) == 1
    assert len(obs.hist_samples("serve.decode_ms_per_token")) == 1
    assert all(v > 0 for v in obs.hist_samples("serve.prefill_ms"))
    assert obs.hist_samples("serve.ttft_ms") == []
