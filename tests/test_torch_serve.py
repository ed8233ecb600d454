"""The port's serve engine on the CPU against the JAX package's, and the
port's import hygiene.

The serving contract carries over unchanged: a request's output is
bit-identical whether it was served alone or batched with strangers, and
the outputs agree with ``repro.serve.ServeEngine(use_pallas=False)`` on the
same requests (rtol 1e-4, atol 1e-3: fp32 GEMMs summed in other orders).
LM serving (SMOKE llama3.2-3b, the JAX parameters carried across) gives the
tokens of a JAX greedy loop that mirrors the JAX engine's LM backend,
wherever JAX's top-1/top-2 logit gap is over 10x the logit tolerance.
"""
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import api, obs
from repro_torch.plan import PlanCache
from repro_torch.runtime import faults
from repro_torch.serve import (QueueFullError, ServeConfig,
                               ServeEngine, ServeError, build_graph)


def _nosleep(_s: float) -> None:
    return None


@pytest.fixture(scope="module")
def cache():
    """One warm PlanCache for the module: tiny is planned once."""
    return PlanCache()


@pytest.fixture(autouse=True)
def _tracing():
    """Counters/histograms are no-ops with tracing off; run traced."""
    obs.reset()
    obs.enable()
    yield
    obs.reset()


def _samples(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def test_batched_equals_sequential_and_matches_jax(cache):
    cfg = ServeConfig(graph="tiny", max_batch=4, workers=2, device="cpu")
    seq_cfg = ServeConfig(graph="tiny", max_batch=4, workers=1,
                          assemble_max=1, device="cpu")
    with ServeEngine(cfg, cache=cache) as eng, \
            ServeEngine(seq_cfg, cache=cache) as seq:
        assert eng.resolved.tier <= 1
        samples = _samples(eng.sample_shape, 11, seed=11)
        got = eng.serve(samples)
        want = seq.serve(samples)
    for i, (a, b) in enumerate(zip(got, want)):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        assert np.array_equal(a, b), i
    assert obs.counter_value("serve.requests") == 22
    assert obs.hist_stats("serve.e2e_ms")["count"] == 22
    with JServeEngine(JServeConfig(graph="tiny", max_batch=4, workers=2,
                                   use_pallas=False)) as jeng:
        assert jeng.resolved.plan.to_json() == eng.resolved.plan.to_json()
        theirs = jeng.serve(samples)
    for a, b in zip(got, theirs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-3)


def test_execute_requests_matches_full_batch():
    graph = build_graph("tiny").with_batch(4)
    resolved = api.resolve_plan(graph, api.EvalConfig(),
                                opts=api.PlannerOptions(
                                    switch_modes=("rir",),
                                    layouts=(api.Layout.parse("HWC_C32"),),
                                    parallel_dims=("C", "P", "Q")))
    ws = api.init_graph_weights(list(graph.layers), seed=0)
    prepared = api.prepare_network(resolved.plan, graph, ws, device="cpu")
    samples = _samples(prepared.input_shape[1:], 3, seed=3)
    outs = prepared.execute_requests(samples)
    full = prepared(prepared.assemble_batch(samples))
    for i, o in enumerate(outs):
        assert torch.equal(o, full[i])
    with pytest.raises(ValueError):
        prepared.assemble_batch(samples * 2)        # 6 > max_batch
    with pytest.raises(ValueError):
        prepared.assemble_batch([])


def test_config_device_and_lm_mode(monkeypatch):
    assert ServeConfig(graph="tiny").device == "cuda"
    lm = ServeConfig(arch="llama3p2_3b")
    assert lm.device == "cuda" and (lm.prompt_len, lm.gen) == (32, 16)
    assert ServeConfig(arch="rwkv6_1p6b").device == "cuda"
    assert ServeConfig(arch="zamba2_2p7b").device == "cuda"
    for arch in ("whisper_small", "dbrx_132b", "llama4_scout_17b"):
        cfg = ServeConfig(arch=arch, smoke=True)     # every family serves
        assert cfg.arch == arch and cfg.device == "cuda"
        assert ServeConfig(arch=arch).arch == arch
    with pytest.raises(ValueError):
        ServeConfig(arch="llama3p2_3b", graph="tiny")
    with pytest.raises(ValueError):
        ServeConfig(arch="llama3p2_3b", gen=0)
    with pytest.raises(ValueError):
        ServeConfig(graph="tiny", max_batch=4, assemble_max=5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(ServeConfig(graph="tiny"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(ServeConfig(arch="llama3p2_3b"))   # before any weight


LM_TOL = 1e-5    # the LM parity tests' logit atol


def _jax_greedy(jm, params, prompts, B, gen):
    """The JAX engine's LM loop (``repro.serve.engine._LMBackend.run``):
    prompts padded to ``B`` rows, prefill, argmax, ``gen - 1`` decode
    steps.  Returns tokens (B, gen) and each step's top-1/top-2 gap."""
    P = prompts.shape[1]
    pad = np.zeros((B, P), np.int32)
    pad[:len(prompts)] = prompts
    decode = jax.jit(jm.decode_step)
    cache, logits = jm.prefill(params, jnp.asarray(pad), P + gen)
    toks, gaps = [], []
    for step in range(gen):
        if step:
            cache, logits = decode(params, cache, toks[-1])
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        toks.append(jnp.argmax(logits, axis=-1))
    return np.stack([np.asarray(t) for t in toks], 1), np.stack(gaps, 1)


def test_lm_serve_matches_jax_greedy_and_sequential():
    B, P, gen = 4, 8, 5
    jm = jbuild_model(jget_config("llama3p2_3b", smoke=True))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    cfg = ServeConfig(arch="llama3p2_3b", smoke=True, max_batch=B,
                      prompt_len=P, gen=gen, workers=2, device="cpu")
    seq_cfg = ServeConfig(arch="llama3p2_3b", smoke=True, max_batch=B,
                          prompt_len=P, gen=gen, assemble_max=1,
                          device="cpu")
    weights = api.to_torch_lm_params(params, api.get_config(
        "llama3p2_3b", smoke=True), device="cpu")
    rng = np.random.default_rng(12)
    prompts = rng.integers(0, 512, size=(6, P)).astype(np.int32)
    with ServeEngine(cfg, weights=weights) as eng, \
            ServeEngine(seq_cfg, weights=weights) as seq:
        assert eng.sample_shape == (P,)
        got = eng.serve(list(prompts))
        want = seq.serve(list(prompts))
        with pytest.raises(ServeError):
            eng.submit(prompts[0][:3])                 # not prompt_len long
    assert obs.hist_stats("serve.prefill_ms")["count"] >= 2
    assert obs.hist_stats("serve.decode_ms_per_token")["count"] >= 2
    for a, b in zip(got, want):
        assert a.dtype == np.int32 and a.shape == (gen,)
        assert np.array_equal(a, b)
    # the JAX loop over the same batch composition as the sequential run:
    # request i alone in a batch padded with zero prompts
    checked = 0
    for i in (0, 5):
        toks, gaps = _jax_greedy(jm, params, prompts[i:i + 1], B, gen)
        for t in range(gen):
            if gaps[0, t] <= 10 * LM_TOL:
                break                    # a near tie: later inputs may differ
            assert got[i][t] == toks[0, t], (i, t)
            checked += 1
    assert checked >= gen               # most steps are decided by a margin


def test_backpressure_faults_and_stop(cache):
    cfg = ServeConfig(graph="tiny", max_batch=2, workers=1, queue_capacity=2,
                      device="cpu")
    with ServeEngine(cfg, cache=cache) as eng:
        release = threading.Event()
        real_run = eng._backend.run

        def stalled_run(prepared, payloads):
            assert release.wait(30.0), "test released too late"
            return real_run(prepared, payloads)

        eng._backend.run = stalled_run
        tickets, rejected = [], 0
        for i in range(8):
            try:
                tickets.append(eng.submit(_samples(eng.sample_shape, 1,
                                                   seed=i)[0]))
            except QueueFullError as e:
                assert e.reason == "capacity"
                rejected += 1
        assert rejected >= 1
        release.set()
        for t in tickets:
            assert np.isfinite(t.result(timeout=30.0)).all()
        schedule = faults.FaultSchedule(seed=0, sites={
            "serve.queue": faults.SiteSpec(count=1, exc="ConnectionError")})
        with faults.injecting(schedule):
            with pytest.raises(QueueFullError) as ei:
                eng.submit(tickets[0].payload)
        assert ei.value.reason == "fault"
        with pytest.raises(ServeError):
            eng.submit(np.zeros((3,), np.float32))             # bad shape
    with pytest.raises(QueueFullError) as ei:
        eng.submit(tickets[0].payload)
    assert ei.value.reason == "stopped"


def test_degraded_engine_upgrades_in_background(cache):
    down = faults.FaultSchedule(seed=0, sites={
        "plan.replan": faults.SiteSpec(count=3, exc="RuntimeError")})
    cfg = ServeConfig(graph="tiny", max_batch=2, workers=1,
                      upgrade_interval_s=0.01, layouts=("HWC_C32",),
                      device="cpu")
    with faults.injecting(down):
        eng = ServeEngine(cfg, cache=cache, sleep=_nosleep)
        assert eng.resolved.tier_name == "greedy"
    with eng:
        out = eng.serve(_samples(eng.sample_shape, 2))
        waiter = threading.Event()
        for _ in range(3000):
            if eng.resolved.tier <= 1:
                break
            waiter.wait(0.01)
        assert eng.resolved.tier == 1, "background upgrade never landed"
        again = eng.serve(_samples(eng.sample_shape, 2))
    assert obs.counter_value("serve.plan_upgrade") == 1
    for a, b in zip(out, again):
        assert a.shape == b.shape and np.isfinite(b).all()


_HYGIENE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
import importlib.util, pathlib
root = pathlib.Path(repro_torch.__file__).resolve().parents[2]
for rel in ("examples/quickstart_torch.py", "examples/serve_lm_torch.py",
            "examples/train_lm_torch.py", "benchmarks/serve_bench_torch.py"):
    spec = importlib.util.spec_from_file_location(
        pathlib.Path(rel).stem, root / rel)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(rel)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
for mod in ("repro_torch.kernels.rir_matmul", "repro_torch.kernels.gqa_decode",
            "repro_torch.kernels.linear_scan", "repro_torch.models.lm",
            "repro_torch.models.ssm", "repro_torch.configs.llama3p2_3b",
            "repro_torch.optim.adamw", "repro_torch.optim.schedule",
            "repro_torch.data.pipeline", "repro_torch.distributed.stepfn",
            "repro_torch.launch.train", "repro_torch.core.birrd",
            "repro_torch.core.rir", "repro_torch.kernels.birrd_reduce",
            "repro_torch.models.hybrid", "repro_torch.launch.coswitch",
            "repro_torch.configs.zamba2_2p7b", "repro_torch.checkpoint",
            "repro_torch.checkpoint.store", "repro_torch.runtime.chaos",
            "repro_torch.runtime.fault_tolerance", "repro_torch.launch.serve",
            "repro_torch.obs.report", "repro_torch.obs.smoke",
            "repro_torch.serve.smoke", "repro_torch.core.accel_models",
            "repro_torch.models.encdec", "repro_torch.models.blocks",
            "repro_torch.configs.whisper_small",
            "repro_torch.configs.dbrx_132b", "repro_torch.core.gpu_cost",
            "repro_torch.core.trace_cost", "repro_torch.launch.dryrun",
            "repro_torch.launch.specs", "repro_torch.launch.roofline",
            "repro_torch.check",
            "repro_torch.check.__main__", "repro_torch.check.api_lint",
            "repro_torch.check.docs_gen", "repro_torch.check.plan_lint",
            "repro_torch.check.registry_lint", "repro_torch.check.smoke",
            "repro_torch.check.thread_lint"):
    assert mod in names and mod in sys.modules, mod
"""


def test_port_imports_no_jax_and_no_repro():
    """Every port module, the port's examples (``examples/*_torch.py``) and
    its serve benchmark (``benchmarks/serve_bench_torch.py``) import with
    neither jax nor the JAX package."""
    import os
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env["PYTHONPATH"] = src
    out = subprocess.run([sys.executable, "-c", _HYGIENE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.strip().endswith("[]")
