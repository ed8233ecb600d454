"""The port's runtime around the main path, on the CPU, against the JAX
package's: the fault-tolerance runtime (each of ``tests/test_substrates.py``'s
tests as two cases, one a package), the chaos harness, the serve CLI, both
smokes, the model-vs-measured report on a trace the port wrote, and the
Tab. IV accelerator baselines.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.accel_models as jaccel
import repro.obs.report as jreport
import repro.runtime as jruntime
from repro import obs as jobs
from repro.core import workloads as jworkloads
from repro_torch import obs
from repro_torch import runtime
from repro_torch.core import accel_models
from repro_torch.core import workloads
from repro_torch.launch import serve as serve_cli
from repro_torch.obs import report
from repro_torch.obs import smoke as obs_smoke
from repro_torch.runtime import chaos, faults
from repro_torch.serve import build_graph
from repro_torch.serve import smoke as serve_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = {"repro": types.SimpleNamespace(rt=jruntime, obs=jobs),
            "repro_torch": types.SimpleNamespace(rt=runtime, obs=obs)}


@pytest.fixture(params=sorted(PACKAGES))
def rt(request):
    """Each package's ``runtime``, its obs recording for the test."""
    p = PACKAGES[request.param]
    p.obs.reset()
    p.obs.enable()
    yield p.rt
    p.rt.disarm()
    p.obs.reset()


# ------------------------------------------------- fault tolerance, both
def test_heartbeat_registry(rt):
    t = [0.0]
    reg = rt.HeartbeatRegistry(["h0", "h1", "h2"], timeout_s=10,
                               clock=lambda: t[0])
    t[0] = 5.0
    reg.beat("h0")
    t[0] = 12.0
    assert reg.alive() == {"h0"}
    assert reg.dead() == {"h1", "h2"}


def test_elastic_mesh_plan(rt):
    plan = rt.plan_elastic_mesh([f"h{i}" for i in range(30)],
                                chips_per_host=8, model_axis=16,
                                old_data_axis=16)
    assert plan.model == 16
    assert plan.data == 8            # 240 chips -> 8x16 = 128 used (pow2 DP)
    assert plan.chips == 128
    assert plan.dropped_batch_shards == 8


def test_straggler_monitor(rt):
    mon = rt.StragglerMonitor(threshold=1.5, patience=2, ewma=0.0)
    for step in range(4):
        for h in ("a", "b", "c", "d"):
            mon.record(h, 1.0 if h != "d" else 3.0)
        flagged = mon.stragglers()
    assert flagged == {"d"}


def test_supervisor_restart_resumes_from_checkpoint(rt):
    state = {"ckpt": 0, "fail_at": 7, "failed": [False]}
    executed = []

    def step_fn(step):
        if step == state["fail_at"] and not state["failed"][0]:
            state["failed"][0] = True
            raise RuntimeError("simulated node failure")
        executed.append(step)
        return {"step": step}

    sup = rt.TrainSupervisor(
        total_steps=12, step_fn=step_fn, save_every=5,
        save_fn=lambda s: state.__setitem__("ckpt", s),
        restore_fn=lambda: state["ckpt"],
        failure_detector=lambda: False,
        restart_fn=lambda: None)
    restarts, history = sup.run()
    assert restarts == 1
    # steps 5,6 re-executed after restore from ckpt@5
    assert executed.count(5) == 2 and executed.count(6) == 2
    assert sorted(set(executed)) == list(range(12))


def test_heartbeat_register_and_forget(rt):
    t = [0.0]
    reg = rt.HeartbeatRegistry(["h0"], timeout_s=10, clock=lambda: t[0])
    t[0] = 25.0
    reg.register("h1")               # fresh arrival counts as alive now
    assert reg.hosts() == {"h0", "h1"}
    assert reg.alive() == {"h1"}     # h0 aged out, h1 just registered
    assert reg.dead() == {"h0"}
    reg.forget("h0")
    assert reg.hosts() == {"h1"}
    assert reg.dead() == set()
    reg.forget("never-registered")   # idempotent, no raise


def test_heartbeat_sync_to_plan(rt):
    t = [0.0]
    reg = rt.HeartbeatRegistry(["h0", "h1", "h2"], timeout_s=10,
                               clock=lambda: t[0])
    remesh = rt.plan_elastic_mesh(["h1", "h2", "h3"], chips_per_host=8,
                                  model_axis=8, old_data_axis=3)
    reg.sync_to_plan(remesh)
    assert reg.hosts() == set(remesh.hosts_used)
    assert "h0" not in reg.hosts()   # dropped host forgotten
    assert set(remesh.hosts_used) <= reg.alive() | reg.dead()
    assert reg.dead() == set()


def test_heartbeat_absorbs_injected_drops(rt):
    """The ``heartbeat`` site: a dropped packet is a missed beat counted
    in ``heartbeat.dropped``, never a crash."""
    obs_mod = PACKAGES["repro" if rt is jruntime else "repro_torch"].obs
    sched = rt.FaultSchedule(seed=0, sites={
        "heartbeat": rt.SiteSpec(count=2, exc="ConnectionError")})
    reg = rt.HeartbeatRegistry(["host0"])
    with rt.injecting(sched):
        for _ in range(4):
            reg.beat("host0")
    assert "host0" in reg.alive()
    assert sched.injected("heartbeat") == 2
    assert obs_mod.counter_value("heartbeat.dropped",
                                 type="ConnectionError") == 2


def test_elastic_mesh_non_pow2_survivors(rt):
    plan = rt.plan_elastic_mesh(["h0", "h1", "h2"], chips_per_host=8,
                                model_axis=8, old_data_axis=3)
    assert (plan.data, plan.model) == (2, 8)
    assert plan.chips == 16
    assert plan.hosts_used == ("h0", "h1")
    assert plan.dropped_batch_shards == 3 - 2


def test_elastic_mesh_exactly_one_model_group(rt):
    plan = rt.plan_elastic_mesh(["h0"], chips_per_host=8, model_axis=8,
                                old_data_axis=4)
    assert (plan.data, plan.model) == (1, 8)
    assert plan.chips == 8
    assert plan.hosts_used == ("h0",)
    assert plan.dropped_batch_shards == 3


def test_elastic_mesh_zero_survivors(rt):
    with pytest.raises(RuntimeError):
        rt.plan_elastic_mesh([], chips_per_host=8, model_axis=8,
                             old_data_axis=4)
    with pytest.raises(RuntimeError):
        rt.plan_elastic_mesh(["h0"], chips_per_host=4, model_axis=8,
                             old_data_axis=4)


def test_straggler_true_median_two_hosts(rt):
    mon = rt.StragglerMonitor(threshold=1.5, patience=2, ewma=0.0)
    for _ in range(2):
        mon.record("fast", 1.0)
        mon.record("slow", 4.0)
        flagged = mon.stragglers()
    assert flagged == {"slow"}


def test_straggler_two_host_tie_flags_nobody(rt):
    mon = rt.StragglerMonitor(threshold=1.5, patience=1, ewma=0.0)
    for _ in range(3):
        mon.record("a", 2.0)
        mon.record("b", 2.0)
        assert mon.stragglers() == set()


def test_supervisor_backoff_sleeps_between_restarts(rt):
    t = [0.0]
    slept = []

    def sleep(d):
        slept.append(d)
        t[0] += d

    fails = {"left": 2}

    def step_fn(step):
        if fails["left"] and step == 3:
            fails["left"] -= 1
            raise RuntimeError("boom")
        return {"step": step}

    sup = rt.TrainSupervisor(
        total_steps=6, step_fn=step_fn, save_every=100,
        save_fn=lambda s: None, restore_fn=lambda: 3,
        failure_detector=lambda: False, restart_fn=lambda: None,
        backoff=rt.RetryPolicy(max_attempts=1, base_delay_s=0.1,
                               max_delay_s=5.0, jitter=0.0),
        sleep=sleep, clock=lambda: t[0])
    restarts, history = sup.run()
    assert restarts == 2
    assert slept == [0.1, 0.2]
    assert len(history) == 6


def test_supervisor_restart_window_expires_old_restarts(rt):
    t = [0.0]
    fails = {"n": 0}

    def step_fn(step):
        t[0] += 10.0                  # each step takes 10s of fake time
        if step == 2 and fails["n"] < 4:
            fails["n"] += 1
            raise RuntimeError("flaky step")
        return {"step": step}

    common = dict(
        total_steps=4, step_fn=step_fn, save_every=100,
        save_fn=lambda s: None, restore_fn=lambda: 2,
        failure_detector=lambda: False, restart_fn=lambda: None,
        max_restarts=2,
        backoff=rt.RetryPolicy(max_attempts=1, base_delay_s=0.0, jitter=0.0),
        sleep=lambda d: None, clock=lambda: t[0])
    with pytest.raises(RuntimeError, match="flaky step"):
        rt.TrainSupervisor(**common).run()
    fails["n"] = 0
    t[0] = 0.0
    restarts, history = rt.TrainSupervisor(
        **dict(common, restart_window_s=5.0)).run()
    assert restarts == 4
    assert len(history) == 4


def test_supervisor_drives_checkpoint_resume(tmp_path):
    """``api.TrainSupervisor`` over the port's ``CheckpointManager``: a
    step that fails once restarts from the last checkpoint and ends with
    the state of an unbroken run."""
    from repro_torch import api
    mgr = api.CheckpointManager(tmp_path)
    w = {"w": torch.zeros(4)}
    failed = []

    def step_fn(step):
        if step == 6 and not failed:
            failed.append(step)
            raise RuntimeError("node lost")
        w["w"].add_(step)
        return {"step": step}

    def save(step):
        mgr.save(step, {"w": w["w"], "step": np.int32(step)})
        assert mgr.wait(30)

    def restore():
        step, tree = mgr.restore_latest({"w": torch.zeros(4),
                                         "step": np.int32(0)})
        w["w"].copy_(tree["w"])
        return int(tree["step"])

    try:
        restarts, _ = api.TrainSupervisor(
            total_steps=10, step_fn=step_fn, save_every=4, save_fn=save,
            restore_fn=restore, failure_detector=lambda: False,
            restart_fn=lambda: None, sleep=lambda d: None).run()
    finally:
        mgr.close()
    assert restarts == 1 and failed == [6]
    assert torch.equal(w["w"], torch.full((4,), float(sum(range(10)))))


# ------------------------------------------------------------------- chaos
def test_chaos_holds_its_three_claims_on_the_cpu(tmp_path):
    """Every scheduled fault fires, none escapes, outputs bit-identical at
    tier <= replanned; and the report, every phase's per-site summary and
    every counter, equals the JAX harness's for the same seed, graph and
    arch."""
    from repro.runtime import chaos as jchaos
    got, want = tmp_path / "port.json", tmp_path / "jax.json"
    assert chaos.main(["--graph", "tiny", "--device", "cpu", "--report",
                       str(got)]) == 0
    assert jchaos.main(["--graph", "tiny", "--report", str(want)]) == 0
    rep, ref = json.loads(got.read_text()), json.loads(want.read_text())
    assert sorted(rep) == ["counters", "engine", "network", "seed", "serve"]
    for phase in ("network", "engine", "serve"):
        assert rep[phase] == ref[phase], phase
    assert rep["counters"] == ref["counters"]
    assert rep["serve"]["faulted_tier"] == "replanned"


def test_chaos_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chaos.main(["--graph", "tiny", "--skip-serve"])


# --------------------------------------------------------------- serve CLI
def test_serve_cli_network_mode_on_the_cpu(capsys):
    from repro_torch import api
    out = serve_cli.main(["--graph", "tiny", "--batch", "4", "--workers",
                          "2", "--device", "cpu"])
    log = capsys.readouterr().out
    assert "checksum=" in log and "tier=" in log
    outs, config = out["outputs"], out["config"]
    assert len(outs) == 4 and outs[0].shape == (8, 8, 128)
    g = build_graph(config.graph)
    rng = np.random.default_rng(config.seed)   # the CLI's samples
    xs = np.stack([rng.standard_normal(g.input_shape()[1:])
                   .astype(np.float32) for _ in range(4)])
    ref = api.execute_network_reference(
        g, torch.from_numpy(xs), api.init_graph_weights(list(g.layers),
                                                        seed=0),
        device="cpu").numpy()
    np.testing.assert_allclose(np.stack(outs), ref, rtol=1e-4, atol=1e-3)
    want = float(np.sum(np.stack(outs)))
    assert f"checksum={want:.6f}" in log


def test_serve_cli_lm_mode_on_the_cpu(capsys):
    out = serve_cli.main(["--arch", "rwkv6_1p6b", "--smoke", "--batch", "2",
                          "--prompt-len", "8", "--gen", "4", "--device",
                          "cpu"])
    log = capsys.readouterr().out
    assert "sample tokens" in log and "arch=rwkv6-1.6b" in log
    assert [o.shape for o in out["outputs"]] == [(4,), (4,)]
    assert out["outputs"][0].dtype == np.int32


def test_serve_cli_refuses_what_is_not_ported(monkeypatch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        serve_cli.main(["--graph", "tiny", "--model-axis", "2", "--device",
                        "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--graph", "tiny"])


# ------------------------------------------------------------------ smokes
def test_serve_smoke_on_the_cpu(capsys):
    assert serve_smoke.main(["--device", "cpu"]) == 0
    assert "batched == sequential bit-identical" in capsys.readouterr().out
    obs.reset()


@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    """The obs smoke's trace of the tiny graph, written by the port."""
    path = tmp_path_factory.mktemp("obs") / "trace.jsonl"
    rc = obs_smoke.main(["--graph", "tiny", "--check-identical", "--out",
                         str(path), "--device", "cpu"])
    obs.reset()
    return rc, path


def test_obs_smoke_on_the_cpu(port_trace):
    rc, path = port_trace
    assert rc == 0
    events = obs.read_trace(path)
    assert obs.validate_trace(events) == []
    assert sum(1 for e in events if e.get("ev") == "span"
               and e["name"] == "exec.step") == 3


def test_smokes_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_smoke.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        obs_smoke.main(["--out", str(tmp_path / "t.jsonl")])
    obs.reset()


# ------------------------------------------------------------------ report
def test_both_reports_read_a_port_trace_alike(port_trace):
    """The "Obs names" rule: ``repro.obs.report`` and the port's copy give
    the same report on one trace the port wrote."""
    _, path = port_trace
    events = report.read_trace(path)
    ours = report.build_report(events)
    theirs = jreport.build_report(jreport.read_trace(path))
    assert ours == theirs
    assert report.format_report(ours) == jreport.format_report(theirs)
    assert len(ours["steps"]) == 3
    assert all(r["measured_us"] > 0 and r["modeled_us"] > 0
               for r in ours["steps"])


def test_repro_report_validates_a_port_trace(port_trace):
    _, path = port_trace
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "repro.obs.report",
                          str(path), "--validate"], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "per-plan-step modeled vs measured" in out.stdout
    assert report.main([str(path), "--validate", "--json"]) == 0


# ----------------------------------------------------------- accel models
NETS = {"resnet50": "resnet50_layers", "mobv3": "mobilenet_v3_layers"}


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("model", [m.name for m in jaccel.ALL_MODELS])
def test_accel_model_run_matches_repro(net, model):
    """Tab. IV: each baseline's per-layer search results are the same in
    both packages (the port's ``core/accel_models.py`` is a copy)."""
    ours = {m.name: m for m in accel_models.ALL_MODELS}[model]
    theirs = {m.name: m for m in jaccel.ALL_MODELS}[model]
    got = ours.run(getattr(workloads, NETS[net])())
    want = theirs.run(getattr(jworkloads, NETS[net])())
    assert len(got) == len(want) > 10
    assert [repr(r) for r in got] == [repr(r) for r in want]


def test_feather_beats_fixed_baselines_in_the_port():
    """``tests/test_system.py``'s Fig. 13 direction, on the port's copy."""
    layers = workloads.resnet50_layers()[:6]
    feather = accel_models.FEATHER.run(layers)
    for base_model in (accel_models.NVDLA_LIKE, accel_models.EYERISS_LIKE,
                       accel_models.SIGMA_C32):
        base = base_model.run(layers)
        assert sum(r.metrics.cycles for r in feather) <= \
            sum(r.metrics.cycles for r in base) * 1.01, base_model.name


def test_faults_site_registry_is_unchanged():
    """Chaos's schedules cover every site the port's registry names."""
    assert set(faults.SITES) == set(jruntime.SITES)
