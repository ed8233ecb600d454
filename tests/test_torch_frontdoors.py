"""The port's front doors on the CPU: its examples and its serve benchmark.

Each of ``examples/quickstart_torch.py``, ``examples/serve_lm_torch.py``
and ``examples/train_lm_torch.py`` runs with ``--device cpu`` at SMOKE
size in a subprocess, and ``benchmarks/serve_bench_torch.py`` on the tiny
graph: exit 0, its printed rows, batched outputs equal to sequential ones
and at least ``MIN_SPEEDUP`` (64 requests in batches of 8: on the tiny
graph a batch's fixed cost dominates, and batching pays ~6x on the CPU).
Without ``--device`` an example asks for CUDA and, here, raises.  All the
subprocesses start together.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

RUNS = {
    "quickstart": ["examples/quickstart_torch.py", "--device", "cpu",
                   "--steps", "3"],
    "quickstart_zamba2": ["examples/quickstart_torch.py", "--device", "cpu",
                          "--steps", "2", "--arch", "zamba2_2p7b"],
    "serve_lm": ["examples/serve_lm_torch.py", "--device", "cpu",
                 "--requests", "6", "--gen", "6"],
    "train_lm": ["examples/train_lm_torch.py", "--device", "cpu",
                 "--steps", "8", "--fail-at", "5"],
    "serve_bench": ["-m", "benchmarks.serve_bench_torch", "--graph", "tiny",
                    "--device", "cpu", "--requests", "64", "--max-batch",
                    "8"],
    "no_cuda": ["examples/quickstart_torch.py", "--steps", "1"],
}


@pytest.fixture(scope="module")
def ran():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    procs = {name: subprocess.Popen(
        [sys.executable] + args, env=env,
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, args in RUNS.items()}
    out = {}
    for name, p in procs.items():
        so, se = p.communicate(timeout=600)
        out[name] = (p.returncode, so, se)
    return out


@pytest.mark.parametrize("name", ["quickstart", "quickstart_zamba2"])
def test_quickstart_torch(ran, name):
    code, so, se = ran[name]
    assert code == 0, se[-3000:]
    losses = [float(x) for x in re.findall(r"loss=([0-9.]+)", so)]
    assert losses and all(0 < v < 10 for v in losses)
    decoded = re.search(r"decoded: \[([0-9, ]+)\]", so)
    assert decoded and len(decoded.group(1).split(",")) == 8


def test_serve_lm_torch(ran):
    code, so, se = ran["serve_lm"]
    assert code == 0, se[-3000:]
    assert "arch=zamba2_2p7b: 6 requests" in so
    assert "36 tokens in" in so
    assert len(re.findall(r"^  req\d: \[", so, re.M)) == 3


def test_train_lm_torch_resumes(ran):
    """The injected failure at step 5 restores the step-4 checkpoint (one
    every 8 // 4 steps) and the run finishes."""
    code, so, se = ran["train_lm"]
    assert code == 0, se[-3000:]
    assert "restored checkpoint @ step 4" in so
    assert "done: restarts=1" in so


def test_serve_bench_torch_gate(ran):
    """Its rows as ``serve_bench.py`` prints them: batched outputs equal
    to sequential ones, at least 1.5x, and batches above 1."""
    code, so, se = ran["serve_bench"]
    assert code == 0, se[-3000:]
    assert "serve_bench.sequential," in so
    mean_batch = re.search(r"^serve_bench\.batched,.*;mean_batch=([0-9.]+)$",
                           so, re.M)
    speedup = re.search(r"^serve_bench\.speedup,([0-9.]+),x;identical=(\w+)$",
                        so, re.M)
    assert mean_batch and float(mean_batch.group(1)) > 1
    assert speedup and speedup.group(2) == "True"
    assert float(speedup.group(1)) >= 1.5


def test_examples_ask_for_cuda_by_default(ran):
    code, so, se = ran["no_cuda"]
    assert code != 0
    assert "CUDA is not available" in se


def test_serve_bench_torch_fails_below_the_gate(monkeypatch, capsys):
    """Below ``MIN_SPEEDUP`` (or with outputs that differ) the benchmark
    exits non-zero; at or above it returns its entry."""
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import serve_bench_torch as sb
    finally:
        sys.path.remove(str(ROOT))

    def fake(speedup, identical=True):
        row = {"wall_s": 1.0, "throughput_rps": 1.0, "p50_ms": 1.0,
               "p99_ms": 1.0, "mean_batch": 1.0}
        return lambda *a: {"batched": row, "sequential": row,
                           "speedup": speedup,
                           "outputs_identical": identical}

    monkeypatch.setattr(sb, "run", fake(1.49))
    with pytest.raises(SystemExit) as e:
        sb.main(["--device", "cpu"])
    assert e.value.code == 1
    assert "speedup 1.49x < 1.5x" in capsys.readouterr().err
    monkeypatch.setattr(sb, "run", fake(2.0, identical=False))
    with pytest.raises(SystemExit):
        sb.main(["--device", "cpu"])
    monkeypatch.setattr(sb, "run", fake(1.5))
    assert sb.main(["--device", "cpu"])["speedup"] == 1.5
