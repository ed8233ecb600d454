"""A training cell on the CPU: the harness drives the port's training step
at a small size and the plain reference agrees with it; each planted
fault, and the control, comes out not correct; a configuration that only
adds files runs with no edit to the harness."""
import dataclasses
import json
import math
import shutil

import numpy as np
import pytest
import torch

from bench import cell as C
from bench import faults, spec, train

CELL = "rwkv6_1p6b.train_4k"
#: the CPU's cut: the port's SMOKE rwkv6 widths (2 heads of 32), f32
SMALL = dict(n_layers=2, d_model=64, n_heads=4, d_inner=64, ssm_heads=2,
             d_ff=160, vocab=512, dtype="float32")


def small(name=CELL, s=None):
    """The cell at a size the CPU holds: its configuration with the port's
    sizes overridden and the reference's sizes alike, 64-token sequences."""
    c = spec.find_cell(name, s)
    cfg = dict(c.config, overrides=dict(SMALL), **SMALL)
    return dataclasses.replace(c, config=cfg,
                               traffic=dict(c.traffic, tokens=64, pool=8))


def test_train_path_is_correct():
    out = C.run(small(), 2 ** 31 + 5, 1.0, False, device="cpu")
    assert out.correct, out.checks
    assert set(out.metrics) == {"train_tokens_per_s", "setup_s"}
    assert out.metrics["train_tokens_per_s"]["value"] > 0
    assert out.failed == 0 and out.attempted > 3
    assert out.checks["steps_checked"]["value"] == 2
    for k in ("grad_norm_gap", "change_norm_gap"):
        assert out.checks[k]["value"] < 1e-3 * out.checks[k]["limit"]


@pytest.mark.parametrize("fault", faults.NAMES)
def test_planted_fault_is_not_correct(fault):
    with faults.planted(fault) as hook:
        out = C.run(small(), 17, 0.5, False, device="cpu", hook=hook)
    assert not out.correct, out.checks


def test_control_is_not_correct():
    """The reference with every dense product's operands in fp8 e4m3, put
    in the program's place, fails a limit; the reference in its own place
    reads as good as nothing."""
    c = small()
    mod = train.model_module(c.config)
    K = c.traffic["checked_steps"]
    batches = train.draw_pool(c.config, c.traffic, 21, "cpu")[:K]
    want = train.reference_readings(c.config, c.traffic, mod, 21, "cpu",
                                     batches)
    ctrl = train.reference_readings(c.config, c.traffic, mod, 21, "cpu",
                                    batches, precision="fp8")
    _, ok = train.checks(c.config, train.gaps(ctrl, want), 0, K)
    assert not ok
    _, ok = train.checks(c.config, train.gaps(want, want), 0, K)
    assert ok


def test_reference_agrees_with_the_port():
    """The model module's loss and every gradient against the port's rwkv6
    (f32, CPU) on the same drawn weights: within 1e-5 of max |g|."""
    from repro_torch import api
    c = small()
    cfg, mod = c.config, train.model_module(c.config)
    w = train.draw_weights(cfg, mod, 5, "cpu")
    model = api.build_model(train.port_config(cfg), device="cpu")
    model.load_params(w)
    model.requires_grad_(True)
    tokens = train.draw_pool(cfg, c.traffic, 5, "cpu")[0]
    params = model.params()
    loss = model.loss({"tokens": tokens})
    grads = torch.autograd.grad(loss, list(params.values()))
    want_loss, want = mod.loss_and_grads(cfg, {n: t.float() for n, t
                                               in w.items()}, tokens)
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-5)
    for (n, _), g in zip(params.items(), grads):
        scale = float(want[n].abs().max())
        assert float((g - want[n]).abs().max()) <= 1e-5 * scale, n


def test_scan_moves_the_gradient():
    """At the drawn scale the scan's output moves the first gradient by far
    more than its limit."""
    c = small()
    with faults.planted("scan_zeroed") as hook:
        out = C.run(c, 23, 0.3, False, device="cpu", hook=hook)
    assert out.checks["grad_norm_gap"]["value"] > 10 * c.config["limits"][
        "grad_norm_gap"]


def test_a_new_configuration_is_files_only(tmp_path):
    """A second lm_train configuration and its own model module, written
    to a temporary folder, are found by name and run: nothing of
    ``bench/`` names them."""
    c = spec.find_cell(CELL)
    module = tmp_path / "tiny_rwkv.py"
    shutil.copy(spec.ROOT / c.config["model"], module)
    cfg = dict(c.config, name="tiny_rwkv", model=str(module),
               overrides=dict(SMALL), **SMALL)
    (tmp_path / "tiny_rwkv.json").write_text(json.dumps(cfg))
    s = spec.load_spec()
    s["configs"].append({"name": "tiny_rwkv", "source": "x",
                         "file": str(tmp_path / "tiny_rwkv.json"),
                         "reduced": [], "why": "x"})
    s["workloads"].append(dict(s["workloads"][-1], name="tiny_rwkv.train",
                               config="tiny_rwkv"))
    for m in s["end_to_end"] + s["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"] = m["workloads"] + ["tiny_rwkv.train"]
    assert not [p for p in spec.problems(s) if "tiny_rwkv" in p]
    cell = small("tiny_rwkv.train", s)
    assert train.model_module(cell.config).__file__ == str(module)
    out = C.run(cell, 29, 0.5, False, device="cpu")
    assert out.correct, out.checks


def test_a_configuration_without_its_model_module_is_a_problem(tmp_path):
    s = spec.load_spec()
    c = spec.find_cell(CELL, s)
    cfg = dict(c.config, model=str(tmp_path / "missing.py"))
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    s["configs"] = [dict(e, file=str(tmp_path / "cfg.json"))
                    if e["name"] == "rwkv6_1p6b" else e for e in s["configs"]]
    assert any("model module" in p for p in spec.problems(s))


@pytest.mark.parametrize("phase", [0.0, 0.3, 1.2999])
def test_step_rate_counts_whole_steps(phase):
    """Steps end every 1.3 s: a 10 s window reads 1/1.3 steps a second
    whatever the phase at which it opens, over the whole steps between the
    last end before it and the last end inside it."""
    ends = list(phase + 1.3 * np.arange(-3, 20))
    n, secs = train.step_rate(ends, 2.0, 12.0)
    assert n in (7, 8)
    assert n / secs == pytest.approx(1 / 1.3, rel=1e-9)


def test_step_rate_with_uneven_steps():
    ends = [0.0, 1.0, 3.5, 4.0, 9.0, 13.0]
    assert train.step_rate(ends, 1.5, 11.0) == (3, 8.0)
    assert train.step_rate([], 0.0, 10.0) == (0, 10.0)


def test_gaps_by_the_worst_leaf():
    """A leaf's gap is over the larger of its own norm and the median
    leaf's; a leaf the reference does not move is out of the change."""
    want = train.Readings([2.0, 2.0], np.array([1.0, 2.0, 4.0, 1e-6]),
                          np.array([1.0, 1.0, 1.0, 1e-9]))
    got = train.Readings([2.0, 2.2], np.array([1.1, 2.0, 4.0, 1.0]),
                         np.array([1.0, 1.05, 1.0, 5.0]))
    g = train.gaps(got, want)
    assert g["loss_gap"] == pytest.approx(0.1)
    assert g["grad_norm_gap"] == pytest.approx(1.0 / 1.5)
    assert g["change_norm_gap"] == pytest.approx(0.05)
    nan = train.Readings([math.nan, 2.0], want.grad, want.change)
    assert train.gaps(nan, want)["loss_gap"] == math.inf


def test_card_control_fails(card):
    """On the card, at the cell's own size and one seed: the program reads
    within every limit and the fp8 control outside one."""
    import control_train
    c = spec.find_cell(CELL)
    out = control_train.readings(c, [31], 1, [], card, torch, faults, train)
    lim = c.config["limits"]
    names = ("grad_norm_gap", "change_norm_gap")
    assert all(out["program"][k] <= lim[k] for k in names)
    assert any(out["control_fp8"][k] > lim[k] for k in names)


test_card_control_fails = pytest.mark.cuda(test_card_control_fails)
