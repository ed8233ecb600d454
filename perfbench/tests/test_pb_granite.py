"""The granite cell on the CPU: the harness drives the port's hybrid_moe
training step at a small size, the plain reference agrees with it, and
each planted fault that applies to it, and the control, comes out not
correct."""
import dataclasses

import pytest

from bench import cell as C
from bench import faults, spec, train

CELL = "granite_4p0_h_small.train_4k_ep8"
#: the CPU's cut: the port's SMOKE granite widths, f32
SMALL = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
             d_ff=32, d_ff_shared=48, vocab=256, n_experts=8, top_k=3,
             experts_held=3, expert_first=2, ssm_state=32, ssm_heads=4,
             d_inner=128, attn_period=4, attn_offset=1, dtype="float32")


def small():
    """The cell at a size the CPU holds, two sequences a step so that half
    the batch can be left out."""
    c = spec.find_cell(CELL)
    cfg = dict(c.config, overrides=dict(SMALL), **SMALL)
    return dataclasses.replace(c, config=cfg, traffic=dict(
        c.traffic, sequences=2, tokens=64, pool=8))


def test_train_path_is_correct():
    out = C.run(small(), 2 ** 31 + 11, 1.0, False, device="cpu")
    assert out.correct, out.checks
    assert set(out.metrics) == {"train_tokens_per_s", "setup_s"}
    for k in ("grad_norm_gap", "change_norm_gap"):
        assert out.checks[k]["value"] < 1e-2 * out.checks[k]["limit"]


#: ``grad_scaled`` scales a leaf the rwkv6 configuration has
@pytest.mark.parametrize("fault", [f for f in faults.NAMES
                                   if f != "grad_scaled"])
def test_planted_fault_is_not_correct(fault):
    with faults.planted(fault) as hook:
        out = C.run(small(), 19, 0.5, False, device="cpu", hook=hook)
    assert not out.correct, out.checks


def test_control_is_not_correct():
    c = small()
    mod = train.model_module(c.config)
    K = c.traffic["checked_steps"]
    batches = train.draw_pool(c.config, c.traffic, 23, "cpu")[:K]
    want = train.reference_readings(c.config, c.traffic, mod, 23, "cpu",
                                     batches)
    ctrl = train.reference_readings(c.config, c.traffic, mod, 23, "cpu",
                                    batches, precision="fp8")
    _, ok = train.checks(c.config, train.gaps(ctrl, want), 0, K)
    assert not ok
