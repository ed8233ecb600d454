"""The correctness check on the CPU: the plain reference computes what the
port computes, the control (TF32) fails it, and a run whose timed path is
broken underneath comes out not correct."""
import dataclasses

import numpy as np
import pytest
import torch

from bench import cell as C
from bench import reference, spec

CELLS = ("bert_large.offline",)
#: the CPU's cut: the first two encoder layers (both kinds of residual edge)
#: over 32 tokens
LAYERS, TOKENS = 8, 32


def small(name):
    """The cell at a size the CPU holds (with ``overrides``): its first
    layers over fewer tokens, the engine at batch 2, a 4-input pool, 8
    requests outstanding."""
    c = spec.find_cell(name)
    cfg = c.config
    cut = dict(cfg, layers=[dict(L, P=TOKENS) for L in cfg["layers"][:LAYERS]],
               skip_edges=[e for e in cfg["skip_edges"] if e[1] < LAYERS],
               input=[TOKENS] + cfg["input"][1:])
    return dataclasses.replace(c, config=cut)


def server(name):
    """The cell's configuration under a slow open loop of Poisson arrivals,
    reporting the tail of its latency."""
    c = small(name)
    return dataclasses.replace(
        c, traffic={"kind": "poisson", "rate_per_s": 6.0, "burst": None,
                    "pool": 4, "queue_capacity": 16},
        end_to_end=[{"name": "e2e_p95_ms", "unit": "ms"},
                    {"name": "setup_s", "unit": "s"}])


def overrides(plan_cache):
    return C.Overrides(max_batch=2, pool=4, outstanding=8, queue_capacity=16,
                       cache_dir=plan_cache)


@pytest.mark.parametrize("name", CELLS)
def test_engine_against_reference(name, plan_cache):
    """A few requests served through ServeEngine(device="cpu") at batch 2,
    each held to the reference."""
    c = small(name)
    weights, pool = C.make_inputs(c.config, 3, 7, "cpu")
    eng = C.build_engine(c.config, c.traffic, weights, "cpu",
                         overrides(plan_cache))
    with eng:
        outs = eng.serve([pool[i] for i in range(3)])
    want = reference.forward(c.config, weights, pool)
    for got, w in zip(outs, want):
        assert got.shape == tuple(w.shape)
        err = float((torch.from_numpy(got) - w).abs().max())
        assert err <= c.config["limits"]["rel_err"] * float(w.abs().max())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, plan_cache):
    """The program's run reads under the limit; the reference computed in
    TF32 (its operands rounded to 10 mantissa bits) in its place reads over
    it, by the same comparison."""
    c = small(name)
    out = C.run(c, 11, 1.5, False, device="cpu", ov=overrides(plan_cache))
    assert out.correct, out.checks
    limit = c.config["limits"]["rel_err"]
    assert out.checks["rel_err"]["value"] < limit
    weights, pool = C.make_inputs(c.config, 4, 11, "cpu")
    ans = C.Answers(11)
    for i, y in enumerate(reference.forward(c.config, weights, pool,
                                            tf32=True).numpy()):
        ans.keep(i, y)
    assert C.reference_check(c.config, weights, pool, ans, "cpu") > limit


class Broken:
    """The engine's prepared network with a fault planted underneath."""

    def __init__(self, prepared, fault):
        self.p, self.fault, self.last = prepared, fault, None

    def assemble_batch(self, samples):
        x = self.p.assemble_batch(samples)
        if self.fault == "half_batch":
            # the batch's second half (a lone request is half of itself)
            # never reaches the device
            x[len(samples) // 2:len(samples)] = 0
        return x

    def __call__(self, x):
        y = self.p(x)
        if self.fault == "answer_altered":
            y = y.clone()
            y[0, 0, 0, 0] += 0.01 * y.abs().max()
        elif self.fault == "state_unchanged":
            # the step hands back what it held: the previous batch's output
            y, self.last = (self.last if self.last is not None else y), y
        return y


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch",
                                   "state_unchanged"])
@pytest.mark.parametrize("cell", [small(n) for n in CELLS]
                         + [server(CELLS[0])],
                         ids=list(CELLS) + ["poisson"])
def test_broken_timed_path_is_not_correct(cell, fault, plan_cache):
    def plant(eng):
        eng._prepared = Broken(eng._prepared, fault)
    out = C.run(cell, 12, 1.5, False, device="cpu",
                ov=overrides(plan_cache), hook=plant)
    assert not out.correct, out.checks


def test_open_loop_reports_its_tail(plan_cache):
    out = C.run(server(CELLS[0]), 14, 2.0, False, device="cpu",
                ov=overrides(plan_cache))
    assert out.correct, out.checks
    assert out.attempted == 12 and out.failed == 0
    assert set(out.metrics) == {"e2e_p95_ms", "setup_s"}
    assert 0 < out.metrics["e2e_p95_ms"]["value"] < 2000


def test_card_control_fails(card):
    """On the card: the reference in TF32 against itself in fp32."""
    c = spec.find_cell(CELLS[0])
    weights, pool = C.make_inputs(c.config, 8, 13, card)
    ans = C.Answers(13)
    for i, y in enumerate(reference.forward(c.config, weights,
                                            pool.to(card), tf32=True)
                          .cpu().numpy()):
        ans.keep(i, y)
    assert C.reference_check(c.config, weights, pool, ans, card) > \
        c.config["limits"]["rel_err"]
    assert np.isfinite(C.reference_check(c.config, weights, pool,
                                         ans, card))


test_card_control_fails = pytest.mark.cuda(test_card_control_fails)
