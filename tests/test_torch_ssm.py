"""The port's rwkv6 on the CPU against the JAX package's.

The JAX SMOKE rwkv6 (2 layers, d_model 64, 2 heads of 32, f32) draws its
parameters; ``to_torch_lm_params`` carries them into the port, and the
same numpy-seeded tokens go through both: ``hidden_states``/``logits``,
``prefill`` (last-position logits, and the zero states and ``length`` the
JAX prefill leaves), ``decode_step`` after a scan-in, and the served greedy
tokens of ``ServeEngine``.  Both compute in f32 on the CPU: rtol 1e-4 /
atol 1e-5, as the dense models' tests.  The port's stepwise decode is held
against its own chunked train path at the JAX test's 2e-4.

Parameters are drawn at 10x the init scale (0.2, not 0.02) where a test
holds the scan: at the 0.02 init the scan's output lies below the ``ln_x``
norm's epsilon and moves the logits by less than the tolerance, so a wrong
scan would pass.  ``test_rwkv6_tests_see_the_scan`` pins that at 0.2 it
moves them by far more than the tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.kernels import linear_scan as lk
from repro_torch.models import build_model, ssm
from repro_torch.models.lm import param_specs
from repro_torch.weights import to_torch_lm_params

ARCH = "rwkv6_1p6b"
TOL = dict(rtol=1e-4, atol=1e-5)
B, T = 2, 24
SCALE = 10.0        # x the 0.02 init: the scan then shapes the logits


@pytest.fixture(scope="module")
def pair():
    """The JAX model's outputs and the port's model, on the same
    parameters and tokens (computed once for the module)."""
    cfg, jcfg = get_config(ARCH, smoke=True), jget_config(ARCH, smoke=True)
    jm = jbuild_model(jcfg)
    params = jax.tree.map(lambda a: np.asarray(a) * np.float32(SCALE),
                          jm.init(jax.random.PRNGKey(3)))
    model = build_model(cfg, device="cpu").load_params(
        to_torch_lm_params(params, cfg, "cpu"))
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab, size=(B, T)).astype(np.int32)
    out = {"cfg": cfg, "model": model, "toks": toks, "params": params,
           "jm": jm}
    hid = jm.hidden_states(params, jnp.asarray(toks), remat=False)
    out["j_hidden"] = np.asarray(hid)
    out["j_logits"] = np.asarray(jm.logits(params, hid))
    jc, jl = jm.prefill(params, jnp.asarray(toks), T)
    out["j_prefill"] = (np.asarray(jl), jax.tree.map(np.asarray, jc))
    # the JAX engine's scan-in: decode_step over every token from zeros
    decode = jax.jit(jm.decode_step)
    jc = jm.init_cache(B, T)
    steps = []
    for t in range(T):
        jc, jl = decode(params, jc, jnp.asarray(toks[:, t]))
        steps.append(np.asarray(jl))
    out["j_scan"] = (steps, jax.tree.map(np.asarray, jc))
    return out


def test_rwkv6_specs_keep_the_jax_leaves():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    mine = ssm.rwkv6_specs(cfg)
    theirs = jssm.rwkv6_specs(jcfg)
    assert set(mine) == set(theirs)
    for name, spec in theirs.items():
        if isinstance(spec, dict):
            spec = spec["w"]
            shape, dt = mine[name]["w"]
        else:
            shape, dt = mine[name]
        assert shape == spec.shape, name
        assert str(dt).replace("torch.", "") == str(spec.dtype), name
    assert mine["w0"][1] == mine["u"][1] == torch.float32
    assert ssm._dims(cfg) == jssm._dims(jcfg) == (2048, 64, 32, 64)


def test_rwkv6_full_width_parameter_count():
    """rwkv6-1.6b by the spec tree: 1.84e9 parameters, as the JAX one."""
    cfg = get_config(ARCH)
    n = sum(int(np.prod(s)) for s, _ in param_specs(cfg).values())
    jn = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jbuild_model(jget_config(ARCH)).param_specs()))
    assert n == jn and 1.8e9 < n < 1.9e9


def test_to_torch_lm_params_carries_the_rwkv6_tree(pair):
    cfg, params = pair["cfg"], pair["params"]
    got = pair["model"].params()
    assert set(got) == set(param_specs(cfg))
    assert got["layers.1.mixer.w0"].dtype == torch.float32
    assert got["layers.0.mixer.mu"].shape == (5, cfg.d_model)
    assert np.array_equal(got["layers.1.mixer.u"].numpy(),
                          params["layers"]["mixer"]["u"][1])
    assert np.array_equal(got["layers.0.ffn.wg"].numpy(),
                          params["layers"]["ffn"]["wg"][0])
    bad = dict(params, layers=dict(params["layers"], mixer=dict(
        params["layers"]["mixer"], w0=params["layers"]["mixer"]["w0"][:, :8])))
    with pytest.raises(ValueError, match="w0: shape"):
        to_torch_lm_params(bad, cfg, "cpu")


def test_rwkv6_forward_matches_jax(pair):
    m = pair["model"]
    with torch.no_grad():
        hid = m.hidden_states(torch.from_numpy(pair["toks"]))
        logits = m.logits(hid)
    assert hid.shape == (B, T, pair["cfg"].d_model)
    assert_allclose(hid.numpy(), pair["j_hidden"], **TOL)
    assert_allclose(logits.numpy(), pair["j_logits"], **TOL)


def test_rwkv6_tests_see_the_scan(pair, monkeypatch):
    """At the tests' parameter scale the scan's output moves the logits by
    over 1000x the logit tolerance: replaced by zeros, they differ by more
    than 10% of their largest value."""
    m, toks = pair["model"], torch.from_numpy(pair["toks"])
    with torch.no_grad():
        full = m.logits(m.hidden_states(toks))
        monkeypatch.setattr(ssm.ops, "linear_scan",
                            lambda q, k, v, w: torch.zeros_like(v))
        no_scan = m.logits(m.hidden_states(toks))
    moved = float((full - no_scan).abs().max())
    assert moved > 0.1 * float(full.abs().max())
    assert moved > 1000 * TOL["atol"]


def test_rwkv6_prefill_matches_jax_and_leaves_zero_states(pair):
    """``repro``'s SSM prefill runs the chunked path for the logits and
    leaves the recurrent states at zero with ``length = T``: a behaviour of
    the reference that the port keeps (its engine scans in instead)."""
    m = pair["model"]
    before = lk.launch_count()
    cache, logits = m.prefill(torch.from_numpy(pair["toks"]), T)
    assert lk.launch_count() == before          # the CPU runs the plain path
    jl, jc = pair["j_prefill"]
    assert_allclose(logits.numpy(), jl, **TOL)
    assert set(cache["layers"]) == set(jc["layers"]) == {"x_prev", "state"}
    for name, arr in jc["layers"].items():
        assert tuple(cache["layers"][name].shape) == arr.shape
        assert not arr.any() and not cache["layers"][name].any()
    assert cache["layers"]["state"].dtype == torch.float32
    assert cache["length"].tolist() == jc["length"].tolist() == [T] * B


def test_rwkv6_scan_in_decode_matches_jax(pair):
    """``decode_step`` over every token from a zero cache (the engine's
    scan-in): logits at each step, and the final states, against JAX."""
    m = pair["model"]
    toks = torch.from_numpy(pair["toks"])
    steps, jc = pair["j_scan"]
    cache = m.init_cache(B, T)
    with torch.no_grad():
        for t in range(T):
            cache, logits = m.decode_step(cache, toks[:, t])
            assert_allclose(logits.numpy(), steps[t], **TOL)
    for name in ("x_prev", "state"):
        assert_allclose(cache["layers"][name].numpy(), jc["layers"][name],
                        **TOL)
    assert np.array_equal(cache["length"].numpy(), jc["length"])


def test_rwkv6_stepwise_decode_matches_train_path():
    """The exact recurrence (decode) against the chunked train path (the
    ``linear_scan`` route) on the port alone: the JAX
    ``test_ssm_stepwise_decode_matches_train_path`` bound, 2e-4."""
    cfg = get_config(ARCH, smoke=True)
    m = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(2),
                                            scale=0.02 * SCALE)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, size=(2, 70)))
    with torch.no_grad():
        full = m.logits(m.hidden_states(toks))
        cache = m.init_cache(2, 70)
        for t in range(70):
            cache, logits = m.decode_step(cache, toks[:, t])
            torch.testing.assert_close(logits, full[:, t], rtol=2e-4,
                                       atol=2e-4)


def test_rwkv6_serve_matches_jax_engine():
    """``ServeEngine(arch="rwkv6_1p6b", smoke=True, device="cpu")`` against
    the JAX engine on the same parameters and prompts: identical greedy
    tokens wherever JAX's top-1/top-2 logit gap is clear (10x the logit
    tolerance) — checked on JAX's own scan-in logits — and batched ==
    sequential on the port."""
    Bm, P, gen = 4, 6, 5
    jcfg = jget_config(ARCH, smoke=True)
    jm = jbuild_model(jcfg)
    # the JAX engine's own parameters (its ``seed=0`` key, split once)
    init_key, _ = jax.random.split(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jm.init(init_key))
    weights = api.to_torch_lm_params(params, api.get_config(ARCH, smoke=True),
                                     device="cpu")
    prompts = list(np.random.default_rng(12).integers(
        0, jcfg.vocab, size=(5, P)).astype(np.int32))
    kw = dict(arch=ARCH, smoke=True, max_batch=Bm, prompt_len=P, gen=gen)
    with api.ServeEngine(api.ServeConfig(workers=2, device="cpu", **kw),
                         weights=weights) as eng, \
            api.ServeEngine(api.ServeConfig(assemble_max=1, device="cpu",
                                            **kw), weights=weights) as seq:
        got = eng.serve(prompts)
        want = seq.serve(prompts)
    for a, b in zip(got, want):
        assert a.dtype == np.int32 and a.shape == (gen,)
        assert np.array_equal(a, b)
    with JServeEngine(JServeConfig(use_pallas=False, **kw)) as jeng:
        theirs = jeng.serve(prompts)
    # where the JAX loop had a clear margin, the tokens agree: replay the
    # JAX engine's scan-in + greedy loop for one request to get its gaps
    decode = jax.jit(jm.decode_step)
    cache = jm.init_cache(Bm, P + gen)
    pad = np.zeros((Bm, P), np.int32)
    pad[0] = prompts[0]
    for t in range(P):
        cache, logits = decode(params, cache, jnp.asarray(pad[:, t]))
    checked = 0
    for t in range(gen):
        if t:
            cache, logits = decode(params, cache, jnp.argmax(logits, -1))
        top2 = np.sort(np.asarray(logits)[0])[-2:]
        if top2[1] - top2[0] <= 10 * TOL["atol"]:
            break
        assert got[0][t] == np.asarray(theirs[0])[t] == \
            int(np.argmax(np.asarray(logits)[0])), t
        checked += 1
    assert checked >= 2


def test_rwkv6_serve_config_runs_on_the_card_by_default(monkeypatch):
    cfg = api.ServeConfig(arch=ARCH)
    assert cfg.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.ServeEngine(cfg)
