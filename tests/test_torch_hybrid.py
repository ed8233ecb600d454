"""The port's zamba2 hybrid (and the mamba2 mixer) on the CPU against the
JAX package's.

The JAX SMOKE zamba2 (4 Mamba2 layers, d_model 64, 2 SSM heads of 64,
state 16, the shared attention block after every 2nd layer, f32) draws its
parameters; ``to_torch_lm_params`` carries them into the port, and the
same numpy-seeded tokens go through both: ``hidden_states``/``logits``,
``prefill`` (last-position logits, and the zero states and ``length`` the
JAX prefill leaves), ``decode_step`` over every token from a zero cache
(the engines' scan-in) with its final states and shared-block K/V caches,
the served greedy tokens of ``ServeEngine``, and the loss with every
gradient.  Both compute in f32 on the CPU: rtol 1e-4 / atol 1e-5 (the
dense models' tolerance); the loss at rtol 1e-5 and each gradient within
1e-4 of its max |g| (the training tests' bounds).

Parameters are drawn at 10x the init scale (0.2, not 0.02): at the 0.02
init ``y * silu(z)`` lies far below the output norm's epsilon, the scan's
output moves the logits by ~1e-6 of their max, and a wrong scan would
pass.  ``test_hybrid_tests_see_the_scan`` pins that at 0.2 it moves them
by far more than the tolerance.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro.models.lm import LMModel as JLMModel
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.kernels import linear_scan as lk
from repro_torch.models import HybridModel, build_model, ssm
from repro_torch.models.lm import param_specs
from repro_torch.weights import to_torch_lm_params

ARCH = "zamba2_2p7b"
TOL = dict(rtol=1e-4, atol=1e-5)
B, T = 2, 24
SCALE = 10.0        # x the 0.02 init: the scan then shapes the logits


def _scaled(params):
    return jax.tree.map(lambda a: np.asarray(a) * np.float32(SCALE), params)


@pytest.fixture(scope="module")
def pair():
    """The JAX model's outputs and the port's model, on the same
    parameters and tokens (computed once for the module)."""
    cfg, jcfg = get_config(ARCH, smoke=True), jget_config(ARCH, smoke=True)
    jm = jbuild_model(jcfg)
    params = _scaled(jm.init(jax.random.PRNGKey(3)))
    model = build_model(cfg, device="cpu").load_params(
        to_torch_lm_params(params, cfg, "cpu"))
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab, size=(B, T)).astype(np.int32)
    out = {"cfg": cfg, "model": model, "toks": toks, "params": params}
    hid = jm.hidden_states(params, jnp.asarray(toks), remat=False)
    out["j_hidden"] = np.asarray(hid)
    out["j_logits"] = np.asarray(jm.logits(params, hid))
    jc, jl = jm.prefill(params, jnp.asarray(toks), T)
    out["j_prefill"] = (np.asarray(jl), jax.tree.map(np.asarray, jc))
    decode = jax.jit(jm.decode_step)
    jc = jm.init_cache(B, T)
    steps = []
    for t in range(T):
        jc, jl = decode(params, jc, jnp.asarray(toks[:, t]))
        steps.append(np.asarray(jl))
    out["j_scan"] = (steps, jax.tree.map(np.asarray, jc))
    return out


def test_mamba2_specs_keep_the_jax_leaves():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    mine, theirs = ssm.mamba2_specs(cfg), jssm.mamba2_specs(jcfg)
    assert set(mine) == set(theirs)
    for name, spec in theirs.items():
        if isinstance(spec, dict):
            spec = spec["w"]
            shape, dt = mine[name]["w"]
        else:
            shape, dt = mine[name]
        assert shape == spec.shape, name
        assert str(dt).replace("torch.", "") == str(spec.dtype), name
    assert ssm._dims(cfg) == jssm._dims(jcfg) == (5120, 64, 80, 64)
    assert ssm.mamba2_cache_specs(cfg, 8)["ssm"] == ((8, 80, 64, 64),
                                                     torch.float32)


def test_zamba2_full_width_parameter_count():
    """zamba2-2.7b by the spec tree: 54 layers, one shared block, 2.44e9
    parameters, as the JAX one; 9 shared-block invocations."""
    cfg = get_config(ARCH)
    specs = param_specs(cfg)
    n = sum(int(np.prod(s)) for s, _ in specs.values())
    jm = jbuild_model(jget_config(ARCH))
    jn = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jm.param_specs()))
    assert n == jn and 2.4e9 < n < 2.5e9
    assert "shared.attn.wq" in specs and "layers.53.mixer.A_log" in specs
    assert "layers.0.ffn.wu" not in specs
    assert jm.n_invocations == 9


def test_to_torch_lm_params_carries_the_shared_block(pair):
    cfg, params = pair["cfg"], pair["params"]
    m = pair["model"]
    assert isinstance(m, HybridModel) and m.n_invocations == 2
    got = m.params()
    assert set(got) == set(param_specs(cfg))
    assert np.array_equal(got["shared.concat_proj"].numpy(),
                          params["shared"]["concat_proj"])
    assert np.array_equal(got["shared.ffn.wd"].numpy(),
                          params["shared"]["ffn"]["wd"])
    assert np.array_equal(got["layers.3.mixer.A_log"].numpy(),
                          params["layers"]["mixer"]["A_log"][3])
    assert got["layers.0.mixer.dt_bias"].dtype == torch.float32
    bad = dict(params, shared=dict(params["shared"],
                                   concat_proj=params["shared"]
                                   ["concat_proj"][:8]))
    with pytest.raises(ValueError, match="concat_proj: shape"):
        to_torch_lm_params(bad, cfg, "cpu")


def test_hybrid_forward_matches_jax(pair):
    m = pair["model"]
    with torch.no_grad():
        hid = m.hidden_states(torch.from_numpy(pair["toks"]))
        logits = m.logits(hid)
    assert hid.shape == (B, T, pair["cfg"].d_model)
    assert_allclose(hid.numpy(), pair["j_hidden"], **TOL)
    assert_allclose(logits.numpy(), pair["j_logits"], **TOL)


def test_hybrid_tests_see_the_scan(pair, monkeypatch):
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


def test_hybrid_prefill_matches_jax_and_leaves_zero_states(pair):
    """``repro``'s hybrid prefill runs the chunked path for the logits and
    leaves every state and shared-block K/V cache at zero with
    ``length = T``: a behaviour of the reference that the port keeps (both
    engines scan in instead)."""
    m = pair["model"]
    before = lk.launch_count()
    cache, logits = m.prefill(torch.from_numpy(pair["toks"]), T)
    assert lk.launch_count() == before          # the CPU runs the plain path
    jl, jc = pair["j_prefill"]
    assert_allclose(logits.numpy(), jl, **TOL)
    assert set(cache) == set(jc) == {"layers", "attn_k", "attn_v", "length"}
    assert set(cache["layers"]) == set(jc["layers"]) == {"conv", "ssm"}
    for got, want in ((cache["layers"]["conv"], jc["layers"]["conv"]),
                      (cache["layers"]["ssm"], jc["layers"]["ssm"]),
                      (cache["attn_k"], jc["attn_k"]),
                      (cache["attn_v"], jc["attn_v"])):
        assert tuple(got.shape) == want.shape
        assert not want.any() and not got.any()
    assert cache["layers"]["ssm"].dtype == torch.float32
    assert cache["length"].tolist() == jc["length"].tolist() == [T] * B


def test_hybrid_scan_in_decode_matches_jax(pair):
    """``decode_step`` over every token from a zero cache (the engine's
    scan-in): logits at each step, and the final Mamba2 states and the
    shared block's per-invocation K/V caches, against JAX."""
    m = pair["model"]
    toks = torch.from_numpy(pair["toks"])
    steps, jc = pair["j_scan"]
    cache = m.init_cache(B, T)
    with torch.no_grad():
        for t in range(T):
            cache, logits = m.decode_step(cache, toks[:, t])
            assert_allclose(logits.numpy(), steps[t], **TOL)
    for name in ("conv", "ssm"):
        assert_allclose(cache["layers"][name].numpy(), jc["layers"][name],
                        **TOL)
    for name in ("attn_k", "attn_v"):
        assert cache[name].shape == (2, B, T, 4, 16)
        assert_allclose(cache[name].numpy(), jc[name], **TOL)
    assert np.array_equal(cache["length"].numpy(), jc["length"])


def test_hybrid_stepwise_decode_matches_train_path():
    """The exact recurrence (decode) against the chunked train path (the
    ``linear_scan`` route, a ragged last chunk at T = 70) on the port
    alone: the JAX ``test_ssm_stepwise_decode_matches_train_path`` bound,
    2e-4."""
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


def test_mamba2_ssm_config_matches_jax():
    """An ssm config not named ``rwkv*`` takes the mamba2 mixer (with its
    MLP, as ``repro``'s ``LMModel`` builds it): forward and scan-in decode
    against the JAX ``LMModel``."""
    base = get_config(ARCH, smoke=True)
    cfg = dataclasses.replace(base, name="mamba2-test", family="ssm")
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True),
                               name="mamba2-test", family="ssm")
    jm = JLMModel(jcfg)
    params = _scaled(jm.init(jax.random.PRNGKey(6)))
    m = build_model(cfg, device="cpu").load_params(
        to_torch_lm_params(params, cfg, "cpu"))
    assert type(m).__name__ == "LMModel" and hasattr(m.layers[0], "ffn")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, size=(B, 12))
    with torch.no_grad():
        logits = m.logits(m.hidden_states(torch.from_numpy(toks)))
    want = jm.logits(params, jm.hidden_states(params, jnp.asarray(toks),
                                              remat=False))
    assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    cache, jc = m.init_cache(B, 12), jm.init_cache(B, 12)
    with torch.no_grad():
        for t in range(12):
            cache, lt = m.decode_step(cache, torch.from_numpy(toks[:, t]))
            jc, jl = jm.decode_step(params, jc, jnp.asarray(toks[:, t]))
            assert_allclose(lt.numpy(), np.asarray(jl), **TOL)


def test_hybrid_loss_and_grads_match_jax():
    """``make_train_step`` turns the gradients on; the loss it takes and
    every gradient (the shared block's summed over its invocations)
    against ``jax.value_and_grad(model.loss)``."""
    jm = jbuild_model(jget_config(ARCH, smoke=True))
    params = _scaled(jm.init(jax.random.PRNGKey(7)))
    toks = np.random.default_rng(8).integers(
        0, jm.cfg.vocab, size=(2, 129)).astype(np.int32)
    loss, grads = jax.value_and_grad(jm.loss)(params,
                                              {"tokens": jnp.asarray(toks)})
    cfg = get_config(ARCH, smoke=True)
    m = api.build_model(cfg, device="cpu").load_params(
        to_torch_lm_params(params, cfg, "cpu"))
    j_grads = to_torch_lm_params(jax.tree.map(np.asarray, grads), cfg, "cpu")
    api.make_train_step(m)
    assert all(p.requires_grad for p in m.params().values())
    own = m.params()
    got_loss = m.loss({"tokens": torch.from_numpy(toks)})
    assert got_loss.dtype == torch.float32 and got_loss.shape == ()
    assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-5)
    got = torch.autograd.grad(got_loss, list(own.values()))
    assert len(got) == len(j_grads)
    for (name, _), g in zip(own.items(), got):
        want = j_grads[name].numpy()
        assert_allclose(g.numpy(), want, rtol=0,
                        atol=1e-4 * np.abs(want).max(), err_msg=name)


def test_hybrid_serve_matches_jax_engine():
    """``ServeEngine(arch="zamba2_2p7b", smoke=True, device="cpu")`` against
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


def test_hybrid_serve_config_runs_on_the_card_by_default(monkeypatch):
    cfg = api.ServeConfig(arch=ARCH)
    assert cfg.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        HybridModel(get_config(ARCH, smoke=True))
