"""The port's dense LMs on the CPU against the JAX package's.

The JAX model draws its parameters; ``to_torch_lm_params`` carries them
into the port, and the same numpy-seeded tokens go through both:
``hidden_states``/``logits``, ``prefill`` (last-position logits and the KV
caches) and three teacher-forced ``decode_step``s, on the SMOKE configs of
llama3p2_3b (GQA, tied head), phi3_mini_3p8b (MHA, untied), nemotron_4_15b
(layernorm, relu2) and minicpm_2b.  Both sides compute in f32 on the CPU,
so the tolerance is rtol 1e-4 / atol 1e-5 (sums in other orders; the
logits themselves are ~1e-2 at the 0.02 init).  The common pieces are held
to the JAX ones at 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import gqa_decode as gk
from repro_torch.models import build_model, common
from repro_torch.models.lm import param_specs
from repro_torch.weights import to_torch_lm_params

ARCHS = ["llama3p2_3b", "phi3_mini_3p8b", "nemotron_4_15b", "minicpm_2b",
         "chameleon_34b"]
TOL = dict(rtol=1e-4, atol=1e-5)
B, T, MAX_SEQ, N_DECODE = 2, 12, 16, 3


def _np(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ common pieces
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(0)
    x, w, b = _np(rng, (3, 5, 48)) * 3 + 1, _np(rng, (48,)), _np(rng, (48,))
    p_t = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    p_j = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    got = common.apply_norm(kind, torch.from_numpy(x), p_t)
    want = jcommon.apply_norm(kind, jnp.asarray(x), p_j)
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_activations_match_jax(kind):
    rng = np.random.default_rng(1)
    x, g = _np(rng, (4, 64)) * 3, _np(rng, (4, 64)) * 3
    got = common.activation(kind, torch.from_numpy(x), torch.from_numpy(g))
    want = jcommon.activation(kind, jnp.asarray(x), jnp.asarray(g))
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_rope_matches_jax():
    rng = np.random.default_rng(2)
    x = _np(rng, (2, 7, 3, 32))
    pos = np.stack([np.arange(7), np.arange(7) + 100]).astype(np.int32)
    for theta in (1e4, 5e5):
        got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta)
        want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tq,tk,chunk,causal", [
    (5, 20, 8, True),      # Tq < Tk (suffix queries), chunk shrinks to 5
    (12, 12, 4, True),
    (3, 14, 1024, False),
])
def test_chunked_attention_matches_jax(tq, tk, chunk, causal):
    rng = np.random.default_rng(tq + tk)
    q = _np(rng, (2, tq, 6, 16))
    k, v = _np(rng, (2, tk, 2, 16)), _np(rng, (2, tk, 2, 16))
    got = common.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), chunk=chunk,
                                   causal=causal)
    want = jcommon.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), chunk=chunk,
                                     causal=causal)
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------- whole models
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """One arch: the JAX model's outputs and the port's, on the same
    parameters and tokens (computed once for the module)."""
    arch = request.param
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    jm = jbuild_model(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    model = build_model(cfg, device="cpu").load_params(
        to_torch_lm_params(params, cfg, "cpu"))
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab, size=(B, T)).astype(np.int32)
    P = T - N_DECODE
    out = {"arch": arch, "cfg": cfg, "model": model, "toks": toks}
    hid = jm.hidden_states(params, jnp.asarray(toks), remat=False)
    out["j_hidden"] = np.asarray(hid)
    out["j_logits"] = np.asarray(jm.logits(params, hid))
    jc, jl = jm.prefill(params, jnp.asarray(toks[:, :P]), MAX_SEQ)
    out["j_prefill"] = (np.asarray(jl), np.asarray(jc["layers"]["k"]),
                        np.asarray(jc["layers"]["v"]))
    dec = []
    for t in range(P, T):
        jc, jl = jm.decode_step(params, jc, jnp.asarray(toks[:, t]))
        dec.append((np.asarray(jl), np.asarray(jc["layers"]["k"]),
                    np.asarray(jc["layers"]["v"]),
                    np.asarray(jc["length"])))
    out["j_decode"] = dec
    return out


def test_forward_matches_jax(pair):
    m = pair["model"]
    with torch.no_grad():
        hid = m.hidden_states(torch.from_numpy(pair["toks"]))
        logits = m.logits(hid)
    assert hid.shape == (B, T, pair["cfg"].d_model)
    assert_allclose(hid.numpy(), pair["j_hidden"], **TOL)
    assert_allclose(logits.numpy(), pair["j_logits"], **TOL)


def test_prefill_and_decode_match_jax(pair):
    m, toks = pair["model"], torch.from_numpy(pair["toks"])
    P = T - N_DECODE
    cache, logits = m.prefill(toks[:, :P], MAX_SEQ)
    jl, jk, jv = pair["j_prefill"]
    assert_allclose(logits.numpy(), jl, **TOL)
    assert_allclose(cache["layers"]["k"].numpy(), jk, **TOL)
    assert_allclose(cache["layers"]["v"].numpy(), jv, **TOL)
    assert cache["length"].tolist() == [P] * B
    before = gk.launch_count()
    for t, (jl, jk, jv, jlen) in zip(range(P, T), pair["j_decode"]):
        cache, logits = m.decode_step(cache, toks[:, t])   # teacher-forced
        assert_allclose(logits.numpy(), jl, **TOL)
        assert_allclose(cache["layers"]["k"].numpy(), jk, **TOL)
        assert_allclose(cache["layers"]["v"].numpy(), jv, **TOL)
        assert np.array_equal(cache["length"].numpy(), jlen)
    assert gk.launch_count() == before        # the CPU runs the plain path


def test_prefill_plus_decode_equals_full_forward():
    """logits(prefill(T-1) + decode(1)) == logits(full forward), the JAX
    ``test_prefill_decode_matches_train_path`` bound (2e-4)."""
    cfg = get_config("llama3p2_3b", smoke=True)
    m = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2, 16)))
    full = m.logits(m.hidden_states(toks)[:, -1])
    cache, _ = m.prefill(toks[:, :-1], 32)
    _, dec = m.decode_step(cache, toks[:, -1])
    torch.testing.assert_close(dec, full, rtol=2e-4, atol=2e-4)


def test_init_draws_every_leaf_from_the_generator():
    cfg = get_config("nemotron_4_15b", smoke=True)
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    c = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(6))
    pa, pb, pc = a.params(), b.params(), c.params()
    assert set(pa) == set(param_specs(cfg)) and "layers.1.mixer.norm.b" in pa
    for name, p in pa.items():
        assert torch.equal(p, pb[name]) and not torch.equal(p, pc[name])
        assert 0.01 < float(p.std()) < 0.03, name    # norm weights too


def test_to_torch_lm_params_refuses_bad_trees():
    cfg = get_config("phi3_mini_3p8b", smoke=True)
    params = jax.tree.map(np.asarray, jbuild_model(
        jget_config("phi3_mini_3p8b", smoke=True)).init(
        jax.random.PRNGKey(0)))
    good = to_torch_lm_params(params, cfg, "cpu")
    assert good["lm_head"].shape == (cfg.d_model, cfg.vocab)
    assert good["layers.1.mixer.wq"].shape == (64, 64)
    bad = dict(params, lm_head=params["lm_head"][:, :-1])
    with pytest.raises(ValueError, match="lm_head: shape"):
        to_torch_lm_params(bad, cfg, "cpu")
    bad = dict(params, layers=dict(params["layers"], mixer=dict(
        params["layers"]["mixer"], wq=params["layers"]["mixer"]["wq"][0])))
    with pytest.raises(ValueError, match="layer axis"):
        to_torch_lm_params(bad, cfg, "cpu")
    no_head = {k: v for k, v in params.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="missing"):
        to_torch_lm_params(no_head, cfg, "cpu")
    tied = get_config("llama3p2_3b", smoke=True)
    with pytest.raises(ValueError):
        to_torch_lm_params(params, tied, "cpu")


def _repro_named_specs(arch: str, smoke: bool) -> dict:
    """``repro``'s ``param_specs()`` of ``arch`` flattened to the port's
    names: dotted paths, a stacked subtree (``layers``, ``enc_layers``,
    ``dec_layers``) unstacked one name a layer; ``(shape, dtype name)``."""
    jm = jbuild_model(jget_config(arch, smoke=smoke))
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(jm.param_specs())[0]:
        name = ".".join(k.key for k in path)
        stack = name.split(".", 1)[0]
        if stack in ("layers", "enc_layers", "dec_layers"):
            rest = name[len(stack) + 1:]
            for i in range(s.shape[0]):
                out[f"{stack}.{i}.{rest}"] = (s.shape[1:], s.dtype.name)
        else:
            out[name] = (s.shape, s.dtype.name)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_has_repros_parameter_tree(arch):
    """Every config of the zoo builds (its SMOKE model on the CPU), and the
    port's ``param_specs`` names every leaf of ``repro``'s tree with its
    shape and dtype, at SMOKE and at full size (the MoE router f32 in a
    bf16 model)."""
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        want = _repro_named_specs(arch, smoke)
        got = {n: (tuple(shape), str(dt).split(".")[-1])
               for n, (shape, dt) in param_specs(cfg).items()}
        assert got == want, (arch, smoke)
    model = build_model(cfg, device="cpu")              # the SMOKE config
    assert {n: (tuple(p.shape), str(p.dtype).split(".")[-1])
            for n, p in model.params().items()} == want


def test_ssm_runs_rwkv6_only_so_far():
    """The ssm family runs the rwkv6 mixer for a config named ``rwkv*`` and
    the mamba2 mixer for any other (as ``repro``'s ``LMModel`` does); the
    hybrid family builds the zamba2 ``HybridModel``.  (The name is kept
    from before the mamba2 mixer was ported.)"""
    import dataclasses
    from repro_torch.models import HybridModel
    rwkv = get_config("rwkv6_1p6b", smoke=True)
    m = build_model(rwkv, device="cpu")
    assert m.cfg.family == "ssm" and hasattr(m.layers[0].mixer, "w0")
    mamba = build_model(dataclasses.replace(rwkv, name="mamba2-test"),
                        device="cpu")
    assert hasattr(mamba.layers[0].mixer, "A_log")
    assert not hasattr(mamba.layers[0].mixer, "w0")
    zamba = build_model(get_config("zamba2_2p7b", smoke=True), device="cpu")
    assert isinstance(zamba, HybridModel)


def test_build_model_runs_on_the_card_by_default(monkeypatch):
    """``build_model``/``LMModel`` (and ``api.build_model``) default to
    ``device="cuda"`` and raise where there is no CUDA, before allocating."""
    from repro_torch import api
    from repro_torch.models import LMModel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3p2_3b", smoke=True)
    for build in (api.build_model, build_model, LMModel):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"
