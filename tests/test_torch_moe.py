"""The port's MoE family on the CPU against the JAX package's.

dbrx_132b (16 experts top-4 at full size; 4 top-2 at SMOKE) and
llama4_scout_17b (top-1 plus a shared expert) at their SMOKE widths.  The
JAX model draws its parameters; ``to_torch_lm_params`` carries them into
the port, and the same numpy-seeded tokens go through both: the MoE block
alone (at a capacity that drops tokens and one that drops none, 1e-5),
``hidden_states``/``logits``, ``prefill`` and three teacher-forced
``decode_step``s (rtol 1e-4 / atol 1e-5: f32 on both sides, sums in other
orders), the loss and every gradient against ``jax.value_and_grad`` (each
within 1e-4 of its own max |g|), and the serve engine's greedy tokens
against the JAX engine's loop on the same batch composition.  An MoE
block's capacity depends on the tokens of the whole call, so no test here
asserts that a request decodes alike alone and in a batch.  At the 0.02
init the router is nearly uniform and the experts barely shape the
logits, so the checks that must see the experts draw at ``SCALE`` and one
test shows that permuting the experts moves the logits.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose

from repro.configs import get_config as jget_config
from repro.models import blocks as jblocks
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.kernels import gqa_decode as gk
from repro_torch.models import blocks, build_model, lm
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.weights import to_torch_lm_params
from test_torch_serve import _jax_greedy

ARCHS = ["dbrx_132b", "llama4_scout_17b"]
TOL = dict(rtol=1e-4, atol=1e-5)
B, T, MAX_SEQ, N_DECODE = 2, 12, 16, 3
#: x the 0.02 init where a check must see the routing: the router's
#: logits then spread over several units and the experts' outputs are
#: not lost under the residual stream
SCALE = 10.0


def _jax_params(arch, seed, scale=1.0):
    jm = jbuild_model(jget_config(arch, smoke=True))
    params = jax.tree.map(lambda a: np.asarray(a) * np.float32(scale),
                          jm.init(jax.random.PRNGKey(seed)))
    return jm, params


def _port(arch, params):
    cfg = get_config(arch, smoke=True)
    return build_model(cfg, device="cpu").load_params(
        to_torch_lm_params(params, cfg, "cpu"))


# ------------------------------------------------------------ the MoE block
def _drops(cfg, x, p):
    """Token-expert assignments past the capacity, by the port's router."""
    _, _, (_, idx) = blocks.moe_route(cfg, p, x)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    C = blocks.moe_capacity(cfg, x.shape[0] * x.shape[1])
    return int(torch.clamp(counts - C, min=0).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor,drops", [(0.5, True),
                                                   (100.0, False)])
def test_moe_apply_matches_jax(arch, capacity_factor, drops):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               capacity_factor=capacity_factor)
    _, params = _jax_params(arch, 11, SCALE)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["ffn"])
    model = _port(arch, params)
    p = model.layers[0]["ffn"]
    x = np.random.default_rng(12).normal(size=(3, 16, cfg.d_model)
                                         ).astype(np.float32)
    got = blocks.moe_apply(cfg, p, torch.from_numpy(x))
    want = jblocks.moe_apply(jcfg, jp, jnp.asarray(x))
    assert got.shape == x.shape
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (_drops(cfg, torch.from_numpy(x), p) > 0) == drops
    C = blocks.moe_capacity(cfg, 48)
    assert C == (48 if not drops else
                 int(np.ceil(48 * cfg.top_k / cfg.n_experts * 0.5 / 8)) * 8)


def test_moe_capacity_is_repros_rule():
    """``C = min(ceil(N K / E cf / 8) 8, N)`` at the full configs' decode
    and prefill token counts."""
    dbrx = get_config("dbrx_132b")
    scout = get_config("llama4_scout_17b")
    assert blocks.moe_capacity(dbrx, 8) == 8            # decode, batch 8
    assert blocks.moe_capacity(dbrx, 1024) == 320       # prefill, 8 x 128
    assert blocks.moe_capacity(scout, 1024) == 80
    assert blocks.moe_capacity(scout, 3) == 3
    router = blocks.moe_specs(dataclasses.replace(dbrx, dtype="bfloat16"))
    assert router["router"][1] == torch.float32         # f32 in a bf16 model
    assert router["wu"] == ((16, 6144, 10752), torch.bfloat16)
    assert "shared" in blocks.moe_specs(scout)
    assert "shared" not in router


# --------------------------------------------------------- whole models
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """One arch: the JAX model's outputs and the port's model, on the same
    parameters (at ``SCALE``) and tokens."""
    arch = request.param
    jm, params = _jax_params(arch, 3, SCALE)
    model = _port(arch, params)
    toks = np.random.default_rng(4).integers(
        0, jm.cfg.vocab, size=(B, T)).astype(np.int32)
    P = T - N_DECODE
    out = {"arch": arch, "cfg": model.cfg, "model": model, "toks": toks,
           "jm": jm, "params": params}
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
                    np.asarray(jc["length"])))
    out["j_decode"] = dec
    return out


def test_forward_matches_jax(pair):
    m = pair["model"]
    with torch.no_grad():
        hid = m.hidden_states(torch.from_numpy(pair["toks"]))
        logits = m.logits(hid)
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
    before = gk.launch_count()
    for t, (jl, jk, jlen) in zip(range(P, T), pair["j_decode"]):
        cache, logits = m.decode_step(cache, toks[:, t])   # teacher-forced
        assert_allclose(logits.numpy(), jl, **TOL)
        assert_allclose(cache["layers"]["k"].numpy(), jk, **TOL)
        assert np.array_equal(cache["length"].numpy(), jlen)
    assert gk.launch_count() == before        # the CPU runs the plain path


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_loss_and_grads_match_jax(pair, capacity_factor):
    """The loss and every gradient at the config's capacity factor and at
    0.5, where dispatch drops assignments in every layer (asserted): the
    backward through the spill row (a dropped (token, k) reads zeros and
    gets no gradient) against ``jax.value_and_grad`` at the same
    tolerance."""
    arch, jm, params, cfg = pair["arch"], pair["jm"], pair["params"], \
        pair["cfg"]
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
        jm = jbuild_model(dataclasses.replace(jget_config(arch, smoke=True),
                                              capacity_factor=capacity_factor))
    toks = np.random.default_rng(8).integers(
        0, jm.cfg.vocab, size=(2, 33)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        params, {"tokens": jnp.asarray(toks)})
    jgrads = to_torch_lm_params(jax.tree.map(np.asarray, jgrads), cfg, "cpu")
    m = build_model(cfg, device="cpu").load_params(
        to_torch_lm_params(params, cfg, "cpu"))
    m.requires_grad_(True)
    named = m.params()
    drops = []
    real = lm.moe_apply

    def counted(c, p, x):
        with torch.no_grad():
            drops.append(_drops(c, x, p))
        return real(c, p, x)

    lm.moe_apply = counted
    try:
        loss = m.loss({"tokens": torch.from_numpy(toks)})
    finally:
        lm.moe_apply = real
    assert len(drops) == cfg.n_layers
    if capacity_factor is not None:
        assert all(d > 0 for d in drops), drops
    assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = torch.autograd.grad(loss, list(named.values()))
    reached = {"router": 0, "wu": 0}
    for (name, _), g in zip(named.items(), grads):
        want = jgrads[name].numpy()
        assert_allclose(g.numpy(), want, rtol=0,
                        atol=1e-4 * np.abs(want).max(), err_msg=name)
        for leaf in reached:
            if name.endswith(f".ffn.{leaf}"):
                reached[leaf] += int(np.abs(g.numpy()).max() > 0)
    # the experts get gradients in every layer; the router only through
    # the softmax of K > 1 gates (one gate's softmax is 1 whatever it is)
    assert reached == {"wu": cfg.n_layers,
                       "router": cfg.n_layers if cfg.top_k > 1 else 0}


def test_checks_see_the_experts(pair):
    """Swapping two experts' weights (the router left as it is) moves the
    logits by more than 10% of their max: tokens routed to either one now
    meet the other's weights.  At ``SCALE`` the comparisons above are
    therefore not blind to the dispatch."""
    m, toks = pair["model"], torch.from_numpy(pair["toks"])
    with torch.no_grad():
        base = m.logits(m.hidden_states(toks))
        swapped = _port(pair["arch"], pair["params"])
        for layer in swapped.layers:
            for w in ("wu", "wd", "wg"):
                t = layer["ffn"][w]
                t.copy_(t[[1, 0] + list(range(2, t.shape[0]))])
        moved = swapped.logits(swapped.hidden_states(toks))
    assert float((moved - base).abs().max()) > 0.1 * float(base.abs().max())


# ------------------------------------------------------------ the engine
def _assert_tokens(got, want, gaps, gen) -> int:
    """Tokens equal up to the first near tie (JAX's top-1/top-2 gap within
    10x the logit tolerance): past it the two runs may part."""
    checked = 0
    for t in range(gen):
        if gaps[t] <= 10 * TOL["atol"]:
            break
        assert got[t] == want[t], t
        checked += 1
    return checked


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_jax(arch):
    """The port's engine, one request a batch (each padded with zero rows,
    as the JAX engine pads), and its LM backend on one full batch, against
    the JAX engine's loop on the same batch composition."""
    batch, P, gen = 3, 8, 5
    jm, params = _jax_params(arch, 0, SCALE)
    cfg = get_config(arch, smoke=True)
    weights = to_torch_lm_params(params, cfg, "cpu")
    prompts = np.random.default_rng(12).integers(
        0, cfg.vocab, size=(batch, P)).astype(np.int32)
    kw = dict(arch=arch, smoke=True, max_batch=batch, prompt_len=P, gen=gen,
              device="cpu")
    with ServeEngine(ServeConfig(assemble_max=1, **kw),
                     weights=weights) as seq:
        alone = seq.serve(list(prompts))
        full = seq._backend.run(None, list(prompts))
    checked = 0
    for i in range(batch):
        toks, gaps = _jax_greedy(jm, params, prompts[i:i + 1], batch, gen)
        assert alone[i].dtype == np.int32 and alone[i].shape == (gen,)
        checked += _assert_tokens(alone[i], toks[0], gaps[0], gen)
    toks, gaps = _jax_greedy(jm, params, prompts, batch, gen)
    for i in range(batch):
        checked += _assert_tokens(full[i], toks[i], gaps[i], gen)
    assert checked >= 4 * gen          # most steps are decided by a margin
