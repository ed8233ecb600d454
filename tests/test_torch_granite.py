"""granite-4.0-h-small (the ``hybrid_moe`` family) against a plain reference.

The reference (``tests/reference/granite_hybrid_ref.py``) is granite's
forward in plain ``torch``, one step of the Mamba2 recurrence at a time,
attention as one softmax, every token through every held expert; it
imports neither the port nor JAX.  On the CPU, in f32, on seeded weights
drawn at the benchmark's scales (so that the scan, the experts and
attention each move the loss): the port's loss and every gradient, and the
benchmark's model module (chunked), agree with it; the expert shares add
up to the uncut layer; a skewed router is dropless; each multiplier, NoPE
and the attention position moves the result.  The configuration is held
against the published config.json's numbers, and the other archs' specs
against their values before the new fields existed.  The tests marked
``cuda`` run ``linear_scan`` at d_state 128 and the held-expert block on
the card.

Tolerances: the port's chunked f32 sums against the reference's stepwise
ones agree to ~5e-6 of the largest gradient at these sizes; 1e-5 holds
that with room, and a wrong multiplier moves the loss by 1e-3 or more.
"""
import dataclasses
import hashlib
import importlib.util
import json
import pathlib

import pytest
import torch

from repro_torch import api, obs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops, ref
from repro_torch.models.blocks import moe_apply_held
from repro_torch.models.lm import param_specs

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_CONFIG = ROOT / "perfbench" / "configs" / "granite_4p0_h_small.json"
BENCH_MODEL = ROOT / "perfbench" / "models" / "granite_4p0_h_small.py"
#: gradients and losses within this share of the reference's largest
TOL = 1e-5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = _load("granite_hybrid_ref", ROOT / "tests" / "reference"
          / "granite_hybrid_ref.py")
BENCH = _load("granite_bench_model", BENCH_MODEL)


def smoke(**changes):
    return dataclasses.replace(get_config("granite-4.0-h-small", smoke=True),
                               **changes)


def sizes(cfg) -> dict:
    """The reference's view of a port config: its fields, by name."""
    return dataclasses.asdict(cfg)


def weights(cfg, seed: int) -> dict:
    """f32 weights under the port's names, drawn at the benchmark's scales
    (its model module's ``init``)."""
    init = json.loads(BENCH_CONFIG.read_text())["init"]
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, (shape, _) in param_specs(cfg).items():
        mean, std = BENCH.init({"init": init}, name, shape)
        out[name] = torch.randn(shape, generator=g) * std + mean
    return out


def tokens(cfg, seed: int, batch: int = 2, T: int = 48) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, T + 1), generator=g)


def port_loss_and_grads(cfg, w, tok):
    model = api.build_model(cfg, device="cpu")
    model.load_params(w)
    model.requires_grad_(True)
    params = model.params()
    loss = model.loss({"tokens": tok})
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def ref_loss_and_grads(cfg_dict, w, tok):
    leaves = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    loss = R.loss(cfg_dict, leaves, tok)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def assert_grads_close(got, want):
    assert set(got) == set(want)
    for n, g in want.items():
        scale = float(g.abs().max())
        assert scale > 0, f"{n}: the reference's gradient is zero"
        assert float((got[n] - g).abs().max()) <= TOL * scale, n


# ------------------------------------------------------------- the model
def test_port_loss_and_every_gradient_match_the_reference():
    cfg = smoke()
    w, tok = weights(cfg, 0), tokens(cfg, 1)
    loss, grads = port_loss_and_grads(cfg, w, tok)
    want_loss, want = ref_loss_and_grads(sizes(cfg), w, tok)
    assert loss == pytest.approx(want_loss, rel=TOL)
    assert_grads_close(grads, want)


def test_benchmark_module_matches_the_reference():
    """The benchmark's chunked copy (its SSD scan, its experts on their
    routed rows) against the stepwise reference, at a T that the chunk
    does not divide."""
    cfg = smoke()
    w, tok = weights(cfg, 2), tokens(cfg, 3, T=80)
    c = dict(sizes(cfg), norm_eps=1e-5, reference_rows=1)
    loss, grads = BENCH.loss_and_grads(c, w, tok)
    want_loss, want = ref_loss_and_grads(sizes(cfg), w, tok)
    assert loss == pytest.approx(want_loss, rel=TOL)
    assert_grads_close(grads, want)


def test_a_train_step_runs_on_the_normal_path():
    cfg = smoke()
    model = api.build_model(cfg, device="cpu")
    model.load_params(weights(cfg, 4))
    opt = api.adamw_init(model.params())
    step = api.make_train_step(model, lr=2e-3)
    batch = {"tokens": tokens(cfg, 5)}
    losses = []
    for _ in range(3):
        opt, m = step(opt, batch)
        losses.append(float(m["loss"]))
    assert losses[2] < losses[0]


# ------------------------------------------------------ the expert share
def _layer_weights(cfg, seed):
    w = weights(cfg, seed)
    return {n[len("layers.0.ffn."):]: t for n, t in w.items()
            if n.startswith("layers.0.ffn.")}


class _P(dict):
    """A flat weight dict read as ``p["shared"]["wu"]``, as blocks read a
    ``ParamModule``."""

    def __getitem__(self, name):
        if name in self.keys():
            return dict.__getitem__(self, name)
        return _P({k[len(name) + 1:]: v for k, v in self.items()
                   if k.startswith(name + ".")})


def test_the_shares_add_up_to_the_uncut_layer():
    """Eight devices of 1 expert each: their held parts, the shared expert
    counted once, are the layer with all 8 held, and the reference's."""
    cfg = smoke(n_experts=8, top_k=3, experts_held=0, expert_first=0)
    p = _layer_weights(cfg, 6)
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(7))
    whole = moe_apply_held(cfg, _P(p), x)
    shared = R.moe(sizes(cfg), p, x, experts=())
    total = shared.clone()
    for e in range(8):
        share = dataclasses.replace(cfg, experts_held=1, expert_first=e)
        pe = dict(p, **{k: p[k][e:e + 1] for k in ("wu", "wg", "wd")})
        total += moe_apply_held(share, _P(pe), x) - shared
    torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(whole, R.moe(sizes(cfg), p, x), rtol=1e-5,
                               atol=1e-5)
    assert float((whole - shared).abs().max()) > 1e-2


def test_dropless_under_a_skewed_router():
    """A router that sends every token to held expert 3 (far past a
    capacity of 1.25 N K / E) still matches the reference, and the gauge
    reads the load."""
    cfg = smoke()
    p = _layer_weights(cfg, 8)
    g = torch.Generator().manual_seed(9)
    u = torch.randn(cfg.d_model, generator=g)
    x = torch.randn(2, 32, cfg.d_model, generator=g) + 2.0 * u
    p["router"][:, 3] = 100.0 * u / u.norm()
    h = R.rmsnorm(x, p["norm.w"])
    _, idx = torch.topk(h @ p["router"], cfg.top_k, dim=-1)
    N = 64
    assert int((idx == 3).sum()) == N > 1.25 * N * cfg.top_k / cfg.n_experts
    obs.reset()
    obs.enable()
    try:
        got = moe_apply_held(cfg, _P(p), x)
    finally:
        obs.disable()
    torch.testing.assert_close(got, R.moe(sizes(cfg), p, x), rtol=1e-5,
                               atol=1e-5)
    held = torch.stack([(idx == e).sum() for e in (2, 3, 4)]).float()
    assert obs.gauge_value("moe.load_max_over_mean") == pytest.approx(
        float(held.max() / held.mean()))


# ------------------------------------------------- each mechanism counts
def _swapped(w, a, b):
    """The same weights with layers ``a`` and ``b`` swapped."""
    def name(n):
        for x, y in ((a, b), (b, a)):
            if n.startswith(f"layers.{x}."):
                return f"layers.{y}." + n[len(f"layers.{x}."):]
        return n
    return {name(n): t for n, t in w.items()}


def worst_gap(got, want) -> float:
    """The largest gradient gap, over the leaf's largest reference value."""
    return max(float((got[n] - g).abs().max()) / float(g.abs().max())
               for n, g in want.items())


@pytest.mark.parametrize("wrong", [
    {"embedding_multiplier": 1.0}, {"residual_multiplier": 1.0},
    {"attention_multiplier": 0.25}, {"logits_scaling": 1.0},
    {"nope": False}, {"attn_offset": 2}])
def test_each_mechanism_moves_the_result(wrong):
    """Set to a wrong value (1/sqrt(d_head) for the scores' scale, RoPE on,
    attention at layer 2), the port and the reference disagree in some
    gradient by far more than the tolerance."""
    cfg = smoke()
    w, tok = weights(cfg, 10), tokens(cfg, 11)
    _, want = ref_loss_and_grads(sizes(cfg), w, tok)
    if "nope" in wrong:
        _, got = port_loss_and_grads(smoke(**wrong), w, tok)
    elif "attn_offset" in wrong:
        _, got = ref_loss_and_grads(sizes(smoke(**wrong)),
                                    _swapped(w, 1, 2), tok)
        got = _swapped(got, 1, 2)
    else:
        _, got = ref_loss_and_grads(sizes(smoke(**wrong)), w, tok)
    assert worst_gap(got, want) > 100 * TOL


# ------------------------------------------------- the published model
def test_config_is_the_published_model():
    """CONFIG against the published config.json's numbers (the benchmark
    configuration copies them under their own keys): d_state, heads, the
    experts, the pattern, the multipliers, NoPE."""
    pub = json.loads(BENCH_CONFIG.read_text())
    cfg = get_config("granite-4.0-h-small")
    assert (cfg.ssm_state, cfg.ssm_heads, cfg.d_inner // cfg.ssm_heads) == (
        pub["mamba_d_state"], pub["mamba_n_heads"], pub["mamba_d_head"])
    assert cfg.d_inner == pub["mamba_expand"] * pub["hidden_size"]
    assert (pub["mamba_n_groups"], cfg.conv_width) == (1, pub["mamba_d_conv"])
    assert (cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.d_ff_shared) == (
        pub["published"]["num_local_experts"], pub["num_experts_per_tok"],
        pub["intermediate_size"], pub["shared_intermediate_size"])
    assert cfg.n_layers == pub["published"]["num_hidden_layers"]
    assert [cfg.is_attention(i) for i in range(cfg.n_layers)] == [
        t == "attention" for t in pub["layer_types"]]
    for k in ("embedding_multiplier", "residual_multiplier",
              "attention_multiplier", "logits_scaling"):
        assert getattr(cfg, k) == pub[k], k
    assert cfg.nope == (pub["position_embedding_type"] == "nope")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.vocab,
            cfg.tie_embeddings) == (
        pub["hidden_size"], pub["num_attention_heads"],
        pub["num_key_value_heads"], pub["vocab_size"],
        pub["tie_word_embeddings"])
    assert cfg.n_params == pytest.approx(32.2e9, rel=2e-3)
    assert cfg.n_params_active == pytest.approx(9e9, rel=0.05)
    cut = dataclasses.replace(cfg, **pub["overrides"])
    assert cut.n_params == pytest.approx(2.415e9, rel=1e-3)
    assert (cut.held, pub["num_local_experts"]) == (9, 9)


def test_reachable_by_name_but_not_a_jax_parity_arch():
    assert "granite_4p0_h_small" not in ARCH_IDS
    cfg = get_config("granite-4.0-h-small", smoke=True)
    model = api.build_model(cfg, device="cpu")
    assert type(model).__name__ == "HybridMoEModel"
    assert cfg.held < cfg.n_experts
    with pytest.raises(NotImplementedError, match="trains only"):
        model.prefill(tokens(cfg, 0)[:, :8], 16)


#: (n_params, n_params_active, leaves, digest of param_specs) of every
#: arch of ARCH_IDS, CONFIG and SMOKE, before the hybrid_moe fields
BEFORE = {
    "zamba2_2p7b": ((2435058688, 2435058688, 498, "47adc31c6a25428c"),
                    (191488, 191488, 48, "2c44ff2ec360b0d2")),
    "whisper_small": ((209701632, 209701632, 283, "76f9f88303393861"),
                      (147456, 147456, 53, "741bd239e9695a3e")),
    "nemotron_4_15b": ((15627976704, 15627976704, 292, "8b0d5b216c043b69"),
                       (245760, 245760, 22, "61f8e98cbee7dcc4")),
    "minicpm_2b": ((2724694272, 2724694272, 322, "c6b55e8a1f11a999"),
                   (147456, 147456, 18, "544ff616c7812cee")),
    "llama3p2_3b": ((3212574720, 3212574720, 226, "f6d620a09e86f038"),
                    (245760, 245760, 18, "aad8321ffcd5f78f")),
    "phi3_mini_3p8b": ((3820879872, 3820879872, 259, "5f7564bb176b65e7"),
                       (172032, 172032, 19, "d3c20c2e328dfc16")),
    "llama4_scout_17b": ((107769364480, 17172398080, 579, "fb8510e43005c0e3"),
                         (336384, 188928, 27, "f3043944d8bc3c56")),
    "dbrx_132b": ((131596025856, 36469211136, 363, "b48b7fbdf4ddcce1"),
                  (238080, 164352, 21, "a730b42c9d864ccc")),
    "chameleon_34b": ((34292629504, 34292629504, 387, "1c710b2317410d90"),
                      (458752, 458752, 19, "27f73860c777f795")),
    "rwkv6_1p6b": ((1835008000, 1835008000, 387, "785a43525fd60e8b"),
                   (184320, 184320, 35, "708f1c7d06e5c6f5")),
}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_existing_configs_are_unchanged(arch):
    for smoke_, want in zip((False, True), BEFORE[arch]):
        cfg = get_config(arch, smoke_)
        specs = param_specs(cfg)
        txt = ";".join(f"{n}:{tuple(s)}:{d}"
                       for n, (s, d) in sorted(specs.items()))
        assert (cfg.n_params, cfg.n_params_active, len(specs),
                hashlib.sha256(txt.encode()).hexdigest()[:16]) == want


# ---------------------------------------------------------- linear_scan
def _scan_inputs(b, h, t, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, h, t, 128, generator=g)
    k = torch.randn(b, h, t, 128, generator=g) * 0.1
    v = torch.randn(b, h, t, 64, generator=g)
    w = -(torch.rand(b, h, t, 1, generator=g) * 0.2).expand(b, h, t, 128)
    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            w.contiguous().to(device))


@pytest.mark.parametrize("t", [64, 100])
def test_linear_scan_at_dk_128_matches_the_recurrence(t):
    """Mamba-2's shape at d_state 128 (a scalar decay a head, broadcast):
    the CPU path against the exact recurrence, f32."""
    q, k, v, w = _scan_inputs(2, 3, t, torch.float32, "cpu", t)
    torch.testing.assert_close(ops.linear_scan(q, k, v, w),
                               ref.linear_scan(q, k, v, w), rtol=1e-4,
                               atol=1e-4)


@pytest.fixture
def cuda():
    """Decided per test, never at import (xdist workers must agree)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("t", [200, 4096])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_linear_scan_dk_128_kernel_on_card(cuda, t, dtype, tol):
    """One launch a call at dk 128 / dv 64 (ragged T too): against the
    plain chunked version at the kernel tests' 1e-4 / 2e-2 (the same
    algorithm, sums in another order), and against the exact recurrence
    at the JAX sweep's 3e-3 in f32."""
    from repro_torch.kernels import linear_scan as lk
    q, k, v, w = _scan_inputs(2, 8, t, dtype, cuda, t)
    before = lk.launch_count()
    y = ops.linear_scan(q, k, v, w)
    torch.cuda.synchronize()
    assert lk.launch_count() == before + 1
    torch.testing.assert_close(y.float(),
                               ref.linear_scan_chunked(q, k, v, w).float(),
                               rtol=tol, atol=tol)
    if dtype == torch.float32 and t < 1000:
        torch.testing.assert_close(y, ref.linear_scan(q, k, v, w),
                                   rtol=3e-3, atol=3e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("empty", [None, 4])
def test_held_experts_on_card_without_a_host_sync(cuda, empty):
    """The held-expert block in bf16 on the card (grouped products bounded
    on the device, their own backward) against the plain reference's
    block (``R.moe``) in f32 on the CPU, forward and gradients within
    bf16's 3e-2 of the largest value, and neither pass waits on the
    device; with ``empty``, held expert ``empty`` gets no rows, and its
    weights' gradients are exactly zero."""
    cfg = smoke(d_model=256, d_ff=128, d_ff_shared=256, n_experts=16,
                top_k=4, experts_held=5, expert_first=3)
    p = _layer_weights(cfg, 12)
    # each token leans hard on 4 experts of its own, so bf16's rounding
    # of the router's input moves no token to another expert
    g = torch.Generator().manual_seed(13)
    U = torch.linalg.qr(torch.randn(cfg.d_model, 16, generator=g))[0]
    allowed = torch.tensor([e for e in range(16) if e != empty])
    pick = allowed[torch.rand(512, len(allowed), generator=g)
                   .argsort(-1)[:, :4]]
    x = 5.0 * U[:, pick].sum(-1).T.reshape(2, 256, cfg.d_model) \
        + 0.1 * torch.randn(2, 256, cfg.d_model, generator=g)
    p["router"] = 3.0 * U
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    # the router stays f32, as the model holds it
    pc = {n: (t if n == "router" else t.bfloat16()).to(cuda)
          .requires_grad_(True) for n, t in p.items()}
    xc = x.bfloat16().to(cuda).requires_grad_(True)
    pf = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    xf = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = moe_apply_held(bcfg, _P(pc), xc)
        gy = torch.ones_like(y)
        grads = torch.autograd.grad(y, [xc] + list(pc.values()), gy)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = R.moe(sizes(cfg), pf, xf)
    wgrads = torch.autograd.grad(want, [xf] + list(pf.values()),
                                 torch.ones_like(want))
    scale = float(want.abs().max())
    assert float((y.float().cpu() - want).abs().max()) <= 3e-2 * scale
    for g, wg in zip(grads, wgrads):
        s = float(wg.abs().max())
        assert float((g.float().cpu() - wg).abs().max()) <= 3e-2 * s
    if empty is not None:
        j = empty - cfg.expert_first
        named = dict(zip(pc, grads[1:]))
        for n in ("wu", "wg", "wd"):
            assert not bool(named[n][j].any()), n
            assert bool(named[n][j - 1].any()), n
