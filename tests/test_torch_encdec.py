"""The port's whisper encoder-decoder on the CPU against the JAX package's.

whisper_small at its SMOKE widths (2 + 2 layers, d_model 64, 32 stub
frames).  The JAX model draws its parameters; ``to_torch_lm_params``
carries them into the port (``enc_layers`` and ``dec_layers`` unstacked
each at its own depth), and the same numpy-seeded frames and tokens go
through both: ``encode``, ``_decoder_hidden``, the loss and every gradient
against ``jax.value_and_grad`` (each within 1e-4 of its own max |g|),
``prefill`` with zero stub frames and with given ones, three
teacher-forced ``decode_step``s (rtol 1e-4 / atol 1e-5: f32 on both
sides, sums in other orders), the serve engine's greedy tokens against
the JAX engine's loop, and one step of the port's launcher on the
stream's frames.  Parameters are drawn at ``SCALE`` x the 0.02 init, where
the memory visibly moves the logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.kernels import gqa_decode as gk
from repro_torch.launch import train as launch_train
from repro_torch.models import EncDecModel, build_model
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.weights import to_torch_lm_params
from test_torch_serve import _jax_greedy

ARCH = "whisper_small"
TOL = dict(rtol=1e-4, atol=1e-5)
B, T, MAX_SEQ, N_DECODE = 2, 12, 16, 3
SCALE = 5.0


@pytest.fixture(scope="module")
def pair():
    jm = jbuild_model(jget_config(ARCH, smoke=True))
    params = jax.tree.map(lambda a: np.asarray(a) * np.float32(SCALE),
                          jm.init(jax.random.PRNGKey(3)))
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, device="cpu").load_params(
        to_torch_lm_params(params, cfg, "cpu"))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
    frames = rng.normal(size=(B, cfg.enc_frames, cfg.d_model)
                        ).astype(np.float32)
    return {"jm": jm, "params": params, "cfg": cfg, "model": model,
            "toks": toks, "frames": frames}


def test_build_model_gives_the_encoder_decoder(pair):
    m, cfg = pair["model"], pair["cfg"]
    assert isinstance(m, EncDecModel)
    names = m.params()
    assert len(m.enc_layers) == cfg.enc_layers
    assert len(m.dec_layers) == cfg.n_layers
    assert names["pos_embed"].shape == (32768, cfg.d_model)
    assert names["enc_pos"].shape == (cfg.enc_frames, cfg.d_model)
    assert "dec_layers.1.cross.wkv" in names and "lm_head" not in names
    assert names["enc_layers.0.attn.norm.b"].shape == (cfg.d_model,)


def test_encode_and_decoder_hidden_match_jax(pair):
    jm, params, m = pair["jm"], pair["params"], pair["model"]
    mem_j = jm.encode(params, jnp.asarray(pair["frames"]))
    hid_j = jm._decoder_hidden(params, jnp.asarray(pair["toks"]), mem_j,
                               remat=False)
    with torch.no_grad():
        mem = m.encode(torch.from_numpy(pair["frames"]))
        hid = m._decoder_hidden(torch.from_numpy(pair["toks"]), mem)
        logits = m.logits(hid)
    assert mem.shape == (B, pair["cfg"].enc_frames, pair["cfg"].d_model)
    assert_allclose(mem.numpy(), np.asarray(mem_j), **TOL)
    assert_allclose(hid.numpy(), np.asarray(hid_j), **TOL)
    assert_allclose(logits.numpy(), np.asarray(jm.logits(params, hid_j)),
                    **TOL)


def test_loss_and_grads_match_jax(pair):
    jm, params, cfg = pair["jm"], pair["params"], pair["cfg"]
    toks = np.random.default_rng(8).integers(
        0, cfg.vocab, size=(B, 17)).astype(np.int32)
    batch = {"tokens": toks, "frames": pair["frames"]}
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = to_torch_lm_params(jax.tree.map(np.asarray, jgrads), cfg,
                                "cpu")
    m = build_model(cfg, device="cpu").load_params(
        to_torch_lm_params(params, cfg, "cpu"))
    m.requires_grad_(True)
    named = m.params()
    loss = m.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    grads = torch.autograd.grad(loss, list(named.values()))
    for (name, _), g in zip(named.items(), grads):
        want = jgrads[name].numpy()
        assert_allclose(g.numpy(), want, rtol=0,
                        atol=1e-4 * np.abs(want).max(), err_msg=name)
    # the encoder is in the loss: its first layer gets a gradient
    assert float(jgrads["enc_layers.0.attn.wq"].abs().max()) > 0


@pytest.mark.parametrize("with_frames", [False, True])
def test_prefill_and_decode_match_jax(pair, with_frames):
    """``prefill`` (zero stub frames when none are given, as in ``repro``)
    and three teacher-forced decode steps: logits and every cache entry,
    the cross-attention K/V included."""
    jm, params, m = pair["jm"], pair["params"], pair["model"]
    toks = pair["toks"]
    P = T - N_DECODE
    fr = pair["frames"] if with_frames else None
    jc, jl = jm.prefill(params, jnp.asarray(toks[:, :P]), MAX_SEQ,
                        frames=None if fr is None else jnp.asarray(fr))
    with torch.no_grad():
        cache, logits = m.prefill(torch.from_numpy(toks[:, :P]), MAX_SEQ,
                                  frames=None if fr is None
                                  else torch.from_numpy(fr))
    assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v", "ck", "cv"):
        assert_allclose(cache["layers"][name].numpy(),
                        np.asarray(jc["layers"][name]), **TOL, err_msg=name)
    assert cache["length"].tolist() == [P] * B
    before = gk.launch_count()
    for t in range(P, T):
        jc, jl = jm.decode_step(params, jc, jnp.asarray(toks[:, t]))
        with torch.no_grad():
            cache, logits = m.decode_step(cache, torch.from_numpy(toks[:, t]))
        assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        assert_allclose(cache["layers"]["k"].numpy(),
                        np.asarray(jc["layers"]["k"]), **TOL)
        assert np.array_equal(cache["length"].numpy(),
                              np.asarray(jc["length"]))
    assert gk.launch_count() == before        # the CPU runs the plain path


def test_the_memory_moves_the_logits(pair):
    """Prefill with the seeded frames against zero frames: the encoder's
    memory changes the logits by more than 10% of their max, so the
    checks above see the encoder and the cross-attention."""
    m, toks = pair["model"], torch.from_numpy(pair["toks"])
    with torch.no_grad():
        _, zero = m.prefill(toks, MAX_SEQ)
        _, given = m.prefill(toks, MAX_SEQ,
                             frames=torch.from_numpy(pair["frames"]))
    assert float((given - zero).abs().max()) > 0.1 * float(zero.abs().max())


def test_engine_tokens_match_jax_and_sequential(pair):
    """The engine serves whisper with zero stub frames: batched equals one
    request a batch (no row sees another), and the tokens are the JAX
    loop's up to the first near tie."""
    batch, P, gen = 3, 6, 5
    jm, params, cfg = pair["jm"], pair["params"], pair["cfg"]
    weights = to_torch_lm_params(params, cfg, "cpu")
    prompts = np.random.default_rng(12).integers(
        0, cfg.vocab, size=(5, P)).astype(np.int32)
    kw = dict(arch=ARCH, smoke=True, max_batch=batch, prompt_len=P, gen=gen,
              device="cpu")
    with ServeEngine(ServeConfig(workers=2, **kw), weights=weights) as eng, \
            ServeEngine(ServeConfig(assemble_max=1, **kw),
                        weights=weights) as seq:
        got = eng.serve(list(prompts))
        want = seq.serve(list(prompts))
    for a, b in zip(got, want):
        assert a.dtype == np.int32 and a.shape == (gen,)
        assert np.array_equal(a, b)
    toks, gaps = _jax_greedy(jm, params, prompts, len(prompts), gen)
    checked = 0
    for i in range(len(prompts)):
        for t in range(gen):
            if gaps[i, t] <= 10 * TOL["atol"]:
                break
            assert got[i][t] == toks[i, t], (i, t)
            checked += 1
    assert checked >= 3 * gen


def test_launcher_trains_on_the_stub_frames(capsys):
    """One ``repro_torch.launch.train`` step of whisper SMOKE on the CPU:
    the stream carries (B, enc_frames, d_model) frames and the step hands
    them to the loss."""
    out = launch_train.train(launch_train.parse_args(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--log-every", "1"]))
    losses = list(out["losses"].values())
    assert len(losses) == 2 and np.isfinite(losses).all()
    # ln(vocab) at the 0.02 init, within 0.5
    assert abs(losses[0] - np.log(get_config(ARCH, smoke=True).vocab)) < 0.5
    assert isinstance(out["model"], EncDecModel)
    assert out["opt_state"].step == 2
