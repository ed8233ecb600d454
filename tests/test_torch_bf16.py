"""The port's ten zoo configs in bf16 on the CPU against the JAX package's.

Each SMOKE config with ``dtype="bfloat16"`` on both sides: the JAX model
draws its parameters, ``to_torch_lm_params`` carries them into the port,
and the same numpy-seeded tokens (B 2, T 12) go through ``hidden_states``
-> ``logits`` (whisper: ``encode`` over numpy-seeded frames ->
``_decoder_hidden`` -> ``logits``).  The two packages round in other
places (bf16 keeps 8 mantissa bits), so the logits are held as max
|dlogit| <= ``TOL`` x max |logit|, the bf16 tolerance of the kernel checks.

At the 0.02 init the scan's output lies below its norm's epsilon and the
MoE blocks give exactly 0.0 in bf16, so rwkv6, zamba2 and the two MoE
configs draw at ``SCALE`` x the init, and each of those cases also asserts
that zeroing its mechanism (the scan's output; the experts' ``wd``) moves
the port's logits by more than ``TOL`` x their max: a wrong scan or
dispatch would then fail the parity check.  whisper's case asserts the
same of its encoder memory (the cross-attention's input), at 5x the init
as ``test_torch_encdec`` draws it (at 1x zeroing the memory moves the
logits by 2.1e-2 x their max, no margin over ``TOL``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.weights import to_torch_lm_params

B, T = 2, 12
TOL = 2e-2
#: x the 0.02 init where the mechanism must shape the logits
SCALE = {"rwkv6_1p6b": 10.0, "zamba2_2p7b": 10.0, "dbrx_132b": 10.0,
         "llama4_scout_17b": 10.0, "whisper_small": 5.0}
SCANS = ("rwkv6_1p6b", "zamba2_2p7b")
MOES = ("dbrx_132b", "llama4_scout_17b")


def _scaled(a, scale):
    a = np.asarray(a)
    return (a.astype(np.float32) * np.float32(scale)).astype(a.dtype)


def _case(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    jm = jbuild_model(dataclasses.replace(jget_config(arch, smoke=True),
                                          dtype="bfloat16"))
    scale = SCALE.get(arch, 1.0)
    params = jax.tree.map(lambda a: _scaled(a, scale),
                          jm.init(jax.random.PRNGKey(3)))
    model = build_model(cfg, device="cpu").load_params(
        to_torch_lm_params(params, cfg, "cpu"))
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab, size=(B, T)).astype(np.int32)
    frames = None
    if cfg.family == "encdec":
        frames = np.random.default_rng(5).normal(
            size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        mem = jm.encode(params, jnp.asarray(frames, dtype=jnp.bfloat16))
        hid = jm._decoder_hidden(params, jnp.asarray(toks), mem, remat=False)
    else:
        hid = jm.hidden_states(params, jnp.asarray(toks), remat=False)
    want = np.asarray(jm.logits(params, hid)).astype(np.float32)
    return cfg, model, toks, frames, want


def _logits(model, toks, frames, zero_memory=False):
    with torch.no_grad():
        t = torch.from_numpy(toks)
        if frames is None:
            return model.logits(model.hidden_states(t)).float().numpy()
        mem = model.encode(torch.from_numpy(frames).to(torch.bfloat16))
        if zero_memory:
            mem = torch.zeros_like(mem)
        return model.logits(model._decoder_hidden(t, mem)).float().numpy()


def _without_mechanism(arch, model, toks, frames):
    """The port's logits with the case's mechanism taken out."""
    if arch in SCANS:
        real = ops.linear_scan
        ops.linear_scan = lambda q, k, v, w: torch.zeros_like(v)
        try:
            return _logits(model, toks, frames)
        finally:
            ops.linear_scan = real
    if arch in MOES:
        named = model.params()
        saved = {n: p.detach().clone() for n, p in named.items()
                 if n.endswith(".ffn.wd")}
        with torch.no_grad():
            for n in saved:
                named[n].zero_()
        try:
            return _logits(model, toks, frames)
        finally:
            with torch.no_grad():
                for n, w in saved.items():
                    named[n].copy_(w)
    return _logits(model, toks, frames, zero_memory=True)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_logits_match_jax(arch):
    cfg, model, toks, frames, want = _case(arch)
    assert next(iter(model.params().values())).dtype == torch.bfloat16
    got = _logits(model, toks, frames)
    assert got.shape == want.shape == (B, T, cfg.vocab)
    top = float(np.abs(want).max())
    assert np.isfinite(got).all() and top > 0
    ratio = float(np.abs(got - want).max()) / top
    assert ratio <= TOL, f"{arch}: max |dlogit| / max |logit| = {ratio:.3e}"
    if arch in SCANS or arch in MOES or cfg.family == "encdec":
        moved = float(np.abs(_without_mechanism(arch, model, toks, frames)
                             - got).max()) / top
        assert moved > TOL, f"{arch}: the mechanism moves the logits by " \
                            f"{moved:.3e} x max |logit|"
