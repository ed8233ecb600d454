"""rwkv6-1.6b (Finch, https://arxiv.org/abs/2404.05892) as the port's
training step computes it: the plain reference and the benchmark's count.

A configuration of kind ``lm_train`` names its model module; the harness
(``bench/train.py``) loads it by path and reads these names:

* ``PORT_KEYS``: the configuration's keys that must equal the port's
  ``ArchConfig`` fields of the same name (the harness refuses a program
  that computes another model);
* ``param_shapes(config)``: every parameter, (shape, dtype), under the
  port's names (``LMModel.params``), in the order the weights are drawn;
* ``init(config, name, shape)``: (mean, std) of a parameter's normal draw;
* ``loss_and_grads(config, params, tokens, precision)``: the mean
  next-token loss of ``tokens`` (B, T+1) and every parameter's gradient,
  in plain ``torch``, in blocks of ``reference_rows`` sequences (each
  layer under ``torch.utils.checkpoint``, so that a block fits), in
  fp32 (``precision="fp32"``; the caller turns TF32 off) or, as the
  control, in fp8 e4m3 where the program computes in bf16 (``"fp8"``):
  every product's operands, and the tensors the port holds in bf16
  between its kernels (the embedding's rows, the scan's r, k and v, the
  residual stream after each block) rounded to fp8 under a per-tensor
  scale, their gradients too; sums and the rest in f32;
* ``flops_per_step(config, sequences, tokens)`` and
  ``scan_call_work(config, sequences, tokens)``: the count.

The equations are the port's (``repro_torch.models.ssm.rwkv6_train``,
``models.lm``, ``blocks.mlp_apply``), written from the recurrence and
not from the port's code: no import of ``repro_torch``.  Each layer:

    h = rmsnorm(x) w_norm;  h' = h one step later (zero first)
    m_i = h + (h' - h) mu_i,  i = r, k, v, w, g
    r, k, v = m_r Wr, m_k Wk, m_v Wv;  g = silu(m_g Wg)
    log w = -exp(w0 + tanh(m_w W1) W2)
    per head (64 channels): S_t = diag(w_t) S_{t-1} + k_t^T v_t,
        y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    x += (rmsnorm(y) w_lnx * g) Wo
    x += (silu(rmsnorm(x) Wg_ffn) * (rmsnorm(x) Wu)) Wd

then rmsnorm, the untied head and the mean cross-entropy.  The
recurrence runs in chunks of ``CHUNK`` steps: inside a chunk every pair
(s < t) at once through its decay exp(sum_{s<j<t} log w_j), across chunks
the state, one chunk after another; every exponent is <= 0.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: the configuration's keys the port's config must agree with
PORT_KEYS = ("family", "n_layers", "d_model", "n_heads", "d_ff", "vocab",
             "d_inner", "ssm_heads", "act", "norm", "tie_embeddings",
             "dtype")
#: steps of the recurrence a chunk
CHUNK = 32
#: fp8 e4m3's largest finite value: the per-tensor scale maps max |x| to it
FP8_MAX = 448.0


# ------------------------------------------------------------ parameters
def _sizes(config: dict) -> Tuple[int, int, int, int, int, int, int]:
    return (config["n_layers"], config["d_model"], config["d_inner"],
            config["d_ff"], config["vocab"], config["ssm_heads"],
            config["decay_lora_rank"])


def param_shapes(config: dict) -> Dict[str, Tuple[tuple, str]]:
    L, D, di, F_, V, _, rank = _sizes(config)
    dt, f32 = config["dtype"], "float32"
    out = {"embed": ((V, D), dt), "final_norm.w": ((D,), dt),
           "lm_head": ((D, V), dt)}
    for i in range(L):
        p = f"layers.{i}."
        out.update({
            p + "mixer.norm.w": ((D,), dt), p + "mixer.mu": ((5, D), dt),
            p + "mixer.wr": ((D, di), dt), p + "mixer.wk": ((D, di), dt),
            p + "mixer.wv": ((D, di), dt), p + "mixer.wg": ((D, di), dt),
            p + "mixer.w0": ((di,), f32), p + "mixer.w1": ((D, rank), dt),
            p + "mixer.w2": ((rank, di), dt), p + "mixer.u": ((di,), f32),
            p + "mixer.ln_x.w": ((di,), dt), p + "mixer.wo": ((di, D), dt),
            p + "ffn.norm.w": ((D,), dt), p + "ffn.wu": ((D, F_), dt),
            p + "ffn.wd": ((F_, D), dt), p + "ffn.wg": ((D, F_), dt)})
    return out


def init(config: dict, name: str, shape: tuple) -> Tuple[float, float]:
    """(mean, std) of the parameter's normal draw (``config["init"]``):
    norm weights about 1, the token-shift mix about 1/2, products over
    their fan-in, the decay LoRA's output small, ``w0`` about its
    ``log_decay_base`` so that the decays span tens to hundreds of steps."""
    c = config["init"]
    leaf = name.rsplit(".", 1)[-1] if not name.endswith(".w") else "norm"
    if leaf == "norm":
        return 1.0, c["norm_std"]
    if leaf == "mu":
        return 0.5, c["mu_std"]
    if leaf == "w0":
        return c["log_decay_base"], c["log_decay_std"]
    if leaf == "u":
        return 0.0, c["bonus_std"]
    if leaf == "embed":
        return 0.0, 1.0
    if leaf == "w2":
        return 0.0, c["decay_lora_gain"] / math.sqrt(shape[0])
    return 0.0, 1.0 / math.sqrt(shape[0])


# ------------------------------------------------------------- products
def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 under a per-tensor scale, back in f32."""
    scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8Product(torch.autograd.Function):
    """``a @ b`` with both operands, and in the backward the incoming
    gradient, rounded to fp8 e4m3; the sums in f32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        return ga, gb


class _Fp8Round(torch.autograd.Function):
    """``x`` rounded to fp8 e4m3, and in the backward its gradient."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def _precision(precision: str):
    """(product, rounding) of ``precision``: the product of two operands,
    and what a tensor the program holds in its dtype goes through."""
    if precision == "fp32":
        return torch.matmul, lambda x: x
    if precision == "fp8":
        return _Fp8Product.apply, _Fp8Round.apply
    raise ValueError(f"precision {precision!r}: fp32 or fp8")


# ---------------------------------------------------------------- model
def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * w


def wkv(r, k, v, logw, u, heads: int, chunk: int = CHUNK) -> torch.Tensor:
    """RWKV6's recurrence over (B, T, di) operands (``logw`` <= 0, ``u``
    (di,)), per head: y_t = r_t (S_{t-1} + diag(u) k_t^T v_t), S_t =
    diag(w_t) S_{t-1} + k_t^T v_t, S_0 = 0.  Returns (B, T, di)."""
    B, T, di = r.shape
    hd = di // heads
    pad = -T % chunk                       # padding: r = k = v = 0, w = 1
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, pad)) for t in (r, k, v, logw))
    n = (T + pad) // chunk

    def split(t):                          # (B, H, n, chunk, hd)
        return t.reshape(B, n, chunk, heads, hd).permute(0, 3, 1, 2, 4)

    r_, k_, v_, w_ = split(r), split(k), split(v), split(logw)
    cum = torch.cumsum(w_, -2)             # sum_{start <= j <= t}
    ecum = cum - w_                        # sum_{start <= j < t}
    # inside a chunk: s < t, decayed by w_{s+1} .. w_{t-1}
    diff = ecum[..., :, None, :] - cum[..., None, :, :]
    below = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=r.device).tril(-1)
    decay = torch.exp(diff.masked_fill(~below[:, :, None], -math.inf))
    scores = torch.einsum("bhntd,bhnsd,bhntsd->bhnts", r_, k_, decay)
    y = scores @ v_
    y = y + torch.sum(r_ * u.reshape(heads, 1, 1, hd) * k_, -1,
                      keepdim=True) * v_
    # across chunks: the state entering each chunk
    last = cum[..., -1:, :]
    carry = (k_ * torch.exp(last - cum)).transpose(-1, -2) @ v_
    keep = torch.exp(last)[..., 0, :, None]          # (B, H, n, hd, 1)
    S = r.new_zeros(B, heads, hd, hd)
    entering = []
    for c in range(n):
        entering.append(S)
        S = keep[:, :, c] * S + carry[:, :, c]
    y = y + (r_ * torch.exp(ecum)) @ torch.stack(entering, 2)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, n * chunk, di)
    return y[:, :T]


def _layer(config: dict, p: Dict[str, torch.Tensor], i: int, mm, rd,
           x: torch.Tensor) -> torch.Tensor:
    eps = config["norm_eps"]
    a = f"layers.{i}.mixer."
    h = _rmsnorm(x, p[a + "norm.w"], eps)
    prev = F.pad(h, (0, 0, 1, 0))[:, :-1]
    mu = p[a + "mu"]
    mix = [h + (prev - h) * mu[j] for j in range(5)]
    r, k, v = mm(mix[0], p[a + "wr"]), mm(mix[1], p[a + "wk"]), \
        mm(mix[2], p[a + "wv"])
    logw = -torch.exp(p[a + "w0"] + mm(torch.tanh(mm(mix[3], p[a + "w1"])),
                                       p[a + "w2"]))
    g = F.silu(mm(mix[4], p[a + "wg"]))
    y = wkv(rd(r), rd(k), rd(v), logw, p[a + "u"], config["ssm_heads"])
    x = rd(x + mm(_rmsnorm(y, p[a + "ln_x.w"], eps) * g, p[a + "wo"]))
    f = f"layers.{i}.ffn."
    h = _rmsnorm(x, p[f + "norm.w"], eps)
    return rd(x + mm(F.silu(mm(h, p[f + "wg"])) * mm(h, p[f + "wu"]),
                     p[f + "wd"]))


def _sequence_loss(config: dict, p: Dict[str, torch.Tensor], mm, rd,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one block of sequences (b, T+1)."""
    inp, tgt = tokens[:, :-1].long(), tokens[:, 1:].long()
    x = rd(p["embed"][inp])
    for i in range(config["n_layers"]):
        x = checkpoint(lambda t, i=i: _layer(config, p, i, mm, rd, t), x,
                       use_reentrant=False)
    h = _rmsnorm(x, p["final_norm.w"], config["norm_eps"])
    logits = mm(h, p["lm_head"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tgt.reshape(-1), reduction="sum")


def loss_and_grads(config: dict, params: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, precision: str = "fp32"
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy over ``tokens`` (B, T+1) and its
    gradient by every leaf of ``params`` (f32 tensors), summed over blocks
    of ``config["reference_rows"]`` sequences."""
    mm, rd = _precision(precision)
    names = list(params)
    leaves = [params[n].detach().requires_grad_(True) for n in names]
    p = dict(zip(names, leaves))
    scale = 1.0 / (tokens.shape[0] * (tokens.shape[1] - 1))
    total, grads = 0.0, None
    rows = config["reference_rows"]
    for b in range(0, tokens.shape[0], rows):
        loss = _sequence_loss(config, p, mm, rd, tokens[b:b + rows]) * scale
        g = torch.autograd.grad(loss, leaves)
        if grads is None:
            grads = list(g)
        else:
            for a, c in zip(grads, g):
                a.add_(c)
        total += float(loss.detach())
        del loss, g
    return total, dict(zip(names, grads))


# ---------------------------------------------------------------- count
def _forward_macs_per_token(config: dict) -> float:
    """Multiply-adds a token of the forward's products: the projections,
    the decay LoRA, the output, the MLP and the head (the embedding is a
    lookup), and the recurrence's two (dk x dv) products a head."""
    L, D, di, F_, V, H, rank = _sizes(config)
    hd = di // H
    layer = 5 * D * di + D * rank + rank * di + 3 * D * F_ + 2 * H * hd * hd
    return L * layer + D * V


def flops_per_step(config: dict, sequences: int, tokens: int) -> float:
    """FLOPs a training step needs: three times the forward's (forward,
    and the backward's two products for each), 2 a multiply-add;
    recomputation is not counted."""
    return 3 * 2 * _forward_macs_per_token(config) * sequences * tokens


def scan_call_work(config: dict, sequences: int, tokens: int
                   ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one forward call of the scan at the cell's shapes:
    the recurrence's two products a step of each head, and r, k, v read
    in the model's dtype, the f32 log decay read and the output written
    in the model's dtype, once each."""
    _, _, di, _, _, H, _ = _sizes(config)
    hd = di // H
    item = torch.tensor([], dtype=getattr(torch, config["dtype"])
                        ).element_size()
    steps = sequences * tokens * H
    return (4.0 * hd * hd * steps,
            float(steps * hd * (3 * item + 4 + item)))
