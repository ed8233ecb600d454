"""Granite-4.0-H Small (granitemoehybrid,
https://huggingface.co/ibm-granite/granite-4.0-h-small) as the port's
training step computes it, on one device's share of an expert-parallel
deployment: the plain reference and the benchmark's count.

The harness (``bench/train.py``) loads this module by path and reads the
names the rwkv6 module documents: ``PORT_KEYS``, ``param_shapes``,
``init``, ``loss_and_grads`` (fp32, or the fp8 e4m3 control: every
product's operands, and the tensors the program holds in bf16 between its
kernels, the embedding's rows, the scan's x, B and C, attention's q, k
and v, the expert block's normed input, the residual stream after each
branch, rounded to fp8 under a per-tensor scale, their gradients too; the
router, sums and the rest in f32), ``flops_per_step`` and
``scan_call_work``.

The equations are the published model's, written from its description
and not from the port's code (no import of ``repro_torch``); rmsnorm's
epsilon is 1e-5:

    x = E[tokens] * embedding_multiplier
    layer i, attention where i % attn_period == attn_offset, else Mamba2:
      h = rmsnorm(x) w_norm
      Mamba2: [z | xBC | dt] = h W_in;  xBC = silu(causal_conv4(xBC) + b)
              x_s (heads of P), B, C (d_state, one group, every head's)
              dt = softplus(dt + dt_bias);  A = -exp(A_log)
              S_t = exp(dt_t A) S_{t-1} + dt_t B_t^T x_t   (d_state x P)
              y_t = C_t S_t + D x_t;  out = rmsnorm(y * silu(z)) w  W_out
      attention (NoPE): softmax(q k^T * attention_multiplier, causal) v Wo
      x = x + residual_multiplier * out
      h = rmsnorm(x) w_post;  l = h W_router (all n_experts, f32)
      (g, e) = top_k(l);  g = softmax(g)
      moe = sum over k with e_k held here of g_k swiglu_{e_k}(h)
            + swiglu_shared(h)
      x = x + residual_multiplier * moe
    logits = rmsnorm(x) w_f E^T / logits_scaling;  mean cross-entropy

The scan is Mamba-2's chunked form (SSD): its decay is one scalar a head
and step, so inside a chunk of ``CHUNK`` steps every pair s <= t is one
score C_t . B_s (shared by the heads) times exp(cum_t - cum_s) dt_s, and
across chunks the state passes from one chunk to the next; every
exponent is <= 0.  The experts held are ``experts_held`` from
``expert_first``: each runs on the tokens routed to it; what the absent
experts would add is left out, as the program leaves it out.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: the configuration's keys the port's config must agree with
PORT_KEYS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
             "d_head", "d_ff", "d_ff_shared", "vocab", "n_experts", "top_k",
             "experts_held", "expert_first", "shared_expert", "ssm_state",
             "ssm_heads", "d_inner", "conv_width", "attn_period",
             "attn_offset", "embedding_multiplier", "residual_multiplier",
             "attention_multiplier", "logits_scaling", "nope", "act", "norm",
             "tie_embeddings", "dtype")
#: steps of the recurrence a chunk
CHUNK = 64
#: fp8 e4m3's largest finite value: the per-tensor scale maps max |x| to it
FP8_MAX = 448.0


# ------------------------------------------------------------ parameters
def is_attention(config: dict, i: int) -> bool:
    return i % config["attn_period"] == config["attn_offset"]


def param_shapes(config: dict) -> Dict[str, Tuple[tuple, str]]:
    c = config
    D, V, dh = c["d_model"], c["vocab"], c["d_head"]
    H, Hkv, F_, Fs = c["n_heads"], c["n_kv_heads"], c["d_ff"], \
        c["d_ff_shared"]
    di, N, Hs, W = c["d_inner"], c["ssm_state"], c["ssm_heads"], \
        c["conv_width"]
    E, Eh = c["n_experts"], c["experts_held"]
    dt, f32 = c["dtype"], "float32"
    out = {"embed": ((V, D), dt), "final_norm.w": ((D,), dt)}
    for i in range(c["n_layers"]):
        a, f = f"layers.{i}.mixer.", f"layers.{i}.ffn."
        if is_attention(c, i):
            out.update({a + "norm.w": ((D,), dt),
                        a + "wq": ((D, H * dh), dt),
                        a + "wkv": ((D, 2 * Hkv * dh), dt),
                        a + "wo": ((H * dh, D), dt)})
        else:
            out.update({a + "norm.w": ((D,), dt),
                        a + "in_proj": ((D, 2 * di + 2 * N + Hs), dt),
                        a + "conv_w": ((W, di + 2 * N), dt),
                        a + "conv_b": ((di + 2 * N,), dt),
                        a + "A_log": ((Hs,), f32),
                        a + "D_skip": ((Hs,), f32),
                        a + "dt_bias": ((Hs,), f32),
                        a + "out_norm.w": ((di,), dt),
                        a + "out_proj": ((di, D), dt)})
        out.update({f + "norm.w": ((D,), dt), f + "router": ((D, E), f32),
                    f + "wu": ((Eh, D, F_), dt), f + "wd": ((Eh, F_, D), dt),
                    f + "wg": ((Eh, D, F_), dt),
                    f + "shared.wu": ((D, Fs), dt),
                    f + "shared.wd": ((Fs, D), dt),
                    f + "shared.wg": ((D, Fs), dt)})
    return out


def init(config: dict, name: str, shape: tuple) -> Tuple[float, float]:
    """(mean, std) of the parameter's normal draw (``config["init"]``):
    norm weights about 1, the embedding ``embed_std`` (its rows are
    multiplied by 12), ``A_log`` and ``dt_bias`` about Mamba-2's own
    ranges, the skip ``D`` about 1, the conv's bias small, every product's
    weight (the router's too) z / sqrt(fan-in)."""
    c = config["init"]
    leaf = "norm" if name.endswith(".w") else name.rsplit(".", 1)[-1]
    if leaf == "norm":
        return 1.0, c["norm_std"]
    if leaf == "embed":
        return 0.0, c["embed_std"]
    if leaf == "A_log":
        return c["A_log_mean"], c["A_log_std"]
    if leaf == "dt_bias":
        return c["dt_bias_mean"], c["dt_bias_std"]
    if leaf == "D_skip":
        return 1.0, c["D_skip_std"]
    if leaf == "conv_b":
        return 0.0, c["conv_bias_std"]
    return 0.0, 1.0 / math.sqrt(shape[-2])


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


def ssd(xs, Bm, Cm, dt, A, chunk: int = CHUNK) -> torch.Tensor:
    """Mamba-2's scan: xs (b, T, H, P), Bm and Cm (b, T, N) shared by the
    heads, dt (b, T, H) > 0, A (H,) < 0.  Per head S_t = exp(dt_t A)
    S_{t-1} + dt_t B_t^T x_t, y_t = C_t S_t, S_0 = 0.  Returns (b, T, H,
    P)."""
    b, T, H, P = xs.shape
    pad = -T % chunk                       # padding: x = B = C = dt = 0
    if pad:
        xs, Bm, Cm, dt = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                          for t in (xs, Bm, Cm, dt))
    n = (T + pad) // chunk
    x_ = xs.reshape(b, n, chunk, H, P)
    B_ = Bm.reshape(b, n, chunk, -1)
    C_ = Cm.reshape(b, n, chunk, -1)
    dt_ = dt.reshape(b, n, chunk, H)
    cum = torch.cumsum(dt_ * A, 2)                         # (b, n, c, H)
    # inside a chunk: s <= t, decayed by exp(cum_t - cum_s)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b, n, t, s, H)
    keep = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=xs.device).tril()
    decay = torch.exp(seg.masked_fill(~keep[:, :, None], -math.inf))
    scores = torch.einsum("bnti,bnsi->bnts", C_, B_)
    w = scores[..., None] * decay * dt_[:, :, None, :, :]  # (b, n, t, s, H)
    y = torch.einsum("bntsh,bnshp->bnthp", w, x_)
    # across chunks: each chunk's own contribution to the state at its end,
    # then the state entering each chunk
    last = cum[:, :, -1:, :]                               # (b, n, 1, H)
    carry = torch.einsum("bnsi,bnsh,bnshp->bnhip", B_,
                         torch.exp(last - cum) * dt_, x_)
    keep_state = torch.exp(last[:, :, 0])[..., None, None]  # (b, n, H, 1, 1)
    S = xs.new_zeros(b, H, B_.shape[-1], P)
    entering = []
    for c in range(n):
        entering.append(S)
        S = keep_state[:, c] * S + carry[:, c]
    y = y + torch.einsum("bnti,bnth,bnhip->bnthp", C_, torch.exp(cum),
                         torch.stack(entering, 1))
    return y.reshape(b, n * chunk, H, P)[:, :T]


def _mamba2(config: dict, p, a: str, mm, rd, x: torch.Tensor
            ) -> torch.Tensor:
    c = config
    eps, di, N, H = c["norm_eps"], c["d_inner"], c["ssm_state"], \
        c["ssm_heads"]
    b, T, _ = x.shape
    h = _rmsnorm(x, p[a + "norm.w"], eps)
    zxbcdt = mm(h, p[a + "in_proj"])
    z, xbc, dt_raw = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N], \
        zxbcdt[..., 2 * di + 2 * N:]
    W = c["conv_width"]
    padded = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(padded[:, j:j + T] * p[a + "conv_w"][j] for j in range(W))
    xbc = F.silu(conv + p[a + "conv_b"])
    xs = rd(xbc[..., :di]).reshape(b, T, H, di // H)
    Bm, Cm = rd(xbc[..., di:di + N]), rd(xbc[..., di + N:])
    dt = F.softplus(dt_raw + p[a + "dt_bias"])
    y = ssd(xs, Bm, Cm, dt, -torch.exp(p[a + "A_log"]))
    y = y + xs * p[a + "D_skip"][:, None]
    y = _rmsnorm(y.reshape(b, T, di) * F.silu(z), p[a + "out_norm.w"], eps)
    return mm(y, p[a + "out_proj"])


def _attention(config: dict, p, a: str, mm, rd, x: torch.Tensor
               ) -> torch.Tensor:
    c = config
    b, T, _ = x.shape
    H, Hkv, dh = c["n_heads"], c["n_kv_heads"], c["d_head"]
    h = _rmsnorm(x, p[a + "norm.w"], c["norm_eps"])
    q = rd(mm(h, p[a + "wq"])).reshape(b, T, H, dh)
    kv = rd(mm(h, p[a + "wkv"])).reshape(b, T, 2 * Hkv, dh)
    k = kv[:, :, :Hkv].repeat_interleave(H // Hkv, dim=2)
    v = kv[:, :, Hkv:].repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) * c["attention_multiplier"]
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    att = torch.softmax(s.masked_fill(~causal, -math.inf), -1)
    o = torch.einsum("bhts,bshd->bthd", att, v).reshape(b, T, H * dh)
    return mm(o, p[a + "wo"])


def _moe(config: dict, p, f: str, mm, rd, x: torch.Tensor) -> torch.Tensor:
    """The held experts, each on the (token, k) routed to it, weighted by
    their gates, and the shared expert on every token."""
    c = config
    D = x.shape[-1]
    h = rd(_rmsnorm(x, p[f + "norm.w"], c["norm_eps"])).reshape(-1, D)
    top, idx = torch.topk(h @ p[f + "router"], c["top_k"], dim=-1)
    gates = torch.softmax(top, -1)

    def swiglu(rows, wg, wu, wd):
        return mm(F.silu(mm(rows, wg)) * mm(rows, wu), wd)

    out = swiglu(h, p[f + "shared.wg"], p[f + "shared.wu"],
                 p[f + "shared.wd"])
    for j in range(c["experts_held"]):
        tok, k = torch.nonzero(idx == c["expert_first"] + j, as_tuple=True)
        if tok.numel():
            y = swiglu(h[tok], p[f + "wg"][j], p[f + "wu"][j],
                       p[f + "wd"][j])
            out = out.index_add(0, tok, y * gates[tok, k, None])
    return out.reshape(x.shape)


def _layer(config: dict, p: Dict[str, torch.Tensor], i: int, mm, rd,
           x: torch.Tensor) -> torch.Tensor:
    a, f = f"layers.{i}.mixer.", f"layers.{i}.ffn."
    r = config["residual_multiplier"]
    mixer = _attention if is_attention(config, i) else _mamba2
    x = rd(x + r * mixer(config, p, a, mm, rd, x))
    return rd(x + r * _moe(config, p, f, mm, rd, x))


def _sequence_loss(config: dict, p: Dict[str, torch.Tensor], mm, rd,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one block of sequences (b, T+1)."""
    inp, tgt = tokens[:, :-1].long(), tokens[:, 1:].long()
    x = rd(p["embed"][inp] * config["embedding_multiplier"])
    for i in range(config["n_layers"]):
        x = checkpoint(lambda t, i=i: _layer(config, p, i, mm, rd, t), x,
                       use_reentrant=False)
    h = _rmsnorm(x, p["final_norm.w"], config["norm_eps"])
    logits = mm(h, p["embed"].T) / config["logits_scaling"]
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
def _forward_macs_per_token(config: dict, tokens: int) -> float:
    """Multiply-adds a token of the forward's products: the Mamba2
    projections, the conv and the scan's two (d_state x P) products a
    head, attention's projections and its causal core (a token attends
    over (tokens + 1) / 2 positions on average), the router, the held
    experts at the share of the top_k routes that falls on them when
    routing is even (top_k x experts_held / n_experts), the shared expert
    and the tied head (the embedding is a lookup)."""
    c = config
    D, V, di, N = c["d_model"], c["vocab"], c["d_inner"], c["ssm_state"]
    Hs, W = c["ssm_heads"], c["conv_width"]
    H, Hkv, dh = c["n_heads"], c["n_kv_heads"], c["d_head"]
    mamba = D * (2 * di + 2 * N + Hs) + di * D + W * (di + 2 * N) \
        + 2 * Hs * N * (di // Hs)
    attn = D * dh * (H + 2 * Hkv) + H * dh * D + 2 * H * dh * (tokens + 1) / 2
    routed = c["top_k"] * c["experts_held"] / c["n_experts"]
    moe = D * c["n_experts"] + routed * 3 * D * c["d_ff"] \
        + 3 * D * c["d_ff_shared"]
    mixers = sum(attn if is_attention(c, i) else mamba
                 for i in range(c["n_layers"]))
    return mixers + c["n_layers"] * moe + D * V


def flops_per_step(config: dict, sequences: int, tokens: int) -> float:
    """FLOPs a training step needs: three times the forward's (forward,
    and the backward's two products for each), 2 a multiply-add;
    recomputation is not counted."""
    return 3 * 2 * _forward_macs_per_token(config, tokens) * sequences \
        * tokens


def scan_call_work(config: dict, sequences: int, tokens: int
                   ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one forward call of the scan at the cell's shapes,
    what Mamba-2's recurrence must move once each: x in and y out in the
    model's dtype (d_inner a token each), B and C in the model's dtype
    (d_state a token each, shared by the heads), dt in f32 (a head a
    token).  FLOPs: the chunked recurrence's, per head and token the state
    update and read (2 d_state P multiply-adds) and the causal pairs of its
    chunk (P (CHUNK + 1) / 2), and a chunk's shared scores C . B once
    (d_state (CHUNK + 1) / 2 a token).  The head-broadcast operands a
    kernel may build are not counted."""
    c = config
    di, N, H = c["d_inner"], c["ssm_state"], c["ssm_heads"]
    P = di // H
    item = torch.tensor([], dtype=getattr(torch, c["dtype"])).element_size()
    n = sequences * tokens
    macs = n * (H * (2 * N * P + P * (CHUNK + 1) / 2) + N * (CHUNK + 1) / 2)
    nbytes = n * (2 * di * item + 2 * N * item + H * 4)
    return 2.0 * macs, float(nbytes)
