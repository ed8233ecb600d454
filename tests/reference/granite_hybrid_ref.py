"""Granite-4.0-H (granitemoehybrid) in plain ``torch``, the simplest way:
the tests' reference for the port's ``hybrid_moe`` family.

It imports neither the port nor JAX.  ``c`` is a dict of sizes under the
port's ``ArchConfig`` field names (``dataclasses.asdict`` of one);
``params`` is a dict of f32 tensors under the port's parameter names
(``LMModel.params``).  Everything is f32 and written from the published
equations, one step at a time where the port chunks:

    x = E[tokens] * embedding_multiplier
    layer i (attention where i % attn_period == attn_offset, else Mamba2):
      h = rmsnorm(x) w_norm
      Mamba2: [z | xBC | dt] = h W_in;  xBC = silu(causal_conv(xBC) + b)
              per head: S_t = exp(dt_t A) S_{t-1} + dt_t B_t^T x_t,
              y_t = C_t S_t + D x_t;  out = rmsnorm(y * silu(z)) w  W_out
      attention (NoPE): softmax(q k^T * attention_multiplier, causal) v W_o
      x = x + residual_multiplier * out
      h = rmsnorm(x) w_post;  (g, e) = top_k(h W_router);  g = softmax(g)
      moe = sum_k [e_k held] g_k swiglu_{e_k}(h) + swiglu_shared(h)
      x = x + residual_multiplier * moe
    logits = rmsnorm(x) w_f E^T / logits_scaling

The experts held are ``experts_held`` from ``expert_first`` (all where 0);
a token's assignments to the others add nothing.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

EPS = 1e-5


def rmsnorm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + EPS) * w


def is_attention(c: dict, i: int) -> bool:
    return bool(c["attn_period"]) and i % c["attn_period"] == c["attn_offset"]


def held_experts(c: dict) -> Sequence[int]:
    n = c["experts_held"] or c["n_experts"]
    return range(c["expert_first"], c["expert_first"] + n)


def swiglu(h, wg, wu, wd):
    return (F.silu(h @ wg) * (h @ wu)) @ wd


def mamba2(c: dict, p: Dict[str, torch.Tensor], x: torch.Tensor
           ) -> torch.Tensor:
    """The exact recurrence, one step at a time."""
    B, T, _ = x.shape
    di, N, H = c["d_inner"], c["ssm_state"], c["ssm_heads"]
    P = di // H
    h = rmsnorm(x, p["norm.w"])
    zxbcdt = h @ p["in_proj"]
    z, xbc, dt_raw = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N], \
        zxbcdt[..., 2 * di + 2 * N:]
    W = p["conv_w"].shape[0]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    xbc = F.silu(sum(pad[:, j:j + T] * p["conv_w"][j] for j in range(W))
                 + p["conv_b"])
    xs = xbc[..., :di].reshape(B, T, H, P)
    Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    dt = F.softplus(dt_raw + p["dt_bias"])                     # (B, T, H)
    A = -torch.exp(p["A_log"])
    S = x.new_zeros(B, H, N, P)
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t] * A)[:, :, None, None]
        S = decay * S + dt[:, t, :, None, None] * Bm[:, t, None, :, None] \
            * xs[:, t, :, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], S))
    y = torch.stack(ys, 1) + xs * p["D_skip"][:, None]
    y = rmsnorm(y.reshape(B, T, di) * F.silu(z), p["out_norm.w"])
    return y @ p["out_proj"]


def attention(c: dict, p: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> torch.Tensor:
    """Causal GQA with no position encoding; query head j reads KV head
    j // (n_heads / n_kv_heads)."""
    B, T, _ = x.shape
    H, Hkv, dh = c["n_heads"], c["n_kv_heads"], c["d_head"]
    h = rmsnorm(x, p["norm.w"])
    q = (h @ p["wq"]).reshape(B, T, H, dh)
    kv = (h @ p["wkv"]).reshape(B, T, 2 * Hkv, dh)
    k = kv[:, :, :Hkv].repeat_interleave(H // Hkv, dim=2)
    v = kv[:, :, Hkv:].repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) * c["attention_multiplier"]
    mask = torch.ones(T, T, dtype=torch.bool).tril()
    a = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    o = torch.einsum("bhts,bshd->bthd", a, v).reshape(B, T, H * dh)
    return o @ p["wo"]


def moe(c: dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
        experts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The held experts' part and the shared expert, every token through
    every held expert, kept where routed (``experts``: which experts of the
    layer's stack of held ones the sum takes, all by default).  ``p``'s
    stacked weights hold the experts ``held_experts(c)`` in order."""
    h = rmsnorm(x, p["norm.w"])
    top, idx = torch.topk(h @ p["router"], c["top_k"], dim=-1)
    gates = torch.softmax(top, -1)
    out = swiglu(h, p["shared.wg"], p["shared.wu"], p["shared.wd"])
    for j, e in enumerate(held_experts(c)):
        if experts is not None and e not in experts:
            continue
        g = torch.sum(gates * (idx == e), -1, keepdim=True)
        out = out + g * swiglu(h, p["wg"][j], p["wu"][j], p["wd"][j])
    return out


def hidden(c: dict, params: Dict[str, torch.Tensor],
           tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()] * c["embedding_multiplier"]
    r = c["residual_multiplier"]
    for i in range(c["n_layers"]):
        a, f = f"layers.{i}.mixer.", f"layers.{i}.ffn."
        mix = {n[len(a):]: t for n, t in params.items() if n.startswith(a)}
        ffn = {n[len(f):]: t for n, t in params.items() if n.startswith(f)}
        x = x + r * (attention(c, mix, x) if is_attention(c, i)
                     else mamba2(c, mix, x))
        x = x + r * moe(c, ffn, x)
    return rmsnorm(x, params["final_norm.w"])


def loss(c: dict, params: Dict[str, torch.Tensor],
         tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` (B, T+1)."""
    h = hidden(c, params, tokens[:, :-1])
    logits = h @ params["embed"].T / c["logits_scaling"]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())
