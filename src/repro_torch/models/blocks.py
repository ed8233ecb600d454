"""Attention and MLP blocks with spec/apply pairs.

The port of ``repro.models.blocks`` (dense blocks; the MoE block comes with
ROADMAP Queue 1 item 6b).  Every block provides ``*_specs(cfg)``, a spec
tree for ONE layer, and functions that take the layer's ``ParamModule``
(read as ``p["wq"]``, as the JAX code reads its pytree).  Weights keep the
JAX ``(d_in, d_out)`` orientation (``x @ w``), so carrying weights across
is a copy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops

from .common import (SpecTree, activation, apply_norm, apply_rope,
                     chunked_attention, dense, norm_spec)


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# -------------------------------------------------------------------- attention
def attn_specs(cfg: ArchConfig) -> SpecTree:
    D, dh = cfg.d_model, cfg.head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    dt = dtype_of(cfg)
    return {
        "norm": norm_spec(cfg.norm, D, dt),
        "wq": ((D, H * dh), dt),
        "wkv": ((D, 2 * Hkv * dh), dt),
        "wo": ((H * dh, D), dt),
    }


def _qkv(cfg: ArchConfig, p, x: torch.Tensor,
         kv_src: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = apply_norm(cfg.norm, x, p["norm"])
    q = dense(h, p["wq"]).reshape(*x.shape[:-1], H, dh)
    src = apply_norm(cfg.norm, kv_src, p["norm"]) if kv_src is not None else h
    kv = dense(src, p["wkv"]).reshape(*src.shape[:-1], 2 * Hkv, dh)
    k, v = kv[..., :Hkv, :], kv[..., Hkv:, :]
    return q, k, v


def attn_train(cfg: ArchConfig, p, x: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               causal: bool = True, use_rope: bool = True) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D) residual delta."""
    B, T, D = x.shape
    q, k, v = _qkv(cfg, p, x)
    if use_rope:
        pos = positions if positions is not None else \
            torch.arange(T, device=x.device)
        pos = torch.broadcast_to(pos, (B, T))
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=causal)
    return dense(o.reshape(B, T, -1), p["wo"])


def attn_prefill(cfg: ArchConfig, p, x: torch.Tensor, use_rope: bool = True
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (residual delta, (k, v)) for the prompt; k/v (B, T, Hkv, dh)."""
    B, T, D = x.shape
    q, k, v = _qkv(cfg, p, x)
    if use_rope:
        pos = torch.broadcast_to(torch.arange(T, device=x.device), (B, T))
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=True)
    return dense(o.reshape(B, T, -1), p["wo"]), (k, v)


def attn_decode(cfg: ArchConfig, p, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, length: torch.Tensor,
                use_rope: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token step.  x: (B, D); caches: (B, S, Hkv, dh); length: (B,).

    Writes the new K/V at position ``length`` of each row IN PLACE (the JAX
    version scatters into new caches) and returns (residual delta (B, D),
    k_cache, v_cache).  The new token attends over length+1 entries through
    ``ops.gqa_decode`` (the CUDA kernel on the card).
    """
    B, D = x.shape
    q, k, v = _qkv(cfg, p, x[:, None, :])
    if use_rope:
        q = apply_rope(q, length[:, None], cfg.rope_theta)
        k = apply_rope(k, length[:, None], cfg.rope_theta)
    rows = torch.arange(B, device=x.device)
    pos = length.long()
    k_cache[rows, pos] = k[:, 0]
    v_cache[rows, pos] = v[:, 0]
    o = ops.gqa_decode(q[:, 0].contiguous(), k_cache, v_cache, length + 1)
    return dense(o.reshape(B, -1), p["wo"]), k_cache, v_cache


# ------------------------------------------------------------------------- MLP
def mlp_specs(cfg: ArchConfig, d_ff: Optional[int] = None) -> SpecTree:
    D, F = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    s = {"norm": norm_spec(cfg.norm, D, dt),
         "wu": ((D, F), dt),
         "wd": ((F, D), dt)}
    if cfg.act == "swiglu":
        s["wg"] = ((D, F), dt)
    return s


def mlp_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg.norm, x, p["norm"])
    up = dense(h, p["wu"])
    gate = dense(h, p["wg"]) if cfg.act == "swiglu" else None
    return dense(activation(cfg.act, up, gate), p["wd"])
