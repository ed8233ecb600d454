"""Attention, cross-attention, MLP and MoE blocks with spec/apply pairs.

The port of ``repro.models.blocks``.  Every block provides
``*_specs(cfg)``, a spec tree for ONE layer, and functions that take the
layer's ``ParamModule`` (read as ``p["wq"]``, as the JAX code reads its
pytree).  Weights keep the JAX ``(d_in, d_out)`` orientation (``x @ w``;
the MoE experts ``(E, d_in, d_out)``), so carrying weights across is a
copy.  The MoE block is ``repro``'s capacity-based top-k dispatch in plain
torch, step for step, in four parts (``moe_dispatch``, ``moe_experts``,
``moe_combine``, ``moe_shared``) that the sharded blocks of
``repro_torch.distributed.moe_ep`` share: under a mesh the model sends it
to the expert-parallel block where that applies, else to the block that
runs each rank's experts on the replicated stream.

Attention and the MLP take a ``TensorParallel`` context (``tp``; the
one-device ``NO_TP`` by default).  Under a mesh, attention is
tensor-parallel over heads: ``wq`` is split by heads and the packed
``wkv`` by KV head (placed with ``sharding.kv_order``, so each rank's
block is its K heads then its V heads), ``wo`` is row-parallel; the MLP's
``wu``/``wg`` are column-parallel and ``wd`` row-parallel.  Where the
heads do not divide the model axis, attention runs whole on every rank on
weights gathered for the call.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops

from .common import (NO_TP, SpecTree, TensorParallel, activation,
                     apply_norm, apply_rope, chunked_attention, dense,
                     norm_spec)


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# -------------------------------------------------------------------- attention
def attn_specs(cfg: ArchConfig, cross: bool = False) -> SpecTree:
    """One attention block; ``cross`` changes nothing (``repro``'s
    signature: a cross block has the same leaves)."""
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
         kv_src: Optional[torch.Tensor] = None, tp: TensorParallel = NO_TP
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v of this rank's heads; under a sequence-sharded stream over
    the whole sequence."""
    (H, Hkv), dh = tp.heads(cfg), cfg.head_dim
    h = tp.enter(tp.norm(cfg.norm, x, p["norm"]))
    q = dense(h, p["wq"]).reshape(*h.shape[:-1], H, dh)
    src = apply_norm(cfg.norm, kv_src, p["norm"]) if kv_src is not None else h
    kv = dense(src, p["wkv"]).reshape(*src.shape[:-1], 2 * Hkv, dh)
    k, v = kv[..., :Hkv, :], kv[..., Hkv:, :]
    return q, k, v


def _gathered(cfg: ArchConfig, p, tp: TensorParallel) -> dict:
    """The block's weights whole, for attention every rank computes."""
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"norm": p["norm"], "wq": tp.full(p["wq"], 1, H * dh),
            "wkv": tp.full(p["wkv"], 1, 2 * Hkv * dh),
            "wo": tp.full(p["wo"], 0, H * dh)}


def attn_train(cfg: ArchConfig, p, x: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               causal: bool = True, use_rope: bool = True,
               tp: TensorParallel = NO_TP) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D) residual delta, both in the stream's
    layout under a mesh."""
    if tp.on and not tp.attn_sharded:
        return tp.from_replicated(attn_train(
            cfg, _gathered(cfg, p, tp), tp.to_replicated(x), positions,
            causal, use_rope))
    q, k, v = _qkv(cfg, p, x, tp=tp)
    B, T = q.shape[:2]
    if use_rope:
        pos = positions if positions is not None else \
            torch.arange(T, device=x.device)
        pos = torch.broadcast_to(pos, (B, T))
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=causal)
    return tp.exit(dense(o.reshape(B, T, -1), p["wo"]))


def cross_attn_train(cfg: ArchConfig, p, x: torch.Tensor,
                     memory: torch.Tensor) -> torch.Tensor:
    """x: (B, T, D) attends over ``memory`` (B, Tenc, D), no mask, no
    RoPE; the block's norm is applied to both."""
    B, T, D = x.shape
    q, k, v = _qkv(cfg, p, x, kv_src=memory)
    o = chunked_attention(q, k, v, causal=False)
    return dense(o.reshape(B, T, -1), p["wo"])


def attn_prefill(cfg: ArchConfig, p, x: torch.Tensor, use_rope: bool = True,
                 tp: TensorParallel = NO_TP
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (residual delta, (k, v)) for the prompt; k/v (B, T, Hkv, dh)
    of this rank's KV heads."""
    B, T, D = x.shape
    q, k, v = _qkv(cfg, p, x, tp=tp)
    if use_rope:
        pos = torch.broadcast_to(torch.arange(T, device=x.device), (B, T))
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=True)
    return tp.exit(dense(o.reshape(B, T, -1), p["wo"])), (k, v)


def attn_decode(cfg: ArchConfig, p, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, length: torch.Tensor,
                use_rope: bool = True, tp: TensorParallel = NO_TP
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token step.  x: (B, D); caches: (B, S, Hkv, dh); length: (B,).

    Writes the new K/V at position ``length`` of each row IN PLACE (the JAX
    version scatters into new caches) and returns (residual delta (B, D),
    k_cache, v_cache).  The new token attends over length+1 entries through
    ``ops.gqa_decode`` (the CUDA kernel on the card); under a mesh on this
    rank's heads and its (B, S, Hkv/m, dh) caches.
    """
    B, D = x.shape
    q, k, v = _qkv(cfg, p, x[:, None, :], tp=tp)
    if use_rope:
        q = apply_rope(q, length[:, None], cfg.rope_theta)
        k = apply_rope(k, length[:, None], cfg.rope_theta)
    rows = torch.arange(B, device=x.device)
    pos = length.long()
    k_cache[rows, pos] = k[:, 0]
    v_cache[rows, pos] = v[:, 0]
    o = ops.gqa_decode(q[:, 0].contiguous(), k_cache, v_cache, length + 1)
    return tp.exit(dense(o.reshape(B, -1), p["wo"])), k_cache, v_cache


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


def mlp_apply(cfg: ArchConfig, p, x: torch.Tensor,
              tp: TensorParallel = NO_TP) -> torch.Tensor:
    """x -> residual delta; under a mesh ``wu``/``wg`` column-parallel,
    ``wd`` row-parallel."""
    h = tp.enter(tp.norm(cfg.norm, x, p["norm"]))
    up = dense(h, p["wu"])
    gate = dense(h, p["wg"]) if cfg.act == "swiglu" else None
    return tp.exit(dense(activation(cfg.act, up, gate), p["wd"]))


# ------------------------------------------------------------------------- MoE
def moe_specs(cfg: ArchConfig) -> SpecTree:
    """The router (f32 in any model), the experts' stacked MLP weights and,
    where the config has one, the shared expert (an MLP without a norm)."""
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = dtype_of(cfg)
    s = {"norm": norm_spec(cfg.norm, D, dt),
         "router": ((D, E), torch.float32),
         "wu": ((E, D, F), dt),
         "wd": ((E, F, D), dt)}
    if cfg.act == "swiglu":
        s["wg"] = ((E, D, F), dt)
    if cfg.shared_expert:
        s["shared"] = {k: v for k, v in mlp_specs(cfg).items() if k != "norm"}
    return s


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Rows an expert takes for ``n_tokens`` tokens: ``N K / E`` times the
    capacity factor, rounded up to a multiple of 8, at most N."""
    E, K = cfg.n_experts, cfg.top_k
    C = int(math.ceil(n_tokens * K / E * cfg.capacity_factor / 8.0)) * 8
    return min(C, n_tokens)


def moe_route(cfg: ArchConfig, p, x: torch.Tensor):
    """x: (B, T, D) -> (the normed tokens (N, D), the router logits (N, E)
    in f32, their top k: ``(values, indices)``, each (N, K))."""
    h = apply_norm(cfg.norm, x, p["norm"])
    flat = h.reshape(-1, x.shape[-1])
    logits = flat.float() @ p["router"]
    return flat, logits, torch.topk(logits, cfg.top_k, dim=-1)


def moe_dispatch(flat: torch.Tensor, idx: torch.Tensor, n_experts: int,
                 C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flat`` (N, D) tokens routed by ``idx`` (N, K) into their experts'
    queues of C rows: each (token, k)'s ``slot`` (N K,) and the (E, C, D)
    buffers.  A stable sort of the flat expert ids gives each (token, k)
    its place in its expert's queue; a place at or past C goes to the one
    spill row ``E C`` (dropped, its contents never read)."""
    N, K = idx.shape
    E, D = n_experts, flat.shape[-1]
    flat_e = idx.reshape(-1)                                       # (N*K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # bincount's length depends on the ids' values; a scatter of ones into
    # E counters is the same integers at a shape a fake tensor can carry
    counts = torch.zeros(E, dtype=sorted_e.dtype,
                         device=flat.device).scatter_add_(
        0, sorted_e, torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(N * K, device=flat.device) - starts[sorted_e]
    slot_sorted = torch.where(pos_in_e < C, sorted_e * C + pos_in_e, E * C)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    buf = flat.new_zeros((E * C + 1, D))
    dispatched = buf.index_put((slot_sorted,), flat[order // K])
    return slot, dispatched[:E * C].reshape(E, C, D)


def moe_experts(cfg: ArchConfig, rows: torch.Tensor, wu: torch.Tensor,
                wg: Optional[torch.Tensor], wd: torch.Tensor) -> torch.Tensor:
    """The experts' MLPs as batched products over their (E, C, D) rows."""
    up = torch.bmm(rows, wu)
    gate_h = torch.bmm(rows, wg) if cfg.act == "swiglu" else None
    return torch.bmm(activation(cfg.act, up, gate_h), wd)


def moe_combine(out_e: torch.Tensor, slot: torch.Tensor,
                gates: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Each token's K expert outputs (``out_e``: (E C, D), a dropped slot
    reads zeros) summed weighted by its gates: (N, D).  The combine is
    FEATHER's reduce-while-reordering over the expert axis."""
    N, K = gates.shape
    out_pad = torch.cat([out_e, flat.new_zeros((1, out_e.shape[-1]))])
    gathered = out_pad[slot.reshape(N, K)]                         # (N, K, D)
    return torch.sum(gathered * gates[..., None].to(flat.dtype), dim=1)


def moe_shared(cfg: ArchConfig, flat: torch.Tensor, wu: torch.Tensor,
               wg: Optional[torch.Tensor], wd: torch.Tensor) -> torch.Tensor:
    """The shared expert (an MLP without a norm) on ``flat`` (N, D)."""
    up = dense(flat, wu)
    gate = dense(flat, wg) if cfg.act == "swiglu" else None
    return dense(activation(cfg.act, up, gate), wd)


def moe_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Capacity-based top-k dispatch, ``repro.models.blocks.moe_apply``
    step for step: the top-k gates softmaxed; the tokens dispatched into
    ``(E, C, D)`` buffers (``moe_dispatch``); the experts run as batched
    products over them; each token gathers its K outputs and sums them
    weighted by its gates; the shared expert adds after.  A bf16 product
    accumulates in f32 and rounds once, as
    ``preferred_element_type=float32`` then ``astype`` does.  C depends on
    the N = B T tokens of the call, so whether a token is dropped depends
    on its batch peers, as in ``repro``."""
    B, T, D = x.shape
    E = cfg.n_experts
    flat, _, (top, idx) = moe_route(cfg, p, x)
    gates = torch.softmax(top, dim=-1)                             # (N, K)
    slot, dispatched = moe_dispatch(flat, idx, E,
                                    moe_capacity(cfg, B * T))
    wg = p["wg"] if cfg.act == "swiglu" else None
    out_e = moe_experts(cfg, dispatched, p["wu"], wg, p["wd"])
    combined = moe_combine(out_e.reshape(-1, D), slot, gates, flat)
    if cfg.shared_expert:
        sp = p["shared"]
        combined = combined + moe_shared(
            cfg, flat, sp["wu"], sp["wg"] if cfg.act == "swiglu" else None,
            sp["wd"])
    return combined.reshape(B, T, D)
