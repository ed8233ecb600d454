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
heads do not divide the model axis, training and prefill attention split
their queries by sequence over the model ranks (``_seq_split``: weights
gathered whole, K/V all-gathered along T), and decode keeps every head
in a cache split by sequence, each rank attending over its block and the
ranks merging by log-sum-exp (``attn_decode``, ``_decode_attend``); a T
the model axis does not divide runs attention whole on every rank.
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
    the whole sequence.  ``kv_src`` (cross-attention's memory) is whole on
    every rank, and its normed rows feed this rank's heads (``local``)."""
    (H, Hkv), dh = tp.heads(cfg), cfg.head_dim
    h = tp.enter(tp.norm(cfg.norm, x, p["norm"]))
    q = dense(h, p["wq"]).reshape(*h.shape[:-1], H, dh)
    src = h if kv_src is None else \
        tp.local(apply_norm(cfg.norm, kv_src, p["norm"]))
    kv = dense(src, p["wkv"]).reshape(*src.shape[:-1], 2 * Hkv, dh)
    k, v = kv[..., :Hkv, :], kv[..., Hkv:, :]
    return q, k, v


def _gathered(cfg: ArchConfig, p, tp: TensorParallel) -> dict:
    """The block's weights whole, for attention every rank computes."""
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"norm": p["norm"], "wq": tp.full(p["wq"], 1, H * dh),
            "wkv": tp.full(p["wkv"], 1, 2 * Hkv * dh),
            "wo": tp.full(p["wo"], 0, H * dh)}


def _whole(cfg: ArchConfig, p, tp: TensorParallel) -> dict:
    """The block's weights whole for this rank's block of a sequence
    split, each gradient a partial sum over the rank's queries
    (``TensorParallel.whole``; the norm's through ``local``)."""
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    norm = {n: tp.local(w) for n, w in p["norm"].named_parameters()}
    return {"norm": norm, "wq": tp.whole(p["wq"], 1, H * dh),
            "wkv": tp.whole(p["wkv"], 1, 2 * Hkv * dh),
            "wo": tp.whole(p["wo"], 0, H * dh)}


def _seq_split(cfg: ArchConfig, p, x: torch.Tensor, tp: TensorParallel,
               causal: bool, use_rope: bool,
               positions: Optional[torch.Tensor] = None,
               memory: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Attention with its queries split by sequence over the model group,
    for heads that do not divide it: rank r takes the stream's rows [r T/m,
    (r+1) T/m) (the sequence-sharded stream's own, or its slice of the
    replicated one), computes their q, k and v on weights gathered whole,
    all-gathers k and v along T (GQA's are G times smaller than q) and
    attends its queries over the keys [0, (r+1) T/m) (all of them where
    not ``causal``); the rows go back to the stream's layout.  With
    ``memory`` (cross-attention) k and v are the whole memory's, which
    every rank holds.  Returns (the residual delta in the stream's layout,
    (k, v) over the whole sequence)."""
    from repro_torch.distributed import collectives as col
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xl = x if tp.seq else col.split(x, 1, tp.group)
    B, Tl = xl.shape[:2]
    lo = tp.rank * Tl
    w = _whole(cfg, p, tp)
    h = apply_norm(cfg.norm, xl, w["norm"])
    q = dense(h, w["wq"]).reshape(B, Tl, H, dh)
    if memory is not None:
        src = tp.local(apply_norm(cfg.norm, memory, p["norm"]))
        kv = dense(src, w["wkv"]).reshape(B, -1, 2 * Hkv, dh)
    else:
        kv = dense(h, w["wkv"]).reshape(B, Tl, 2 * Hkv, dh)
        if use_rope:
            pos = lo + torch.arange(Tl, device=x.device) \
                if positions is None else positions[..., lo:lo + Tl]
            pos = torch.broadcast_to(pos, (B, Tl))
            q = apply_rope(q, pos, cfg.rope_theta)
            kv = torch.cat([apply_rope(kv[:, :, :Hkv], pos, cfg.rope_theta),
                            kv[:, :, Hkv:]], dim=2)
        kv = col.all_gather(kv, 1, tp.group)
    end = lo + Tl if causal else kv.shape[1]
    o = chunked_attention(q, kv[:, :end, :Hkv], kv[:, :end, Hkv:],
                          causal=causal, q_offset=lo)
    y = dense(o.reshape(B, Tl, -1), w["wo"])
    if not tp.seq:
        y = col.all_gather(y, 1, tp.group, replicated=True)
    return y, (kv[:, :, :Hkv], kv[:, :, Hkv:])


def attn_train(cfg: ArchConfig, p, x: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               causal: bool = True, use_rope: bool = True,
               tp: TensorParallel = NO_TP) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D) residual delta, both in the stream's
    layout under a mesh: heads split over the model group where they
    divide it, else queries split by sequence (``_seq_split``) where T
    divides it, else attention whole on every rank."""
    if tp.on and not tp.attn_sharded:
        T = x.shape[1] * (tp.size if tp.seq else 1)
        if tp.seq_split(T):
            return _seq_split(cfg, p, x, tp, causal, use_rope, positions)[0]
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
                     memory: torch.Tensor, tp: TensorParallel = NO_TP
                     ) -> torch.Tensor:
    """x: (B, T, D) attends over ``memory`` (B, Tenc, D), no mask, no
    RoPE; the block's norm is applied to both.  Under a mesh ``x`` is in
    the stream's layout and ``memory`` whole on every rank (the encoder's
    output, replicated): heads split where they divide the model group,
    else the queries split by sequence over it, else the block whole on
    every rank."""
    if tp.on and not tp.attn_sharded:
        T = x.shape[1] * (tp.size if tp.seq else 1)
        if tp.seq_split(T):
            return _seq_split(cfg, p, x, tp, False, False,
                              memory=memory)[0]
        return tp.from_replicated(cross_attn_train(
            cfg, _gathered(cfg, p, tp), tp.to_replicated(x), memory))
    q, k, v = _qkv(cfg, p, x, kv_src=memory, tp=tp)
    B, T = q.shape[:2]
    o = chunked_attention(q, k, v, causal=False)
    return tp.exit(dense(o.reshape(B, T, -1), p["wo"]))


def attn_prefill(cfg: ArchConfig, p, x: torch.Tensor, use_rope: bool = True,
                 tp: TensorParallel = NO_TP
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (residual delta, (k, v)) for the prompt; k/v (B, T, Hkv, dh)
    of this rank's KV heads, or of every head where they do not divide the
    model group (the caller keeps its block of the sequence:
    ``write_prompt_kv``)."""
    if tp.on and not tp.attn_sharded:
        T = x.shape[1] * (tp.size if tp.seq else 1)
        if tp.seq_split(T):
            return _seq_split(cfg, p, x, tp, True, use_rope)
        y, kv = attn_prefill(cfg, _gathered(cfg, p, tp), tp.to_replicated(x),
                             use_rope)
        return tp.from_replicated(y), kv
    B, T, D = x.shape
    q, k, v = _qkv(cfg, p, x, tp=tp)
    if use_rope:
        pos = torch.broadcast_to(torch.arange(T, device=x.device), (B, T))
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=True)
    return tp.exit(dense(o.reshape(B, T, -1), p["wo"])), (k, v)


def write_prompt_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, tp: TensorParallel,
                    seq_split: bool) -> None:
    """Store a prompt's k/v (B, T, Hkv, dh) in a rank's caches (B, S,
    Hkv, dh): positions [0, T) where the cache is whole along S, else the
    rank's block [r S, (r+1) S) of them (``seq_split``)."""
    lo = tp.rank * k_cache.shape[1] if seq_split else 0
    n = max(0, min(k.shape[1] - lo, k_cache.shape[1]))
    if n:
        k_cache[:, :n] = k[:, lo:lo + n]
        v_cache[:, :n] = v[:, lo:lo + n]


def _gather_cols(tp: TensorParallel, h: torch.Tensor, weights, widths
                 ) -> list:
    """``h @ w`` for each weight, gathered whole along its columns over the
    model group where the weight is split by column there: one
    all-gather of the products packed side by side (activations, a few
    rows, move in place of the weights)."""
    from repro_torch.distributed import collectives as col
    outs = [dense(h, w) for w in weights]
    split = [i for i, (o, n) in enumerate(zip(outs, widths))
             if o.shape[-1] != n]
    if split:
        packed = col.all_gather(torch.cat([outs[i] for i in split], -1)
                                .unsqueeze(-2), h.dim() - 1, tp.group,
                                replicated=True)
        lo = 0
        for i in split:
            n = outs[i].shape[-1]
            outs[i] = packed[..., lo:lo + n].flatten(-2)
            lo += n
    return outs


def seq_block_partial(q: torch.Tensor, k_block: torch.Tensor,
                      v_block: torch.Tensor, lengths: torch.Tensor,
                      rank: int):
    """Rank ``rank``'s share of one token's attention over a cache split
    by sequence into blocks of ``S = k_block.shape[1]`` positions: its
    block holds positions [rank S, (rank+1) S), so a row of ``lengths``
    valid positions has ``clamp(lengths - rank S, 0, S)`` of them here
    (0 where the block lies wholly past the row).  ``(o, m, l)`` of
    ``ops.gqa_decode_partial``, for a log-sum-exp merge over the blocks."""
    S = k_block.shape[1]
    return ops.gqa_decode_partial(q, k_block, v_block,
                                  torch.clamp(lengths - rank * S, 0, S))


def _decode_attend(cfg: ArchConfig, p, tp: TensorParallel, q: torch.Tensor,
                   k_cache: torch.Tensor, v_cache: torch.Tensor,
                   lengths: torch.Tensor, seq_split: bool) -> torch.Tensor:
    """One token's attention over a rank's caches and ``wo``, for heads
    that do not divide the model group: ``q`` (B, H, dh) of every head;
    the caches hold every head, over the rank's block of the sequence
    (``seq_split``: ``ops.gqa_decode_partial`` at the rows' local lengths
    ``clamp(lengths - r S, 0, S)``, merged by log-sum-exp over the group)
    or over all of it (``ops.gqa_decode``).  The output's row block of this
    rank goes through the row-parallel ``wo`` and the group sums it (a
    ``wo`` the placement keeps whole is applied whole)."""
    from repro_torch.distributed import collectives as col
    B, H, dh = q.shape
    if seq_split:
        o, m, l = seq_block_partial(q, k_cache, v_cache, lengths, tp.rank)
        o = col.merge_partials(o, m, l, tp.group).to(q.dtype)
    else:
        o = ops.gqa_decode(q, k_cache, v_cache, lengths)
    o = o.reshape(B, H * dh)
    wo = p["wo"]
    if wo.shape[0] == H * dh:
        return dense(o, wo)
    n = wo.shape[0]
    return tp.exit(dense(o[:, tp.rank * n:(tp.rank + 1) * n], wo))


def attn_decode(cfg: ArchConfig, p, x: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, length: torch.Tensor,
                use_rope: bool = True, tp: TensorParallel = NO_TP,
                seq_split: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token step.  x: (B, D); caches: (B, S, Hkv, dh); length: (B,).

    Writes the new K/V at position ``length`` of each row IN PLACE (the JAX
    version scatters into new caches) and returns (residual delta (B, D),
    k_cache, v_cache).  The new token attends over length+1 entries through
    ``ops.gqa_decode`` (the CUDA kernel on the card); under a mesh on this
    rank's heads and its (B, S, Hkv/m, dh) caches.  Where the KV heads do
    not divide the model group, the caches hold every head and the rank's
    block of the sequence (``seq_split``, as ``cache_shardings`` places
    them) or all of it: each rank computes its columns of q, k and v, the
    group gathers those few rows, the rank writes the new K/V where it
    holds position ``length`` and attends over its block
    (``_decode_attend``).
    """
    B, D = x.shape
    if tp.on and not tp.attn_sharded:
        H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        h = apply_norm(cfg.norm, x, p["norm"])
        q, kv = _gather_cols(tp, h, (p["wq"], p["wkv"]),
                             (H * dh, 2 * Hkv * dh))
        q, kv = q.reshape(B, 1, H, dh), kv.reshape(B, 1, 2 * Hkv, dh)
        k, v = kv[:, :, :Hkv], kv[:, :, Hkv:]
        if use_rope:
            q = apply_rope(q, length[:, None], cfg.rope_theta)
            k = apply_rope(k, length[:, None], cfg.rope_theta)
        S = k_cache.shape[1]
        pos = length.long() - (tp.rank * S if seq_split else 0)
        own = ((pos >= 0) & (pos < S))[:, None, None]
        at = torch.clamp(pos, 0, S - 1)
        rows = torch.arange(B, device=x.device)
        k_cache[rows, at] = torch.where(own, k[:, 0], k_cache[rows, at])
        v_cache[rows, at] = torch.where(own, v[:, 0], v_cache[rows, at])
        y = _decode_attend(cfg, p, tp, q[:, 0].contiguous(), k_cache,
                           v_cache, length + 1, seq_split)
        return y, k_cache, v_cache
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


def cross_attn_decode(cfg: ArchConfig, p, x: torch.Tensor,
                      ck: torch.Tensor, cv: torch.Tensor,
                      lengths: torch.Tensor, tp: TensorParallel = NO_TP,
                      seq_split: bool = False) -> torch.Tensor:
    """One token's cross-attention over the memory's cached K/V (B, Tenc,
    Hkv, dh) at ``lengths`` (every row's Tenc): the residual delta (B, D).
    Under a mesh on this rank's heads where they divide the model group,
    else through ``_decode_attend`` on the cache as ``cache_shardings``
    places it (its sequence block, ``seq_split``, or all of it)."""
    B = x.shape[0]
    h = apply_norm(cfg.norm, x, p["norm"])
    if tp.on and not tp.attn_sharded:
        H, dh = cfg.n_heads, cfg.head_dim
        q, = _gather_cols(tp, h, (p["wq"],), (H * dh,))
        return _decode_attend(cfg, p, tp, q.reshape(B, H, dh), ck, cv,
                              lengths, seq_split)
    (H, _), dh = tp.heads(cfg), cfg.head_dim
    q = dense(tp.enter(h), p["wq"]).reshape(B, H, dh)
    o = ops.gqa_decode(q, ck, cv, lengths)
    return tp.exit(dense(o.reshape(B, -1), p["wo"]))


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
