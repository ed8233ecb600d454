"""The hybrids: zamba2 (``HybridModel``) and granite-4.0-h (``HybridMoEModel``).

Zamba2-style hybrid: a Mamba2 backbone plus one SHARED attention block
invoked every ``shared_attn_every`` backbone layers (its parameters reused,
Zamba2's global shared transformer block).  The shared block consumes
concat(x, x_embed0) through a down-projection, per the Zamba design.

The port of ``repro.models.hybrid``.  The shared block (``concat_proj``,
``attn``, ``ffn``) is one ``ParamModule``, ``shared``, reused at every
k-th layer; where the JAX scan takes ``lax.cond((i + 1) % k == 0, ...)``,
the port's layer loop takes a Python ``if``.  The cache holds the backbone
states with a leading layer axis and one K/V cache per invocation of the
shared block, ``attn_k``/``attn_v`` of ``(n_invocations, B, S, Hkv, dh)``;
``decode_step`` writes invocation ``i // k``'s in place.

Under a mesh (``distributed.stepfn.place_model``) the backbone's Mamba2
mixers are tensor-parallel over SSM heads (``ssm.mamba2_train``), the
embedding and the carried ``x0`` are in the stream's layout, and the
shared block runs on the model group: ``concat_proj`` column-parallel
(``repro``'s ``P(None, "model")``) on concat(x, x0), its output columns
all-gathered and handed to the stream's layout (``_concat_proj``);
attention and the MLP with the dense rules (heads, or the sequence where
the heads do not divide the group), each invocation's
``attn_k``/``attn_v`` as ``cache_shardings`` places them.

Granite-4.0-H (``family="hybrid_moe"``): each layer is a mixer then an
MoE block, the mixer GQA attention with NoPE at the layers ``i`` with
``i % attn_period == attn_offset`` and Mamba2 at the rest, each with its
own parameters (no block is shared).  The MoE block is the dropless
held-expert block (``blocks.moe_apply_held``): the router routes over all
``n_experts``, this device runs the ``experts_held`` it holds and the
shared expert.  The embedding's rows are multiplied by
``embedding_multiplier``, each residual branch by ``residual_multiplier``
and the scores by ``attention_multiplier``; the logits of the tied head
are divided by ``logits_scaling``.  It trains on one device: no mesh,
prefill or decode.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .blocks import (attn_decode, attn_train, dtype_of, mlp_apply,
                     moe_apply_held)
from .common import (NO_TP, ParamModule, SpecTree, TensorParallel,
                     apply_norm, dense)
from .lm import LMModel, shared_specs
from .ssm import mamba2_train


class HybridModel(LMModel):
    """cfg.family == "hybrid" (zamba2)."""

    def __init__(self, cfg, device: str | torch.device = "cuda"):
        super().__init__(cfg, device=device)
        self.shared = ParamModule(shared_specs(cfg), self.device)

    @property
    def n_invocations(self) -> int:
        k = self.cfg.shared_attn_every
        return (self.cfg.n_layers + k - 1) // k

    def params(self) -> Dict[str, torch.Tensor]:
        out = super().params()
        out.update((f"shared.{n}", p)
                   for n, p in self.shared.named_parameters())
        return out

    # ---------------------------------------------------------------- forward
    def _concat_proj(self, x: torch.Tensor, x0: torch.Tensor,
                     tp: TensorParallel = NO_TP) -> torch.Tensor:
        """``concat(x, x0) @ concat_proj`` in the stream's layout.  Under a
        mesh the weight's columns are split over the model group: the
        product reads the stream as a column-parallel one does
        (``tp.enter``), its (..., D/m) output columns are all-gathered
        (the backward keeps each rank's own columns of the gradient) and
        the whole result goes to the stream's layout."""
        w = self.shared["concat_proj"]
        if not tp.on:
            return dense(torch.cat([x, x0], dim=-1), w)
        from repro_torch.distributed import collectives as col
        h = dense(tp.enter(torch.cat([x, x0], dim=-1)), w)
        h = col.all_gather(h, h.dim() - 1, tp.group, replicated=True)
        return tp.from_replicated(h)

    def _shared_train(self, x: torch.Tensor, x0: torch.Tensor,
                      tp: TensorParallel = NO_TP) -> torch.Tensor:
        sp = self.shared
        h = self._concat_proj(x, x0, tp)
        h = h + attn_train(self.cfg, sp["attn"], h, tp=tp)
        h = h + mlp_apply(self.cfg, sp["ffn"], h, tp)
        return h

    def _hybrid_layer(self, x: torch.Tensor, x0: torch.Tensor,
                      layer: ParamModule, with_attn: bool,
                      tp: TensorParallel = NO_TP) -> torch.Tensor:
        x = x + mamba2_train(self.cfg, layer["mixer"], x, tp)
        if with_attn:
            x = x + self._shared_train(x, x0, tp)
        return x

    def hidden_states(self, tokens: torch.Tensor, remat: bool = True
                      ) -> torch.Tensor:
        """tokens: (B, T) -> final hidden (B, T, D) (under a mesh in the
        stream's layout of a T-position call); each backbone layer (with
        the shared block where it follows) under
        ``torch.utils.checkpoint`` where autograd records and ``remat``.
        Whether a layer runs the shared block depends on its index alone,
        so every rank runs (and the recompute replays) the same
        collectives."""
        k = self.cfg.shared_attn_every
        tp = self._tp_for(tokens.shape[1])
        x0 = self._embed(tokens, tp)
        x = x0
        remat = remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            with_attn = (i + 1) % k == 0
            if remat:
                x = checkpoint(self._hybrid_layer, x, x0, layer, with_attn,
                               tp, use_reentrant=False)
            else:
                x = self._hybrid_layer(x, x0, layer, with_attn, tp)
        return tp.norm(self.cfg.norm, x, self._top("final_norm"))

    # ---------------------------------------------------------------- serving
    def cache_specs(self, batch: int, max_seq: int) -> SpecTree:
        """``layers``: the Mamba2 states with a leading layer axis;
        ``attn_k``/``attn_v``: ``(n_invocations, batch, max_seq, Hkv,
        dh)``; ``length`` (batch,)."""
        cfg = self.cfg
        kv = ((self.n_invocations, batch, max_seq, cfg.n_kv_heads,
               cfg.head_dim), dtype_of(cfg))
        return dict(super().cache_specs(batch, max_seq), attn_k=kv,
                    attn_v=kv)

    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[Dict, torch.Tensor]:
        """tokens: (B,) -> (cache, logits (B, V)).  Updates ``cache`` in
        place (every layer's conv window and SSM state, the K/V of each
        shared-block invocation at ``length``, then ``length + 1``) and
        returns it, where the JAX version returns a new cache."""
        cfg = self.cfg
        k = cfg.shared_attn_every
        tp = self.tp.with_seq(False) if self.mesh is not None else NO_TP
        x0 = self._embed(tokens, tp)
        x = x0
        length = self._rows(cache["length"])
        sp = self.shared
        split = self.kv_split.get("attn_k", False)
        for i, layer in enumerate(self.layers):
            x = x + self._mixer_decode(i, layer["mixer"], x, cache["layers"],
                                       length, tp)
            if (i + 1) % k == 0:
                inv = i // k
                h = self._concat_proj(x, x0, tp)
                d, _, _ = attn_decode(cfg, sp["attn"], h, cache["attn_k"][inv],
                                      cache["attn_v"][inv], length, tp=tp,
                                      seq_split=split)
                h = h + d
                h = h + mlp_apply(cfg, sp["ffn"], h[:, None], tp)[:, 0]
                x = x + h
        x = tp.norm(cfg.norm, x, self._top("final_norm"))
        logits = self._logits_out(x, tp)
        cache["length"].add_(1)
        return cache, logits

    def prefill(self, tokens: torch.Tensor, max_seq: int
                ) -> Tuple[Dict, torch.Tensor]:
        """tokens: (B, T) -> (cache, last-position logits (B, V)).  Runs
        the chunked train path for the logits and leaves every state and
        K/V cache at zero with ``length = T``, exactly as the JAX version
        does (both engines scan the prompt in through ``decode_step``).
        Under a mesh ``tokens`` are this data rank's rows, the cache is in
        its local layout and the logits are over the whole vocabulary."""
        B, T = tokens.shape
        hidden = self.hidden_states(tokens, remat=False)
        if self.mesh is None:
            logits = self.logits(hidden[:, -1])
        else:
            last = self._tp_for(T).to_replicated(hidden)[:, -1]
            logits = self._logits_out(last, self.tp.with_seq(False))
        cache = self.init_cache(B, max_seq)
        cache["length"].fill_(T)
        return cache, logits


class HybridMoEModel(LMModel):
    """cfg.family == "hybrid_moe" (granite-4.0-h), trained on one device."""

    def _hybrid_moe_layer(self, x: torch.Tensor, layer: ParamModule,
                          i: int) -> torch.Tensor:
        """Layer ``i``: its mixer, then the MoE block, each branch scaled by
        ``residual_multiplier`` into the stream."""
        cfg = self.cfg
        if cfg.is_attention(i):
            mixed = attn_train(cfg, layer["mixer"], x, use_rope=not cfg.nope)
        else:
            mixed = mamba2_train(cfg, layer["mixer"], x)
        x = x + mixed * cfg.residual_multiplier
        return x + moe_apply_held(cfg, layer["ffn"], x) \
            * cfg.residual_multiplier

    def hidden_states(self, tokens: torch.Tensor, remat: bool = True
                      ) -> torch.Tensor:
        """tokens: (B, T) -> final hidden (B, T, D); each layer under
        ``torch.utils.checkpoint`` where autograd records and ``remat``."""
        if self.mesh is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: the hybrid_moe family runs on one device;"
                f" its expert exchange over a mesh is not ported")
        x = self._embed(tokens) * self.cfg.embedding_multiplier
        remat = remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x = checkpoint(self._hybrid_moe_layer, x, layer, i,
                               use_reentrant=False)
            else:
                x = self._hybrid_moe_layer(x, layer, i)
        return apply_norm(self.cfg.norm, x, self._top("final_norm"))

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return super().logits(hidden) / self.cfg.logits_scaling

    def _no_serving(self, *args, **kwargs):
        raise NotImplementedError(
            f"{self.cfg.name}: prefill and decode of the hybrid_moe family "
            f"are not ported; it trains only")

    cache_specs = init_cache = decode_step = prefill = _no_serving
