"""Zamba2-style hybrid: a Mamba2 backbone plus one SHARED attention block
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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .blocks import attn_decode, attn_train, dtype_of, mlp_apply
from .common import ParamModule, SpecTree, apply_norm, dense
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
    def _shared_train(self, x: torch.Tensor, x0: torch.Tensor
                      ) -> torch.Tensor:
        sp = self.shared
        h = dense(torch.cat([x, x0], dim=-1), sp["concat_proj"])
        h = h + attn_train(self.cfg, sp["attn"], h)
        h = h + mlp_apply(self.cfg, sp["ffn"], h)
        return h

    def _hybrid_layer(self, x: torch.Tensor, x0: torch.Tensor,
                      layer: ParamModule, with_attn: bool) -> torch.Tensor:
        x = x + mamba2_train(self.cfg, layer["mixer"], x)
        if with_attn:
            x = x + self._shared_train(x, x0)
        return x

    def hidden_states(self, tokens: torch.Tensor, remat: bool = True
                      ) -> torch.Tensor:
        """tokens: (B, T) -> final hidden (B, T, D); each backbone layer
        (with the shared block where it follows) under
        ``torch.utils.checkpoint`` where autograd records and ``remat``."""
        k = self.cfg.shared_attn_every
        x0 = self._embed(tokens)
        x = x0
        remat = remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            with_attn = (i + 1) % k == 0
            if remat:
                x = checkpoint(self._hybrid_layer, x, x0, layer, with_attn,
                               use_reentrant=False)
            else:
                x = self._hybrid_layer(x, x0, layer, with_attn)
        return apply_norm(self.cfg.norm, x, self.top.final_norm)

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
        x0 = self._embed(tokens)
        x = x0
        length = cache["length"]
        sp = self.shared
        for i, layer in enumerate(self.layers):
            x = x + self._mixer_decode(i, layer["mixer"], x, cache["layers"],
                                       length)
            if (i + 1) % k == 0:
                inv = i // k
                h = dense(torch.cat([x, x0], dim=-1), sp["concat_proj"])
                d, _, _ = attn_decode(cfg, sp["attn"], h, cache["attn_k"][inv],
                                      cache["attn_v"][inv], length)
                h = h + d
                h = h + mlp_apply(cfg, sp["ffn"], h[:, None])[:, 0]
                x = x + h
        x = apply_norm(cfg.norm, x, self.top.final_norm)
        logits = self.logits(x)
        length.add_(1)
        return cache, logits

    def prefill(self, tokens: torch.Tensor, max_seq: int
                ) -> Tuple[Dict, torch.Tensor]:
        """tokens: (B, T) -> (cache, last-position logits (B, V)).  Runs
        the chunked train path for the logits and leaves every state and
        K/V cache at zero with ``length = T``, exactly as the JAX version
        does (both engines scan the prompt in through ``decode_step``)."""
        B, T = tokens.shape
        hidden = self.hidden_states(tokens, remat=False)
        logits = self.logits(hidden[:, -1])
        cache = self.init_cache(B, max_seq)
        cache["length"].fill_(T)
        return cache, logits
