"""Whisper-style encoder-decoder backbone (the audio frontend is a STUB:
the encoder takes precomputed frame embeddings).

The port of ``repro.models.encdec``: the same parameter tree under the
same leaf names (``embed``, ``pos_embed`` (32768, D), ``enc_pos``
(``enc_frames``, D), ``enc_layers.<i>.{attn,ffn}``, ``enc_norm``,
``dec_layers.<i>.{self,cross,ffn}``, ``final_norm``; the head is tied to
the embedding), the same encoder (non-causal, no RoPE), decoder, loss,
prefill and decode.  As in ``lm.py``, each layer is one ``ParamModule``
in a ``ModuleList`` and the layer loops replace the JAX scans;
``jax.checkpoint`` of a layer becomes ``torch.utils.checkpoint``.  The
cache is preallocated on the model's device, ``{"layers": {"k", "v": (L,
B, S, Hkv, dh), "ck", "cv": (L, B, enc_frames, Hkv, dh)}, "length": (B,)
int32}``: ``prefill`` writes the prompt's self-attention K/V and the
cross-attention K/V of the encoder's memory once, and ``decode_step``
writes each layer's new self-attention K/V in place.  Both attentions of
a decode step go through ``ops.gqa_decode``, the cross one over all
``enc_frames`` positions of every row.

Under a mesh (``stepfn.place_model``) both stacks take the dense family's
tensor parallelism (``blocks``): the encoder's self-attention and MLP, the
decoder's self- and cross-attention and MLP, the vocab-parallel embedding
and tied head.  The encoder's output, the memory, is whole on every rank
of the model group.  Where the heads do not divide the model axis the
attentions split their queries by sequence, and in decode the self cache
is split by sequence over the group (``blocks.attn_decode``); the cross
cache is split so too where ``enc_frames`` divides the axis, and where it
does not (1500 frames on 16 ranks) ``cache_shardings`` keeps it whole on
every rank, as ``repro``'s ``_guard`` does, and every rank attends over
all of it (``blocks.cross_attn_decode``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from .blocks import (attn_decode, attn_prefill, attn_specs, attn_train,
                     cross_attn_decode, cross_attn_train, dtype_of,
                     mlp_apply, mlp_specs, write_prompt_kv)
from .common import (NO_TP, ParamModule, Spec, SpecTree, TensorParallel,
                     apply_norm, dense, norm_spec)
from .lm import LMModel, check_family, flat_specs

#: rows of the decoder's learned position table (``repro``'s constant)
MAX_POSITIONS = 32768


def top_specs(cfg: ArchConfig) -> SpecTree:
    """The parameters outside the two layer stacks."""
    dt = dtype_of(cfg)
    return {"embed": ((cfg.vocab, cfg.d_model), dt),
            "pos_embed": ((MAX_POSITIONS, cfg.d_model), dt),
            "enc_pos": ((cfg.enc_frames, cfg.d_model), dt),
            "enc_norm": norm_spec(cfg.norm, cfg.d_model, dt),
            "final_norm": norm_spec(cfg.norm, cfg.d_model, dt)}


def enc_layer_specs(cfg: ArchConfig) -> SpecTree:
    return {"attn": attn_specs(cfg), "ffn": mlp_specs(cfg)}


def dec_layer_specs(cfg: ArchConfig) -> SpecTree:
    return {"self": attn_specs(cfg), "cross": attn_specs(cfg, cross=True),
            "ffn": mlp_specs(cfg)}


def param_specs(cfg: ArchConfig) -> Dict[str, Spec]:
    """Every parameter's (shape, dtype) under the names
    ``EncDecModel.params`` uses: ``embed``, ``enc_pos``,
    ``enc_layers.<i>.attn.wq``, ``dec_layers.<i>.cross.wkv``, ..."""
    out = dict(flat_specs(top_specs(cfg)))
    for stack, n, layer in (("enc_layers", cfg.enc_layers,
                             enc_layer_specs(cfg)),
                            ("dec_layers", cfg.n_layers,
                             dec_layer_specs(cfg))):
        leaves = list(flat_specs(layer))
        for i in range(n):
            out.update((f"{stack}.{i}.{name}", s) for name, s in leaves)
    return out


class EncDecModel(LMModel):
    """cfg.family == "encdec" (whisper-small)."""

    def __init__(self, cfg: ArchConfig, device: str | torch.device = "cuda"):
        # the two layer stacks replace LMModel's one, so LMModel's
        # constructor is not run
        nn.Module.__init__(self)
        check_family(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.top = ParamModule(top_specs(cfg), dev)
        self.enc_layers = nn.ModuleList(
            ParamModule(enc_layer_specs(cfg), dev)
            for _ in range(cfg.enc_layers))
        self.dec_layers = nn.ModuleList(
            ParamModule(dec_layer_specs(cfg), dev)
            for _ in range(cfg.n_layers))

    def params(self) -> Dict[str, torch.Tensor]:
        out = dict(self.top.named_parameters())
        for stack in ("enc_layers", "dec_layers"):
            for i, layer in enumerate(getattr(self, stack)):
                for n, p in layer.named_parameters():
                    out[f"{stack}.{i}.{n}"] = p
        return out

    # ---------------------------------------------------------------- forward
    def _enc_layer(self, x: torch.Tensor, layer: ParamModule,
                   tp: TensorParallel = NO_TP) -> torch.Tensor:
        x = x + attn_train(self.cfg, layer["attn"], x, causal=False,
                           use_rope=False, tp=tp)
        return x + mlp_apply(self.cfg, layer["ffn"], x, tp)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, Tenc, D) stub embeddings -> encoder memory; each
        layer under ``torch.utils.checkpoint`` where autograd records (the
        JAX encoder scan is always checkpointed).  Frames are cast to the
        model's dtype (``repro`` adds f32 frames to bf16 positions and
        runs a bf16 model's encoder in f32).  Under a mesh the stream
        between the layers follows the layout hook at Tenc, and the memory
        comes out whole on every rank."""
        tp = self._tp_for(frames.shape[1])
        x = frames.to(self.top.enc_pos.dtype) \
            + self.top.enc_pos[None, :frames.shape[1]]
        x = tp.from_replicated(x)
        for layer in self.enc_layers:
            if torch.is_grad_enabled():
                x = checkpoint(self._enc_layer, x, layer, tp,
                               use_reentrant=False)
            else:
                x = self._enc_layer(x, layer, tp)
        return tp.to_replicated(tp.norm(self.cfg.norm, x, self.top.enc_norm))

    def _dec_embed(self, tokens: torch.Tensor, tp: TensorParallel = NO_TP
                   ) -> torch.Tensor:
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        return self._embed(tokens, tp) \
            + self._lookup("pos_embed", pos.expand(tokens.shape), tp)

    def _dec_layer(self, x: torch.Tensor, memory: torch.Tensor,
                   layer: ParamModule, tp: TensorParallel = NO_TP
                   ) -> torch.Tensor:
        x = x + attn_train(self.cfg, layer["self"], x, use_rope=False, tp=tp)
        x = x + cross_attn_train(self.cfg, layer["cross"], x, memory, tp)
        return x + mlp_apply(self.cfg, layer["ffn"], x, tp)

    def _decoder_hidden(self, tokens: torch.Tensor, memory: torch.Tensor,
                        remat: bool = True) -> torch.Tensor:
        """tokens: (B, T) over ``memory`` -> final hidden (B, T, D) (under a
        mesh in the stream's layout of a T-position call)."""
        tp = self._tp_for(tokens.shape[1])
        x = self._dec_embed(tokens, tp)
        remat = remat and torch.is_grad_enabled()
        for layer in self.dec_layers:
            if remat:
                x = checkpoint(self._dec_layer, x, memory, layer, tp,
                               use_reentrant=False)
            else:
                x = self._dec_layer(x, memory, layer, tp)
        return tp.norm(self.cfg.norm, x, self.top.final_norm)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return dense(hidden, self.top.embed.T)     # whisper ties its head

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """batch: {"frames": (B, Tenc, D), "tokens": (B, T+1)} -> mean
        next-token cross-entropy (f32 scalar)."""
        tokens = batch["tokens"]
        memory = self.encode(batch["frames"])
        hidden = self._decoder_hidden(tokens[:, :-1], memory)
        return self._hidden_loss(hidden, tokens[:, 1:])

    # ---------------------------------------------------------------- serving
    def cache_specs(self, batch: int, max_seq: int) -> SpecTree:
        """``layers``: self-attention K/V ``(L, batch, max_seq, Hkv, dh)``
        and cross-attention K/V ``(L, batch, enc_frames, Hkv, dh)``;
        ``length`` (batch,)."""
        cfg, dt = self.cfg, dtype_of(self.cfg)
        L, Hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        self_kv = ((L, batch, max_seq, Hkv, dh), dt)
        cross_kv = ((L, batch, cfg.enc_frames, Hkv, dh), dt)
        return {"layers": {"k": self_kv, "v": self_kv,
                           "ck": cross_kv, "cv": cross_kv},
                "length": ((batch,), torch.int32)}

    def prefill(self, tokens: torch.Tensor, max_seq: int,
                frames: Optional[torch.Tensor] = None
                ) -> Tuple[Dict, torch.Tensor]:
        """tokens: (B, T) -> (cache, last-position logits (B, V)).  Without
        ``frames`` the encoder takes zero frames (the stub frontend, as in
        ``repro``).  The cross-attention K/V are computed once from the
        memory through each cross block's own norm, as ``repro`` does."""
        cfg = self.cfg
        B, T = tokens.shape
        if frames is None:
            frames = torch.zeros((B, cfg.enc_frames, cfg.d_model),
                                 dtype=dtype_of(cfg), device=self.device)
        tp = self.tp.with_seq(False) if self.mesh is not None else NO_TP
        memory = self.encode(frames)
        x = self._dec_embed(tokens, tp)
        cache = self.init_cache(B, max_seq)
        lc = cache["layers"]
        split = self.kv_split
        for i, layer in enumerate(self.dec_layers):
            delta, (k, v) = attn_prefill(cfg, layer["self"], x,
                                         use_rope=False, tp=tp)
            x = x + delta
            x = x + cross_attn_train(cfg, layer["cross"], x, memory, tp)
            x = x + mlp_apply(cfg, layer["ffn"], x, tp)
            write_prompt_kv(lc["k"][i], lc["v"][i], k, v, tp,
                            split.get("k", False))
            ck, cv = self._cross_kv(layer["cross"], memory, tp)
            write_prompt_kv(lc["ck"][i], lc["cv"][i], ck, cv, tp,
                            split.get("ck", False))
        x = apply_norm(cfg.norm, x, self.top.final_norm)
        cache["length"].fill_(T)
        return cache, self._logits_out(x[:, -1], tp)

    def _cross_kv(self, p, memory: torch.Tensor, tp: TensorParallel
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cross block's K/V of the memory (B, Tenc, Hkv, dh): this
        rank's KV heads, or every head (on ``wkv`` gathered whole) where
        the heads do not divide the model axis."""
        cfg = self.cfg
        Hkv, dh = cfg.n_kv_heads, cfg.head_dim
        wkv = p["wkv"]
        if tp.on and not tp.attn_sharded:
            wkv = tp.full(wkv, 1, 2 * Hkv * dh)
        h = apply_norm(cfg.norm, memory, p["norm"])
        ckv = dense(h, wkv).reshape(*memory.shape[:2], -1, dh)
        n = ckv.shape[2] // 2
        return ckv[..., :n, :], ckv[..., n:, :]

    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[Dict, torch.Tensor]:
        """tokens: (B,) -> (cache, logits (B, V)).  Updates ``cache`` in
        place (each layer's self-attention K/V at ``length``, then
        ``length + 1``) and returns it.  Two ``gqa_decode`` launches a
        layer: self-attention over ``length + 1`` positions, and
        cross-attention over the ``enc_frames`` positions of the memory."""
        cfg = self.cfg
        B = tokens.shape[0]
        tp = self.tp.with_seq(False) if self.mesh is not None else NO_TP
        length = self._rows(cache["length"])
        lc = cache["layers"]
        split = self.kv_split
        pos = torch.clamp(length, 0, MAX_POSITIONS - 1).long()
        x = self._embed(tokens, tp) + self._lookup("pos_embed", pos, tp)
        enc_len = torch.full((B,), cfg.enc_frames, dtype=torch.int32,
                             device=x.device)
        for i, layer in enumerate(self.dec_layers):
            delta, _, _ = attn_decode(cfg, layer["self"], x, lc["k"][i],
                                      lc["v"][i], length, use_rope=False,
                                      tp=tp, seq_split=split.get("k", False))
            x = x + delta
            x = x + cross_attn_decode(cfg, layer["cross"], x, lc["ck"][i],
                                      lc["cv"][i], enc_len, tp,
                                      split.get("ck", False))
            x = x + mlp_apply(cfg, layer["ffn"], x[:, None], tp)[:, 0]
        x = apply_norm(cfg.norm, x, self.top.final_norm)
        logits = self._logits_out(x, tp)
        cache["length"].add_(1)
        return cache, logits
