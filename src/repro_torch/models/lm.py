"""Decoder-only LM assembler for the dense family.

The port of ``repro.models.lm`` for ``family="dense"`` (and ``"vlm"``,
which ``prefill`` lists): the same parameter tree under the same leaf names
(``embed``, ``final_norm``, ``layers.<i>.mixer``/``ffn``, ``lm_head`` when
the head is untied), the same forward, prefill and decode.  Where the JAX
package stacks a leading layer axis and scans, the port keeps one
``ParamModule`` per layer in a ``ModuleList`` and loops.  The KV cache is
preallocated: ``{"layers": {"k", "v"}: (L, B, S, Hkv, dh), "length": (B,)
int32}`` on the model's device, which ``decode_step`` updates in place, so
a decode step makes no host sync.  Forward only: training (``loss``,
``chunked_ce_loss``) comes with ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig

from .blocks import (attn_decode, attn_prefill, attn_specs, attn_train,
                     dtype_of, mlp_apply, mlp_specs)
from .common import ParamModule, Spec, SpecTree, apply_norm, dense, norm_spec

#: families the port runs, and the ROADMAP item each other one waits for
FAMILIES = ("dense", "vlm")
NOT_PORTED = {
    "moe": "ROADMAP.md Queue 1 item 6b (MoE: moe_specs/moe_apply)",
    "ssm": "ROADMAP.md Queue 1 item 7 (SSM and hybrid, with linear_scan)",
    "hybrid": "ROADMAP.md Queue 1 item 7 (SSM and hybrid, with linear_scan)",
    "encdec": "ROADMAP.md Queue 1 item 8 (encoder-decoder)",
}


def check_family(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for a family
    the port does not run yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet: "
            f"{NOT_PORTED.get(cfg.family, 'ROADMAP.md Queue 1')}")


def flat_specs(tree: SpecTree, prefix: str = "") -> Iterator[Tuple[str, Spec]]:
    """(dotted name, spec) of every leaf, in the tree's order."""
    for name, spec in tree.items():
        if isinstance(spec, dict):
            yield from flat_specs(spec, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", spec


def top_specs(cfg: ArchConfig) -> SpecTree:
    """The parameters outside the layers: embedding, final norm, the head
    when it is not tied to the embedding."""
    dt = dtype_of(cfg)
    top = {"embed": ((cfg.vocab, cfg.d_model), dt),
           "final_norm": norm_spec(cfg.norm, cfg.d_model, dt)}
    if not cfg.tie_embeddings:
        top["lm_head"] = ((cfg.d_model, cfg.vocab), dt)
    return top


def layer_specs(cfg: ArchConfig) -> SpecTree:
    """One layer's parameters."""
    return {"mixer": attn_specs(cfg), "ffn": mlp_specs(cfg)}


def param_specs(cfg: ArchConfig) -> Dict[str, Spec]:
    """Every parameter's (shape, dtype) under the names ``LMModel.params``
    uses: ``embed``, ``final_norm.w``, ``layers.<i>.mixer.wq``, ..."""
    check_family(cfg)
    out = dict(flat_specs(top_specs(cfg)))
    layer = list(flat_specs(layer_specs(cfg)))
    for i in range(cfg.n_layers):
        out.update((f"layers.{i}.{n}", s) for n, s in layer)
    return out


class LMModel(nn.Module):
    """Uniform decoder-only stack with dense attention and MLP blocks."""

    def __init__(self, cfg: ArchConfig, device: str | torch.device = "cpu"):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.top = ParamModule(top_specs(cfg), device)
        self.layers = nn.ModuleList(ParamModule(layer_specs(cfg), device)
                                    for _ in range(cfg.n_layers))

    def params(self) -> Dict[str, torch.Tensor]:
        """The parameters by name (the JAX tree's paths, one entry a layer)."""
        out = dict(self.top.named_parameters())
        for i, layer in enumerate(self.layers):
            for n, p in layer.named_parameters():
                out[f"layers.{i}.{n}"] = p
        return out

    @property
    def device(self) -> torch.device:
        return self.top.embed.device

    @torch.no_grad()
    def init(self, generator: torch.Generator, scale: float = 0.02
             ) -> "LMModel":
        """N(0, 1) * ``scale`` on every parameter (the norm weights too, as
        the JAX init draws them), from ``generator`` on the model's device,
        in ``params()`` order."""
        for p in self.params().values():
            x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                            device=p.device)
            p.copy_(x.to(p.dtype) * scale)
        return self

    @torch.no_grad()
    def load_params(self, params: Dict[str, torch.Tensor]) -> "LMModel":
        """Copy ``params`` (as ``weights.to_torch_lm_params`` returns them)
        into the model; every name must be present with its shape."""
        own = self.params()
        if set(params) != set(own):
            missing = sorted(set(own) - set(params))[:5]
            extra = sorted(set(params) - set(own))[:5]
            raise ValueError(f"parameter names differ: missing {missing}, "
                             f"unexpected {extra}")
        for name, p in own.items():
            if tuple(params[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(params[name].shape)}"
                                 f" != {tuple(p.shape)}")
            p.copy_(params[name])
        return self

    # ---------------------------------------------------------------- forward
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.top.embed[tokens.long()]

    def hidden_states(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, T) -> final hidden (B, T, D)."""
        x = self._embed(tokens)
        for layer in self.layers:
            x = x + attn_train(self.cfg, layer["mixer"], x)
            x = x + mlp_apply(self.cfg, layer["ffn"], x)
        return apply_norm(self.cfg.norm, x, self.top.final_norm)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        head = self.top.embed.T if self.cfg.tie_embeddings \
            else self.top.lm_head
        return dense(hidden, head)

    # ---------------------------------------------------------------- serving
    def cache_specs(self, batch: int, max_seq: int) -> Dict[str, Spec]:
        """K/V ``(L, batch, max_seq, Hkv, dh)`` and ``length`` (batch,)."""
        cfg = self.cfg
        kv = ((cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim),
              dtype_of(cfg))
        return {"k": kv, "v": kv, "length": ((batch,), torch.int32)}

    def init_cache(self, batch: int, max_seq: int) -> Dict:
        z = {n: torch.zeros(shape, dtype=dt, device=self.device)
             for n, (shape, dt) in self.cache_specs(batch, max_seq).items()}
        return {"layers": {"k": z["k"], "v": z["v"]}, "length": z["length"]}

    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[Dict, torch.Tensor]:
        """tokens: (B,) -> (cache, logits (B, V)).  Updates ``cache`` in
        place (each layer's K/V at ``length``, then ``length + 1``) and
        returns it, where the JAX version returns a new cache."""
        cfg = self.cfg
        x = self._embed(tokens)
        length = cache["length"]
        ks, vs = cache["layers"]["k"], cache["layers"]["v"]
        for i, layer in enumerate(self.layers):
            delta, _, _ = attn_decode(cfg, layer["mixer"], x, ks[i], vs[i],
                                      length)
            x = x + delta
            # the ffn runs on a (B, 1, D) pseudo-sequence, as in JAX
            x = x + mlp_apply(cfg, layer["ffn"], x[:, None, :])[:, 0]
        x = apply_norm(cfg.norm, x, self.top.final_norm)
        logits = self.logits(x)
        length.add_(1)
        return cache, logits

    def prefill(self, tokens: torch.Tensor, max_seq: int
                ) -> Tuple[Dict, torch.Tensor]:
        """tokens: (B, T) -> (cache, last-position logits (B, V)).

        The attention caches hold the prompt's K/V in positions [0, T) and
        zeros after, and ``length`` is T."""
        cfg = self.cfg
        B, T = tokens.shape
        x = self._embed(tokens)
        cache = self.init_cache(B, max_seq)
        ks, vs = cache["layers"]["k"], cache["layers"]["v"]
        for i, layer in enumerate(self.layers):
            delta, (k, v) = attn_prefill(cfg, layer["mixer"], x)
            x = x + delta
            x = x + mlp_apply(cfg, layer["ffn"], x)
            ks[i, :, :T] = k
            vs[i, :, :T] = v
        x = apply_norm(cfg.norm, x, self.top.final_norm)
        logits = self.logits(x[:, -1])
        cache["length"].fill_(T)
        return cache, logits
