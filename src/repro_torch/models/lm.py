"""Decoder-only LM assembler for the dense, MoE, SSM (rwkv6, mamba2) and
hybrid families.

The port of ``repro.models.lm`` for ``family="dense"`` (and ``"vlm"``,
which ``prefill`` lists), ``family="moe"`` (the MLP a capacity-based top-k
expert block, ``blocks.moe_apply``) and ``family="ssm"`` with either mixer
(a config named ``rwkv*`` takes RWKV6, any other Mamba2): the same
parameter tree under the same leaf names (``embed``, ``final_norm``,
``layers.<i>.mixer``/``ffn``, ``lm_head`` when the head is untied), the
same forward, loss, prefill and decode.  ``family="hybrid"`` (zamba2) is
``HybridModel`` in ``hybrid.py`` and ``family="encdec"`` (whisper) is
``EncDecModel`` in ``encdec.py``, both built on this class.  Where the JAX
package stacks a leading layer axis and scans, the port keeps one
``ParamModule`` per layer in a ``ModuleList`` and loops; ``jax.checkpoint``
of a layer (``remat``) becomes ``torch.utils.checkpoint``.  Caches are
preallocated on the model's device and ``decode_step`` updates them in
place, so a decode step makes no host sync: ``{"layers": {"k", "v"}: (L, B,
S, Hkv, dh), "length": (B,) int32}`` for attention, ``{"layers":
{"x_prev": (L, B, D), "state": (L, B, H, hd, hd) f32}, "length"}`` for
rwkv6, ``{"layers": {"conv": (L, B, W-1, C), "ssm": (L, B, H, state, hd)
f32}, "length"}`` for mamba2.  Parameters are built without gradients
(serving); a trainer turns them on (``requires_grad_(True)``).

Under a mesh (``mesh``, set with the tensor-parallel context ``tp`` and
the layer-boundary ``hook`` by ``distributed.stepfn.place_model``, which
also swaps each parameter for its local shard) the dense, MoE and rwkv6
stacks run tensor-parallel: the embedding is vocab-parallel (a masked
lookup, then an all-reduce, or a reduce-scatter along T into a
sequence-sharded stream), the head is vocab-parallel (logits ``(...,
V/m)``) and the loss runs on the vocab-sharded logits; the MoE block is
expert-parallel (``distributed.moe_ep``) where ``ep_applicable``, else
each rank runs its experts and the combines are all-reduced; the
residual stream between blocks follows ``sharding.hidden_sharding``
(sequence-sharded in ``coswitch`` mode where T divides the model axis,
else replicated).  ``prefill`` and ``decode_step`` take this data rank's
rows, keep their caches in the local layout of ``cache_shardings`` (the
``length`` of the local rows) and return the local rows' logits over the
whole vocabulary.  With no mesh no collective is called.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from .blocks import (attn_decode, attn_prefill, attn_specs, attn_train,
                     dtype_of, mlp_apply, mlp_specs, moe_apply, moe_specs)
from .common import (NO_TP, ParamModule, Spec, SpecTree, TensorParallel,
                     apply_norm, dense, norm_spec)
from .ssm import (mamba2_cache_specs, mamba2_decode, mamba2_specs,
                  mamba2_train, rwkv6_cache_specs, rwkv6_decode, rwkv6_specs,
                  rwkv6_train)

#: the families of the model zoo, every one of which the port runs
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


def _is_rwkv(cfg: ArchConfig) -> bool:
    return cfg.family == "ssm" and cfg.name.startswith("rwkv")


def _is_mamba2(cfg: ArchConfig) -> bool:
    """The mixer of an ssm config not named ``rwkv*`` and of the hybrid
    backbone (``repro.models.lm``'s rule)."""
    return cfg.family == "hybrid" or (cfg.family == "ssm"
                                      and not _is_rwkv(cfg))


def check_family(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family outside ``FAMILIES``."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not one of {FAMILIES}")


def flat_specs(tree: SpecTree, prefix: str = "") -> Iterator[Tuple[str, Spec]]:
    """(dotted name, spec) of every leaf, in the tree's order."""
    for name, spec in tree.items():
        if isinstance(spec, dict):
            yield from flat_specs(spec, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", spec


def top_specs(cfg: ArchConfig) -> SpecTree:
    """The parameters outside the layers: embedding, final norm, the head
    when it is not tied to the embedding (a hybrid always has its own, as
    the JAX ``HybridModel`` does)."""
    dt = dtype_of(cfg)
    top = {"embed": ((cfg.vocab, cfg.d_model), dt),
           "final_norm": norm_spec(cfg.norm, cfg.d_model, dt)}
    if cfg.family == "hybrid" or not cfg.tie_embeddings:
        top["lm_head"] = ((cfg.d_model, cfg.vocab), dt)
    return top


def layer_specs(cfg: ArchConfig) -> SpecTree:
    """One layer's parameters: the mixer, and the MLP (an MoE block for
    the moe family; an SSM config without ``d_ff`` has none; a hybrid
    backbone layer has none)."""
    if cfg.family in ("ssm", "hybrid"):
        out = {"mixer": rwkv6_specs(cfg) if _is_rwkv(cfg)
               else mamba2_specs(cfg)}
        if cfg.family == "ssm" and cfg.d_ff:
            out["ffn"] = mlp_specs(cfg)
        return out
    return {"mixer": attn_specs(cfg),
            "ffn": moe_specs(cfg) if cfg.family == "moe" else mlp_specs(cfg)}


def shared_specs(cfg: ArchConfig) -> SpecTree:
    """The hybrid's one shared attention block: the ``2 D -> D`` projection
    of concat(x, x_embed0), attention and an MLP."""
    dt = dtype_of(cfg)
    return {"concat_proj": ((2 * cfg.d_model, cfg.d_model), dt),
            "attn": attn_specs(cfg), "ffn": mlp_specs(cfg)}


def param_specs(cfg: ArchConfig) -> Dict[str, Spec]:
    """Every parameter's (shape, dtype) under the names ``LMModel.params``
    uses: ``embed``, ``final_norm.w``, ``layers.<i>.mixer.wq``, ...; for a
    hybrid, ``shared.attn.wq`` and the rest of the shared block too; for
    an encoder-decoder, ``encdec.param_specs``' names."""
    check_family(cfg)
    if cfg.family == "encdec":
        from .encdec import param_specs as encdec_param_specs
        return encdec_param_specs(cfg)
    out = dict(flat_specs(top_specs(cfg)))
    layer = list(flat_specs(layer_specs(cfg)))
    for i in range(cfg.n_layers):
        out.update((f"layers.{i}.{n}", s) for n, s in layer)
    if cfg.family == "hybrid":
        out.update(flat_specs(shared_specs(cfg), "shared."))
    return out


class LMModel(nn.Module):
    """Uniform decoder-only stack: dense attention, RWKV6 or Mamba2
    mixers, MLPs."""

    #: the mesh, its tensor-parallel context and the layer-boundary layout
    #: (a function of T): set on the instance by ``stepfn.place_model``
    mesh = None
    tp: TensorParallel = NO_TP
    hook = None

    def __init__(self, cfg: ArchConfig, device: str | torch.device = "cuda"):
        super().__init__()
        check_family(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.top = ParamModule(top_specs(cfg), dev)
        self.layers = nn.ModuleList(ParamModule(layer_specs(cfg), dev)
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
    def _tp_for(self, T: int) -> TensorParallel:
        """The context of a call over T positions: the stream sequence-
        sharded where the hook says so (T = 1 in decode: never for a
        model axis above 1)."""
        if self.mesh is None:
            return NO_TP
        return self.tp.with_seq(self.hook(T)[1] == "model")

    def _vocab_sharded(self) -> bool:
        return self.tp.on and "embed" in self.tp.split

    def _embed(self, tokens: torch.Tensor, tp: TensorParallel = NO_TP
               ) -> torch.Tensor:
        """The embedding rows of ``tokens`` in ``tp``'s stream layout:
        vocab-parallel under a mesh (each rank looks up the tokens of its
        vocabulary block, zeros elsewhere, and the group sums)."""
        e = self.top.embed
        if not tp.on:
            return e[tokens.long()]
        if not self._vocab_sharded():
            return tp.from_replicated(e[tokens.long()])
        V = e.shape[0]
        t = tokens.long() - tp.rank * V
        mine = (t >= 0) & (t < V)
        x = e[t.clamp(0, V - 1)] * mine[..., None].to(e.dtype)
        return tp.exit(x)

    def _mixer_train(self, p, x: torch.Tensor, tp: TensorParallel = NO_TP
                     ) -> torch.Tensor:
        if _is_rwkv(self.cfg):
            return rwkv6_train(self.cfg, p, x, tp)
        if _is_mamba2(self.cfg):
            return mamba2_train(self.cfg, p, x)
        return attn_train(self.cfg, p, x, tp=tp)

    def _ffn(self, layer: ParamModule, x: torch.Tensor,
             tp: TensorParallel = NO_TP) -> torch.Tensor:
        """The layer's MLP (or MoE block) on (B, T, D); zeros where the
        layer has none.  Under a mesh an MoE block is expert-parallel where
        ``ep_applicable`` (on this rank's tokens: the sequence-sharded
        stream, or this rank's T block of the replicated one), else each
        rank runs its experts on the replicated stream
        (``moe_ep.moe_apply_tp``)."""
        if self.cfg.family == "moe":
            if not tp.on:
                return moe_apply(self.cfg, layer["ffn"], x)
            from repro_torch.distributed import moe_ep
            from repro_torch.distributed.sharding import data_size
            full = (x.shape[0] * data_size(self.mesh),
                    x.shape[1] * (tp.size if tp.seq else 1))
            if moe_ep.ep_applicable(self.cfg, self.mesh, full):
                return moe_ep.moe_apply_ep_stream(self.cfg, layer["ffn"], x,
                                                  self.mesh, tp)
            return tp.from_replicated(moe_ep.moe_apply_tp(
                self.cfg, layer["ffn"], tp.to_replicated(x), self.mesh))
        if hasattr(layer, "ffn"):
            return mlp_apply(self.cfg, layer["ffn"], x, tp)
        return torch.zeros_like(x)

    def _layer_train(self, x: torch.Tensor, layer: ParamModule,
                     tp: TensorParallel = NO_TP) -> torch.Tensor:
        x = x + self._mixer_train(layer["mixer"], x, tp)
        return x + self._ffn(layer, x, tp)

    def hidden_states(self, tokens: torch.Tensor, remat: bool = True
                      ) -> torch.Tensor:
        """tokens: (B, T) -> final hidden (B, T, D) (under a mesh in the
        stream's layout of a T-position call).

        ``remat``: where autograd records, each layer runs under
        ``torch.utils.checkpoint`` (its activations recomputed in the
        backward), as ``jax.checkpoint`` wraps the JAX layer scan."""
        tp = self._tp_for(tokens.shape[1])
        x = self._embed(tokens, tp)
        remat = remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(self._layer_train, x, layer, tp,
                               use_reentrant=False)
            else:
                x = self._layer_train(x, layer, tp)
        return tp.norm(self.cfg.norm, x, self.top.final_norm)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        head = self.top.embed.T if self.cfg.tie_embeddings \
            else self.top.lm_head
        return dense(hidden, head)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """batch: {"tokens": (B, T+1)} -> mean next-token cross-entropy
        (f32 scalar), through a sequence-chunked softmax (under a mesh
        over this data rank's rows, on vocab-sharded logits)."""
        tokens = batch["tokens"]
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
        hidden = self.hidden_states(inp)
        tp = self._tp_for(inp.shape[1])
        if not tp.on:
            return chunked_ce_loss(self, hidden, tgt)
        if self._vocab_sharded():
            return chunked_ce_loss(self, tp.enter(hidden), tgt, tp=tp)
        return chunked_ce_loss(self, tp.to_replicated(hidden), tgt)

    def _logits_out(self, x: torch.Tensor, tp: TensorParallel
                    ) -> torch.Tensor:
        """Serving logits over the whole vocabulary: under a mesh the
        vocab blocks of the group gathered."""
        if not self._vocab_sharded():
            return self.logits(x)
        from repro_torch.distributed import collectives as col
        return col.all_gather(self.logits(tp.enter(x)), x.dim() - 1,
                              tp.group, replicated=True)

    # ---------------------------------------------------------------- serving
    def cache_specs(self, batch: int, max_seq: int) -> SpecTree:
        """``layers``: the mixer caches with a leading layer axis
        (attention: K/V ``(L, batch, max_seq, Hkv, dh)``; rwkv6: ``x_prev
        (L, batch, D)``, ``state (L, batch, H, hd, hd)`` f32; mamba2:
        ``conv (L, batch, W-1, C)``, ``ssm (L, batch, H, state, hd)``
        f32); ``length`` (batch,)."""
        cfg = self.cfg
        if _is_rwkv(cfg):
            per_layer = rwkv6_cache_specs(cfg, batch)
        elif _is_mamba2(cfg):
            per_layer = mamba2_cache_specs(cfg, batch)
        else:
            kv = ((batch, max_seq, cfg.n_kv_heads, cfg.head_dim),
                  dtype_of(cfg))
            per_layer = {"k": kv, "v": kv}
        return {"layers": {n: ((cfg.n_layers,) + shape, dt)
                           for n, (shape, dt) in per_layer.items()},
                "length": ((batch,), torch.int32)}

    def init_cache(self, batch: int, max_seq: int) -> Dict:
        """Zeros on the model's device, nested as ``cache_specs``; under a
        mesh ``batch`` is this data rank's rows and every leaf has its
        local shape (``stepfn.local_cache_specs``)."""
        def zeros(tree: SpecTree) -> Dict:
            return {n: zeros(s) if isinstance(s, dict) else torch.zeros(
                s[0], dtype=s[1], device=self.device)
                for n, s in tree.items()}

        if self.mesh is None:
            return zeros(self.cache_specs(batch, max_seq))
        from repro_torch.distributed.stepfn import local_cache_specs
        return zeros(local_cache_specs(self, batch, max_seq))

    def _mixer_decode(self, i: int, p, x: torch.Tensor, caches: Dict,
                      length: torch.Tensor, tp: TensorParallel = NO_TP
                      ) -> torch.Tensor:
        """Layer ``i``'s mixer for one token; writes its cache in place."""
        if self.cfg.family in ("ssm", "hybrid"):
            layer_cache = {n: c[i] for n, c in caches.items()}
            if _is_rwkv(self.cfg):
                delta, new = rwkv6_decode(self.cfg, p, x, layer_cache, tp)
            else:
                delta, new = mamba2_decode(self.cfg, p, x, layer_cache)
            for n, c in caches.items():
                c[i].copy_(new[n])
            return delta
        delta, _, _ = attn_decode(self.cfg, p, x, caches["k"][i],
                                  caches["v"][i], length, tp=tp)
        return delta

    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[Dict, torch.Tensor]:
        """tokens: (B,) -> (cache, logits (B, V)).  Updates ``cache`` in
        place (each layer's K/V at ``length``, or its SSM states; then
        ``length + 1``) and returns it, where the JAX version returns a new
        cache."""
        cfg = self.cfg
        tp = self.tp.with_seq(False) if self.mesh is not None else NO_TP
        x = self._embed(tokens, tp)
        length = cache["length"]
        for i, layer in enumerate(self.layers):
            x = x + self._mixer_decode(i, layer["mixer"], x, cache["layers"],
                                       length, tp)
            # the ffn runs on a (B, 1, D) pseudo-sequence, as in JAX
            x = x + self._ffn(layer, x[:, None, :], tp)[:, 0]
        x = apply_norm(cfg.norm, x, self.top.final_norm)
        logits = self._logits_out(x, tp)
        length.add_(1)
        return cache, logits

    def prefill(self, tokens: torch.Tensor, max_seq: int
                ) -> Tuple[Dict, torch.Tensor]:
        """tokens: (B, T) -> (cache, last-position logits (B, V)).

        Attention caches hold the prompt's K/V in positions [0, T) and
        zeros after.  An SSM prefill runs the chunked train path for the
        logits and leaves the recurrent states at zero, exactly as the JAX
        version does (its serve engine scans the prompt in through
        ``decode_step`` instead).  ``length`` is T."""
        cfg = self.cfg
        B, T = tokens.shape
        tp = self.tp.with_seq(False) if self.mesh is not None else NO_TP
        x = self._embed(tokens, tp)
        cache = self.init_cache(B, max_seq)
        if cfg.family == "ssm":
            for layer in self.layers:
                x = self._layer_train(x, layer, tp)
        else:
            ks, vs = cache["layers"]["k"], cache["layers"]["v"]
            for i, layer in enumerate(self.layers):
                delta, (k, v) = attn_prefill(cfg, layer["mixer"], x, tp=tp)
                x = x + delta
                x = x + self._ffn(layer, x, tp)
                ks[i, :, :T] = k
                vs[i, :, :T] = v
        x = apply_norm(cfg.norm, x, self.top.final_norm)
        logits = self._logits_out(x[:, -1], tp)
        cache["length"].fill_(T)
        return cache, logits


class _CrossEntropy(torch.autograd.Function):
    """Per-position ``logsumexp(logits) - logits[target]`` over logits that
    may be split by vocabulary block over ``group`` (``lo`` this rank's
    first id): the max, the sum of exps and the target's logit are
    reduced over the group (Megatron's vocab-parallel cross-entropy).
    Without a group it is the one-device loss, in the same arithmetic:
    the backward is ``softmax - onehot``, ``softmax = exp(logits -
    lse)``, as ``torch.logsumexp``'s is."""

    @staticmethod
    def forward(ctx, logits, targets, group, lo):
        from repro_torch.distributed import collectives as col
        V = logits.shape[-1]
        mx = logits.amax(dim=-1)
        if group is not None:
            mx = col.all_reduce_max(mx, group)
        se = torch.sum(torch.exp(logits - mx[..., None]), dim=-1)
        t = targets.long() - lo
        mine = (t >= 0) & (t < V)
        tc = t.clamp(0, V - 1)
        picked = torch.gather(logits, -1, tc[..., None])[..., 0] * mine
        if group is not None:
            se = col._all_reduce(se, group)
            picked = col._all_reduce(picked, group)
        lse = mx + torch.log(se)
        ctx.save_for_backward(logits, lse, tc, mine)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, lse, tc, mine = ctx.saved_tensors
        grad = torch.exp(logits - lse[..., None])
        grad.scatter_add_(-1, tc[..., None],
                          -mine[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None


def _ce_chunk(model: LMModel, h: torch.Tensor, t: torch.Tensor,
              tp: TensorParallel = NO_TP) -> torch.Tensor:
    logits = model.logits(h).float()
    group = tp.group if tp.on else None
    lo = tp.rank * logits.shape[-1] if tp.on else 0
    return torch.sum(_CrossEntropy.apply(logits, t, group, lo))


def chunked_ce_loss(model: LMModel, hidden: torch.Tensor,
                    targets: torch.Tensor, chunk: int = 512,
                    tp: TensorParallel = NO_TP) -> torch.Tensor:
    """Cross-entropy without materialising the full (B, T, V) logits: the
    sequence in chunks of ``chunk`` positions, each under
    ``torch.utils.checkpoint`` where autograd records (the backward
    recomputes a chunk's logits — flash-CE), summed in order.  With a
    ``tp`` context the logits are this rank's vocabulary block of
    ``hidden`` (which every rank holds whole)."""
    B, T, D = hidden.shape
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the "
                         f"loss chunk {chunk}")
    total = hidden.new_zeros((), dtype=torch.float32)
    for lo in range(0, T, chunk):
        h, t = hidden[:, lo:lo + chunk], targets[:, lo:lo + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_ce_chunk, model, h, t, tp,
                                       use_reentrant=False)
        else:
            total = total + _ce_chunk(model, h, t, tp)
    return total / (B * T)
