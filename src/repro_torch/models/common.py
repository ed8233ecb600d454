"""Shared model components: norms, RoPE, activations, chunked attention.

The port of ``repro.models.common``.  Layouts and arithmetic follow the JAX
package: norms compute in f32 and cast to the input's type before the
weight multiplies, RoPE rotates split halves with f32 positions,
``chunked_attention`` runs the same chunked online softmax with the same
finite mask.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e30

#: a parameter's (shape, dtype): the leaf of a spec tree, as
#: ``jax.ShapeDtypeStruct`` is in the JAX package
Spec = Tuple[Tuple[int, ...], torch.dtype]
SpecTree = Dict[str, Union[Spec, "SpecTree"]]


class ParamModule(nn.Module):
    """A module built from a spec tree: each leaf a parameter, each nested
    dict a sub-module, under the JAX leaf names, and read as ``p["name"]``
    as well as ``p.name`` so that block code reads like the JAX code.
    Parameters are built as inference weights (``requires_grad=False``),
    so serving records no autograd graph; a trainer turns gradients on
    (``module.requires_grad_(True)``)."""

    def __init__(self, specs: SpecTree, device: str | torch.device):
        super().__init__()
        for name, spec in specs.items():
            if isinstance(spec, dict):
                self.add_module(name, ParamModule(spec, device))
            else:
                shape, dtype = spec
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape, dtype=dtype, device=device),
                    requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def apply_norm(kind: str, x: torch.Tensor, params) -> torch.Tensor:
    """``params``: a mapping or ``ParamModule`` with ``w`` (and ``b``)."""
    if kind == "rmsnorm":
        return rmsnorm(x, params["w"])
    return layernorm(x, params["w"], params["b"])


def norm_spec(kind: str, d: int, dtype: torch.dtype) -> SpecTree:
    if kind == "rmsnorm":
        return {"w": ((d,), dtype)}
    return {"w": ((d,), dtype), "b": ((d,), dtype)}


def activation(kind: str, x: torch.Tensor,
               gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    if kind == "swiglu":
        assert gate is not None
        return F.silu(gate) * x
    if kind == "relu2":
        r = torch.relu(x)
        return r * r
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


# ------------------------------------------------------------------------ RoPE
def rope_freqs(head_dim: int, theta: float,
               device: str | torch.device = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., T, H, dh); positions: broadcastable to (..., T)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    ang = positions[..., :, None, None].float() * freqs      # (..., T, 1, dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------- chunked causal attention
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      chunk: int = 1024, causal: bool = True,
                      q_offset: Optional[int] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Memory-efficient (flash-style) attention in plain torch.

    q: (B, Tq, H, dh); k/v: (B, Tk, Hkv, dh) with H = G * Hkv.  The
    queries in blocks of ``chunk``, each over the KV chunks with an online
    softmax: peak memory O(chunk^2) instead of O(Tq * Tk).  The queries sit
    at positions ``q_offset`` .. ``q_offset + Tq - 1`` of the keys' (the
    last Tq by default; a rank's block of a sequence split passes its
    first position).  The scores are scaled by ``scale`` (1/sqrt(dh) by
    default).  Under ``causal`` a query block skips the KV chunks
    that lie wholly past its last query: such a chunk would add ``exp(NEG_INF
    - m) = 0`` to every sum, so the skip changes no bit.
    """
    B, Tq, H, dh = q.shape
    _, Tk, Hkv, _ = k.shape
    G = H // Hkv
    scale = 1.0 / (dh ** 0.5) if scale is None else scale
    q0 = Tk - Tq if q_offset is None else q_offset
    chunk = min(chunk, Tk)
    while Tk % chunk:   # largest chunk <= requested that tiles Tk
        chunk -= 1
    n_chunks = Tk // chunk
    qc = min(chunk, Tq)
    while Tq % qc:
        qc -= 1

    qf = q.float().reshape(B, Tq, Hkv, G, dh)
    kf = k.float().reshape(B, n_chunks, chunk, Hkv, dh)
    vf = v.float().reshape(B, n_chunks, chunk, Hkv, dh)
    outs = []
    for lo in range(0, Tq, qc):
        q_pos = q0 + lo + torch.arange(qc, device=q.device)
        n_kv = min(n_chunks, (q0 + lo + qc - 1) // chunk + 1) if causal \
            else n_chunks
        m = torch.full((B, Hkv, G, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, qc), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, Hkv, G, qc, dh), dtype=torch.float32,
                          device=q.device)
        for ci in range(n_kv):
            kc, vc = kf[:, ci], vf[:, ci]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, lo:lo + qc], kc) \
                * scale
            if causal:
                k_pos = ci * chunk + torch.arange(chunk, device=q.device)
                mask = q_pos[:, None] >= k_pos[None, :]     # (qc, chunk)
                s = torch.where(mask[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                        p, vc)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=3) if len(outs) > 1 else outs[0]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, dh).to(q.dtype)


def lse_weights(m: torch.Tensor, l: torch.Tensor, m_max: torch.Tensor
                ) -> torch.Tensor:
    """Each split's weight in a log-sum-exp merge, ``l exp(m - M)``, for
    splits' row statistics ``(m, l)`` and ``M`` their max over the splits:
    0 for an empty split (``m = -inf``, ``l = 0``), and no NaN where every
    split is empty (``M = -inf``)."""
    return l * torch.exp(m - torch.where(torch.isfinite(m_max), m_max, 0.0))


def merge_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor
                   ) -> torch.Tensor:
    """Attention outputs of splits of the keys merged into the output over
    all of them: ``o`` (n, ..., D) each split's normalised output, ``m``
    and ``l`` (n, ...) its row statistics (``ops.gqa_decode_partial``'s)
    -> (..., D) f32, ``sum_s w_s o_s / sum_s w_s`` with ``w_s = l_s exp(m_s
    - max_s m_s)``.  A row whose every split is empty gives 0.  The
    collective form over a model group is
    ``distributed.collectives.merge_partials``."""
    w = lse_weights(m, l, m.amax(dim=0))
    den = w.sum(dim=0)
    num = (w[..., None] * o.float()).sum(dim=0)
    return num / torch.where(den > 0, den, 1.0)[..., None]


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., d_in) @ w: (d_in, d_out), one product in x's type (bf16
    products accumulate in f32 on the card, as the JAX version asks)."""
    return torch.matmul(x, w)


# ----------------------------------------------------------- tensor parallel
class TensorParallel:
    """What a block needs of the mesh: the model group, whether the
    residual stream is sequence-sharded in this call, and the local head
    counts.  The port's counterpart of ``repro``'s ``shard_heads``: where
    ``repro`` constrains a layout and lets GSPMD insert the collectives,
    a block calls these helpers, each a collective with its gradient
    (``repro_torch.distributed.collectives``).

    A column-parallel product reads ``enter(h)`` (the stream all-gathered
    along T where it is sequence-sharded, else replicated) and a
    row-parallel one ends in ``exit(y)`` (reduce-scattered along T into
    the sequence-sharded stream, else all-reduced): the layer-boundary
    hook of ``repro``'s ``hidden_sharding``.  A replicated parameter used
    on this rank's share of the work goes through ``local`` (``rep`` for
    one used on the stream before ``enter``), which sums its gradient over
    the group.  ``TensorParallel()`` (no mesh) is the one-device block:
    every helper is the identity and no collective is called."""

    def __init__(self, group=None, size: int = 1, rank: int = 0,
                 seq: bool = False, attn_sharded: bool = True,
                 split: frozenset = frozenset()):
        self.group, self.size, self.rank = group, size, rank
        self.seq = seq
        #: heads split over the group; else attention runs replicated on
        #: gathered weights
        self.attn_sharded = attn_sharded
        #: the leaves (``embed``, ``mu``, whisper's ``pos_embed``) whose
        #: placement splits them over the group, read from the placement
        #: table (on a group of one too, so their collectives are called
        #: there as well)
        self.split = split

    def with_seq(self, seq: bool) -> "TensorParallel":
        return TensorParallel(self.group, self.size, self.rank,
                              seq and self.group is not None,
                              self.attn_sharded, self.split)

    @property
    def on(self) -> bool:
        return self.group is not None

    def heads(self, cfg) -> Tuple[int, int]:
        """(query heads, KV heads) this rank computes."""
        if self.on and self.attn_sharded:
            return cfg.n_heads // self.size, cfg.n_kv_heads // self.size
        return cfg.n_heads, cfg.n_kv_heads

    # the collectives, each the identity without a mesh
    def enter(self, h: torch.Tensor) -> torch.Tensor:
        from repro_torch.distributed import collectives as col
        if not self.on:
            return h
        if self.seq:
            return col.all_gather(h, 1, self.group)
        return col.copy(h, self.group)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        from repro_torch.distributed import collectives as col
        if not self.on:
            return y
        if self.seq:
            return col.reduce_scatter(y, 1, self.group)
        return col.all_reduce(y, self.group)

    def local(self, w: torch.Tensor) -> torch.Tensor:
        from repro_torch.distributed import collectives as col
        return col.copy(w, self.group) if self.on else w

    def rep(self, w: torch.Tensor) -> torch.Tensor:
        return self.local(w) if self.seq else w

    def norm(self, kind: str, x: torch.Tensor, params) -> torch.Tensor:
        """``apply_norm`` on the stream, its weights through ``rep``."""
        if not self.seq:
            return apply_norm(kind, x, params)
        if kind == "rmsnorm":
            return rmsnorm(x, self.rep(params["w"]))
        return layernorm(x, self.rep(params["w"]), self.rep(params["b"]))

    def to_replicated(self, x: torch.Tensor) -> torch.Tensor:
        """The stream in the replicated layout, for a block every rank
        computes whole."""
        from repro_torch.distributed import collectives as col
        if self.seq:
            return col.all_gather(x, 1, self.group, replicated=True)
        return x

    def from_replicated(self, y: torch.Tensor) -> torch.Tensor:
        from repro_torch.distributed import collectives as col
        return col.split(y, 1, self.group) if self.seq else y

    def full(self, w: torch.Tensor, dim: int, size: int) -> torch.Tensor:
        """A weight split over the group along ``dim``, gathered whole for
        a replicated computation; as it is where it is not split."""
        from repro_torch.distributed import collectives as col
        if not self.on or w.shape[dim] == size:
            return w
        return col.all_gather(w, dim, self.group, replicated=True,
                              contiguous=False)

    def whole(self, w: torch.Tensor, dim: int, size: int) -> torch.Tensor:
        """A weight gathered whole for this rank's share of the work (its
        block of a sequence split): each rank's gradient is a partial sum,
        so a split weight's gather reduce-scatters it back and a weight the
        group holds whole goes through ``local``.  ``full`` is for a
        computation every rank repeats."""
        from repro_torch.distributed import collectives as col
        if not self.on:
            return w
        if w.shape[dim] == size:
            return self.local(w)
        return col.all_gather(w, dim, self.group, contiguous=False)

    def seq_split(self, T: int) -> bool:
        """Whether attention over ``T`` positions splits its queries by
        sequence over the group: where the heads do not divide it and T
        does."""
        return self.on and not self.attn_sharded and T % self.size == 0


#: the one-device context
NO_TP = TensorParallel()


class Whole:
    """A ``ParamModule`` seen with its FSDP-split parameters whole over
    the data group: each parameter that ``place_model`` marked with an
    ``fsdp`` block (``sharding.DataBlock``) is all-gathered along that
    block's dim when a block reads it (``p["wq"]``, ``p.wq``,
    ``p["norm"].named_parameters()``), through the autograd gather whose
    backward reduce-scatters (sums) its gradient over the group; any other
    parameter is read as it is.  A view lives for one layer call, so each
    gather runs once a call (again in the remat recompute) and the whole
    tensor is dropped with the view."""

    def __init__(self, module: ParamModule):
        self._module = module
        self._cache: Dict[str, object] = {}

    def __getitem__(self, name: str):
        if name not in self._cache:
            v = getattr(self._module, name)
            if isinstance(v, ParamModule):
                v = Whole(v)
            elif getattr(v, "fsdp", None) is not None:
                from repro_torch.distributed import collectives as col
                v = col.all_gather(v, v.fsdp.dim, v.fsdp.group,
                                   contiguous=False)
            self._cache[name] = v
        return self._cache[name]

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self[name]
        except AttributeError:
            raise AttributeError(name) from None

    def named_parameters(self):
        for name, _ in self._module.named_parameters():
            node = self
            for part in name.split("."):
                node = node[part]
            yield name, node
