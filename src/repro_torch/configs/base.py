"""Architecture config schema for the assigned model zoo."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    act: str = "swiglu"         # swiglu | relu2 | gelu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # SSM (mamba2 / rwkv6)
    ssm_state: int = 0
    ssm_heads: int = 0
    d_inner: int = 0
    conv_width: int = 4
    # hybrid (zamba2): shared attention block every N backbone blocks
    shared_attn_every: int = 0
    # hybrid_moe (granite-4.0-h): attention at the layers i with i % period
    # == offset, Mamba2 at the rest, every layer followed by an MoE block
    attn_period: int = 0
    attn_offset: int = 0
    # MoE: the shared expert's width (0: d_ff); the experts this device
    # holds under expert parallelism, experts_held of them from
    # expert_first (0: all n_experts; the router routes over all of them)
    d_ff_shared: int = 0
    experts_held: int = 0
    expert_first: int = 0
    # granite's multipliers: the embedding's rows, each residual branch,
    # the attention scores in training (None: 1/sqrt(head_dim)) and the
    # logits divided by logits_scaling; NoPE: attention without RoPE
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    logits_scaling: float = 1.0
    nope: bool = False
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_frames: int = 1500      # stub audio frontend: precomputed frames
    # modality stub: inputs are precomputed embeddings, not token ids
    frontend_stub: bool = False
    dtype: str = "bfloat16"
    # which compute shapes this arch supports
    supports_decode: bool = True
    supports_long: bool = False  # sub-quadratic: ssm/hybrid only

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def held(self) -> int:
        """Experts this device holds (``experts_held``, else all)."""
        return self.experts_held or self.n_experts

    def is_attention(self, i: int) -> bool:
        """Whether layer ``i`` of a hybrid_moe stack is attention."""
        return bool(self.attn_period) and \
            i % self.attn_period == self.attn_offset

    def _hybrid_moe_params(self, active: bool) -> float:
        """hybrid_moe's count, norms included: the Mamba2 or attention
        mixer by layer, every layer's MoE block (the router over all
        experts; the held experts, or the top_k a token runs where
        ``active``; the shared expert), the tied embedding."""
        D, V = self.d_model, self.vocab
        dh, H, Hkv = self.head_dim, self.n_heads, self.n_kv_heads
        di, st, hd = self.d_inner, self.ssm_state, self.ssm_heads
        attn = D + D * dh * (H + 2 * Hkv) + H * dh * D
        mamba = D + D * (2 * di + 2 * st + hd) \
            + (self.conv_width + 1) * (di + 2 * st) + 3 * hd + di + di * D
        experts = self.top_k if active else self.held
        moe = D + D * self.n_experts + experts * 3 * D * self.d_ff \
            + 3 * D * (self.d_ff_shared or self.d_ff)
        mixers = sum(attn if self.is_attention(i) else mamba
                     for i in range(self.n_layers))
        return mixers + self.n_layers * moe + V * D + D

    @property
    def n_params(self) -> float:
        """Total parameter count (approximate analytical; a hybrid_moe
        stack's exact, of the experts held)."""
        if self.family == "hybrid_moe":
            return self._hybrid_moe_params(active=False)
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        dh, H, Hkv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = D * dh * (H + 2 * Hkv) + H * dh * D
        if self.act == "swiglu":
            mlp_dense = 3 * D * F
        else:
            mlp_dense = 2 * D * F
        if self.family == "moe":
            mlp = self.n_experts * mlp_dense + D * self.n_experts
            if self.shared_expert:
                mlp += mlp_dense
        else:
            mlp = mlp_dense
        if self.family in ("ssm",):
            # rwkv6: r,k,v,g projections + wo + decay lora + channel-mix mlp
            di = self.d_inner or 2 * D
            per_layer = 5 * D * di + D * 64 + 64 * di + mlp_dense
        elif self.family == "hybrid":
            di = self.d_inner or 2 * D
            st, hd = (self.ssm_state or 64), (self.ssm_heads or di // 64)
            ssm_layer = D * (2 * di + 2 * st + hd) + di * D \
                + self.conv_width * (di + 2 * st)
            per_layer = ssm_layer
            # one shared attn+mlp block with the 2D->D concat projection
            shared = attn + mlp_dense + 2 * D * D
            return L * per_layer + shared + 2 * V * D
        else:
            per_layer = attn + mlp
        embed = V * D * (1 if self.tie_embeddings else 2)
        enc = self.enc_layers * (attn + mlp_dense)
        return L * per_layer + embed + enc

    @property
    def n_params_active(self) -> float:
        """Active params per token (= total for dense; top-k experts for MoE)."""
        if self.family == "hybrid_moe":
            return self._hybrid_moe_params(active=True)
        if self.family != "moe":
            return self.n_params
        D, F, L = self.d_model, self.d_ff, self.n_layers
        dh, H, Hkv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = D * dh * (H + 2 * Hkv) + H * dh * D
        mlp_dense = 3 * D * F if self.act == "swiglu" else 2 * D * F
        active_mlp = self.top_k * mlp_dense + (mlp_dense if self.shared_expert
                                               else 0) + D * self.n_experts
        embed = self.vocab * D * (1 if self.tie_embeddings else 2)
        return L * (attn + active_mlp) + embed


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
