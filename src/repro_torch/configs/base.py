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
    def n_params(self) -> float:
        """Total parameter count (approximate analytical)."""
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
