"""granite-4.0-h-small [hybrid_moe]: Granite 4.0-H Small, 32B-A9B
[hf:ibm-granite/granite-4.0-h-small, config.json].  40L d_model=4096
vocab=100352 (tied).  Layers 5, 15, 25 and 35 are GQA attention with NoPE
(32 query and 8 KV heads of 128, scores x 1/128), the other 36 Mamba2 (128
heads of 64, d_state 128, one group, d_conv 4, d_inner 8192); every layer
is followed by an MoE block of 72 SwiGLU experts of 768, top-10 (softmax
over the top-10 logits), dropless, plus one shared SwiGLU expert of 1536.
Embedding x 12, each residual branch x 0.22, logits / 16.

Not one of ``ARCH_IDS``: the JAX package has no such model, so the JAX
parity tests do not take it.  It trains only (no prefill or decode).
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-4.0-h-small", family="hybrid_moe",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=768, vocab=100352, tie_embeddings=True,
    n_experts=72, top_k=10, shared_expert=True, d_ff_shared=1536,
    ssm_state=128, ssm_heads=128, d_inner=8192, conv_width=4,
    attn_period=10, attn_offset=5,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    attention_multiplier=0.0078125, logits_scaling=16.0, nope=True,
    supports_decode=False,
)

#: a whole period of the pattern at a period of 4 (attention at layer 1),
#: 3 of the router's 8 experts held (from expert 2), f32
SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=32, d_ff_shared=48, vocab=256, n_experts=8, top_k=3,
    experts_held=3, expert_first=2, ssm_state=32, ssm_heads=4, d_inner=128,
    attn_period=4, attn_offset=1, dtype="float32")
