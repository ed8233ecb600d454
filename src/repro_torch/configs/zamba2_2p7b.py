"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf].  54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  Shared attention block every 6 backbone layers (Zamba2 design).
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    ssm_state=64, d_inner=5120, ssm_heads=80, conv_width=4,
    shared_attn_every=6,
    supports_long=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, d_inner=128, ssm_heads=2, ssm_state=16, shared_attn_every=2,
    dtype="float32")
