"""rwkv6-1.6b [ssm]: Finch, data-dependent per-channel decay
[arXiv:2404.05892].  24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536,
    d_inner=2048, ssm_heads=32,
    supports_long=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
    vocab=512, d_inner=64, ssm_heads=2, dtype="float32")
