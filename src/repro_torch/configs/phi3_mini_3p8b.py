"""phi3-mini-3.8b [dense]: RoPE SwiGLU MHA [arXiv:2404.14219].
32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=192,
    vocab=512, dtype="float32")
