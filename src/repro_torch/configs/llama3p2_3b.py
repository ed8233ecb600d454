"""llama3.2-3b [dense]: small llama3 [hf:meta-llama].
28L d_model=3072 24H (kv=8) d_ff=8192 vocab=128256.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=128256, rope_theta=500_000.0, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256,
    vocab=512, dtype="float32")
