"""minicpm-2b [dense]: llama-like, trained with WSD schedule
[arXiv:2404.06395; hf].  40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=72, n_heads=6, n_kv_heads=6, d_ff=160,
    vocab=512, dtype="float32")
