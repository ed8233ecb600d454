"""llama4-scout-17b-a16e [moe]: 16 experts top-1 + shared expert, early
fusion (stub) [hf:meta-llama/Llama-4-Scout-17B-16E].
48L d_model=5120 40H (kv=8) d_ff=8192 vocab=202048.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    n_experts=16, top_k=1, shared_expert=True, frontend_stub=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, n_experts=4, top_k=1, dtype="float32")
