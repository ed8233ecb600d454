"""whisper-small [audio]: enc-dec, conv frontend STUB [arXiv:2212.04356].
12L (x2) d_model=768 12H d_ff=3072 vocab=51865.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, act="gelu", norm="layernorm",
    tie_embeddings=True, frontend_stub=True, enc_frames=1500,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, enc_frames=32, dtype="float32")
