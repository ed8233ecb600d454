"""chameleon-34b [vlm]: early-fusion VQ image tokens (stub frontend)
[arXiv:2405.09818].  48L d_model=8192 64H (kv=8) d_ff=22016 vocab=65536.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536, frontend_stub=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=320,
    vocab=512, dtype="float32")
