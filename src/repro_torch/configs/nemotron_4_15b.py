"""nemotron-4-15b [dense]: GQA + squared-ReLU MLP [arXiv:2402.16819].
32L d_model=6144 48H (kv=8) d_ff=24576 vocab=256000.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab=256000, act="relu2", norm="layernorm",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256,
    vocab=512, dtype="float32")
