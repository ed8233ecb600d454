"""The train step (the one-device part of ``repro.distributed``).

The mesh, the sharding rules and the per-layer layout hooks come with
ROADMAP Queue 1 item 10 (distribution).
"""
from .stepfn import make_train_step

__all__ = ["make_train_step"]
