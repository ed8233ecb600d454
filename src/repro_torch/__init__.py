"""repro_torch — the FEATHER planning/RIR-execution/serving stack on PyTorch.

A second backend beside the JAX package ``repro``: the same planner (its
numpy modules are kept as copies here, so plans are byte-identical), an
executor that runs every layer through a hand-written CUDA ``rir_matmul``
kernel on an NVIDIA Hopper card, and the continuous-batching serve engine.
Application code imports ``repro_torch.api``.
"""
__all__: list = []
