"""Hand-written Hopper kernels and their plain PyTorch versions.

``ops`` is the dispatch surface: a CPU tensor runs the plain version in
``ref``, a CUDA tensor launches the kernel (``rir_matmul``, ``gqa_decode``,
``linear_scan``, ``birrd_apply``; each built from ``csrc/`` by ``build``
with ``nvcc`` at first CUDA use) or raises.
"""
__all__: list = []
