"""Public kernel entry points: dispatch by the tensor's device.

A CPU tensor runs the plain PyTorch version (``ref``); a CUDA tensor
launches the hand-written Hopper kernel, or raises.  There is no toggle and
no fallback: nothing routes a CUDA tensor around its kernel.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from . import ref
from .rir_matmul import TILE_N, register_perm, rir_matmul_cuda

Perm = Union[Sequence[int], torch.Tensor, None]


def _check_perm(perm: Tuple[int, ...], n_blocks: int) -> Tuple[int, ...]:
    if sorted(perm) != list(range(n_blocks)):
        raise ValueError(f"{perm} is not a permutation of {n_blocks} blocks")
    return perm


@functools.lru_cache(maxsize=4096)
def _device_perm(perm: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return register_perm(torch.tensor(perm, dtype=torch.int32, device=device))


def device_perm(perm: Sequence[int], device: torch.device | str
                ) -> torch.Tensor:
    """The int32 device tensor the kernel reads ``perm`` from (memoized, so
    the host-to-device copy happens once per (perm, device)).  Its values
    are checked here, so it is the only perm tensor the kernel accepts."""
    p = tuple(int(x) for x in perm)
    return _device_perm(_check_perm(p, len(p)), torch.device(device))


def rir_matmul(a: torch.Tensor, b: torch.Tensor, out_block_perm: Perm = None,
               *, residual: Optional[torch.Tensor] = None,
               block_n: int = 128) -> torch.Tensor:
    """``a @ b`` with output N-block ``j`` stored at block slot ``perm[j]``.

    ``out_block_perm``: a sequence, a ``device_perm`` tensor on ``a``'s
    device (as the executor passes it), or None for the identity.
    ``residual`` (M, N) is stored in the output block order and added in the
    epilogue.  N must be a multiple of ``block_n``.  The JAX signature's
    ``block_m``/``block_k`` grid hints have no counterpart: the CUDA kernel
    tiles M and K on its own, so that its summation order depends on neither.
    """
    N = b.shape[1]
    if N % block_n:
        raise ValueError(f"N={N} is not a multiple of block_n={block_n}")
    n_blocks = N // block_n
    if a.device.type == "cpu":
        if out_block_perm is None:
            perm = tuple(range(n_blocks))
        else:
            perm = tuple(int(p) for p in (
                out_block_perm.tolist() if torch.is_tensor(out_block_perm)
                else out_block_perm))
        return ref.rir_matmul(a, b, _check_perm(perm, n_blocks), block_n,
                              residual=residual)
    if a.device.type != "cuda":
        raise ValueError(f"rir_matmul runs on cpu or cuda, not {a.device}")
    if out_block_perm is None:
        perm_t = device_perm(range(n_blocks), a.device)
    elif torch.is_tensor(out_block_perm):
        perm_t = out_block_perm
    else:
        perm_t = device_perm(out_block_perm, a.device)
    return rir_matmul_cuda(a, b, perm_t, residual=residual, block_n=block_n)


__all__ = ["rir_matmul", "device_perm", "TILE_N"]
