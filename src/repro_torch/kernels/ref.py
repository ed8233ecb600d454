"""Plain PyTorch versions of the kernels (the ``ref.py`` contract).

Each function is the semantic ground truth its kernel is held against: the
CPU tests compare them with the JAX package's oracles, and ``chip_smoke.py``
compares the CUDA kernel with them on the card.  Layouts at the public
functions are the JAX package's: NHWC activations, ``(R, S, C, M)`` conv
weights, ``(R, S, M)`` depthwise weights.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


# ----------------------------------------------------------------- rir_matmul
def rir_matmul(a: torch.Tensor, b: torch.Tensor,
               out_block_perm: Sequence[int], block_n: int,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GEMM whose output N-blocks are written in permuted order (RIR epilogue).

    out[:, perm[j]*bn : (perm[j]+1)*bn] = (a @ b)[:, j*bn : (j+1)*bn]

    ``residual`` (if given) is already stored in the *output* block order and
    is added after the store — the fused skip-connection add of the plan
    executor.
    """
    y = torch.matmul(a.float(), b.float()).to(a.dtype)
    n_blocks = y.shape[1] // block_n
    out = torch.zeros_like(y)
    for j in range(n_blocks):
        pj = int(out_block_perm[j])
        out[:, pj * block_n:(pj + 1) * block_n] = \
            y[:, j * block_n:(j + 1) * block_n]
    if residual is not None:
        out = out + residual.to(out.dtype)
    return out


# ----------------------------------------------------------- conv2d (+depthwise)
def _taps(x: torch.Tensor, r: int, s: int, P: int, Q: int,
          stride: int) -> torch.Tensor:
    return x[:, r:r + (P - 1) * stride + 1:stride,
             s:s + (Q - 1) * stride + 1:stride, :]


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Valid (no-padding) NHWC convolution.

    x: (N, H, W, C); w: (R, S, C, M).  Returns (N, P, Q, M) with
    P = (H - R)//stride + 1, Q = (W - S)//stride + 1 — the ``ConvWorkload``
    convention, where the workload's H/W already include any SAME padding.
    """
    N, H, W, C = x.shape
    R, S, _, M = w.shape
    P = (H - R) // stride + 1
    Q = (W - S) // stride + 1
    y = torch.zeros((N, P, Q, M), dtype=torch.float32, device=x.device)
    for r in range(R):
        for s in range(S):
            tap = _taps(x, r, s, P, Q, stride)
            y = y + torch.einsum("npqc,cm->npqm", tap.float(), w[r, s].float())
    return y.to(x.dtype)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor,
                     stride: int = 1) -> torch.Tensor:
    """Valid NHWC depthwise convolution.

    x: (N, H, W, M); w: (R, S, M) — one RxS filter per channel.
    """
    N, H, W, M = x.shape
    R, S, _ = w.shape
    P = (H - R) // stride + 1
    Q = (W - S) // stride + 1
    y = torch.zeros((N, P, Q, M), dtype=torch.float32, device=x.device)
    for r in range(R):
        for s in range(S):
            tap = _taps(x, r, s, P, Q, stride)
            y = y + tap.float() * w[r, s].float()
    return y.to(x.dtype)
