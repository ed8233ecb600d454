"""Public kernel entry points: dispatch by the tensor's device.

A CPU tensor runs the plain PyTorch version (``ref``); a CUDA tensor
launches the hand-written Hopper kernel, or raises.  There is no toggle and
no fallback: nothing routes a CUDA tensor around its kernel.

``birrd_reduce`` routes a grouped-reduction/reorder pattern through the
BIRRD switch model once per pattern and device (memoized), then pushes
``x`` through the routed switch program: on the CPU the plain switch walk
with the non-target ports zeroed, on the card one launch of the switch
kernel with the port mask in its store.  ``birrd_apply`` runs a config
program the same way; ``birrd_apply_p`` takes arbitrary stage matrices, as
the JAX API does, and runs the dense kernel.  The JAX wrappers'
``block_d`` grid hint and ``interpret`` flag have no counterpart: the
kernels take any ``d``.

``linear_scan`` is differentiable.  Its backward is not a kernel, because
the JAX package has none: ``repro``'s ``custom_vjp`` recomputes through
``ref.linear_scan_chunked`` in XLA, and the port recomputes through its own
``ref.linear_scan_chunked`` under autograd, on whichever device the
operands lie.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import torch

from . import ref
from .birrd_reduce import (_out_port_mask, _program_codes, _routed_program,
                           birrd_apply_cuda, birrd_switch_cuda)
from .gqa_decode import gqa_decode_cuda
from .linear_scan import linear_scan_cuda
from .rir_matmul import TILE_N, register_perm, rir_matmul_cuda

Perm = Union[Sequence[int], torch.Tensor, None]
#: the ``torch.profiler`` range around ``linear_scan``'s backward
BACKWARD_RANGE = "linear_scan.backward"


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


def birrd_apply_p(x: torch.Tensor, stage_mats: torch.Tensor) -> torch.Tensor:
    """Push ``x`` (aw, d) through a compiled BIRRD switch program
    ``stage_mats`` (S, aw, aw) f32 on x's device, any matrices (the dense
    kernel): ``(aw, d)`` in x's dtype."""
    if x.device.type == "cpu":
        return ref.birrd_apply(x, stage_mats)
    if x.device.type != "cuda":
        raise ValueError(f"birrd_apply runs on cpu or cuda, not {x.device}")
    return birrd_apply_cuda(x, stage_mats)


def birrd_apply(x: torch.Tensor, configs: Sequence[Sequence[int]]
                ) -> torch.Tensor:
    """Route ``x`` (aw, d) through BIRRD configured by ``configs`` (one
    row of Egg configs a stage): the switch kernel on the card, its codes
    uploaded once per program and device."""
    cfg = tuple(tuple(int(c) for c in row) for row in configs)
    if x.device.type == "cpu":
        return ref.birrd_switch(x, cfg)
    if x.device.type != "cuda":
        raise ValueError(f"birrd_apply runs on cpu or cuda, not {x.device}")
    return birrd_switch_cuda(x, _program_codes(x.shape[0], cfg, x.device))


def birrd_reduce(x: torch.Tensor, group_ids: Sequence[int],
                 out_ports: Sequence[int]) -> torch.Tensor:
    """Route + execute: grouped reduction with arbitrary output reorder.

    x: (aw, d).  Returns (aw, d) with group sums at their target ports and
    zeros elsewhere (junk/bubble ports are masked, as the output buffer's
    write-enable does in hardware).
    """
    aw = x.shape[0]
    ports = tuple(int(p) for p in out_ports)
    cfg, codes = _routed_program(aw, tuple(int(g) for g in group_ids), ports,
                                 x.device)
    mask = _out_port_mask(aw, ports, x.device)
    if x.device.type == "cpu":
        return ref.birrd_switch(x, cfg, mask)
    if x.device.type != "cuda":
        raise ValueError(f"birrd_reduce runs on cpu or cuda, not {x.device}")
    return birrd_switch_cuda(x, codes, port_mask=mask)


def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """Single-token GQA decode attention: ``(B, Hq, D)`` in q's dtype.

    q (B, Hq, D); k/v (B, S, Hkv, D); lengths (B,) valid KV length, on q's
    device.  Any S runs the kernel: it masks a ragged last tile itself, so
    the JAX wrapper's route to the plain version for an S its block does
    not tile has no counterpart, and neither has its ``block_s`` hint.
    """
    if q.device.type == "cpu":
        return ref.gqa_decode(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"gqa_decode runs on cpu or cuda, not {q.device}")
    return gqa_decode_cuda(q, k, v, lengths.to(torch.int32))


class _LinearScan(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain chunked version) forward; a
    backward through the plain chunked version, recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, log_decay):
        ctx.save_for_backward(q, k, v, log_decay)
        if q.device.type == "cpu":
            return ref.linear_scan_chunked(q, k, v, log_decay)
        if q.device.type != "cuda":
            raise ValueError(f"linear_scan runs on cpu or cuda, not "
                             f"{q.device}")
        return linear_scan_cuda(q, k, v, log_decay)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        # a profiler label (BACKWARD_RANGE), so that a profiled train step
        # can tell this plain backward's device time from the rest
        with torch.profiler.record_function(BACKWARD_RANGE), \
                torch.enable_grad():
            out = ref.linear_scan_chunked(*ins)
            return torch.autograd.grad(out, ins, g)


def linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor) -> torch.Tensor:
    """Chunked gated linear attention: ``(B, H, T, dv)`` in v's dtype.

    q/k (B, H, T, dk), v (B, H, T, dv), log_decay (B, H, T, dk) <= 0 (f32
    on the card), all on one device.  Any T runs the kernel: it masks a
    ragged last chunk itself, so the JAX kernel's ``T % 64`` assert, its
    ``chunk=`` argument (ignored on its kernel path) and the
    ``use_kernels``/``REPRO_SCAN_CHUNK`` switches have no counterpart.
    """
    return _LinearScan.apply(q, k, v, log_decay)


__all__ = ["rir_matmul", "device_perm", "birrd_apply", "birrd_apply_p",
           "birrd_reduce", "gqa_decode", "linear_scan", "TILE_N"]
